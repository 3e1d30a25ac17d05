"""Distributed step builders: the FibecFed train step, prefill, decode (port
of ``repro.launch.steps``).

The train step is Alg. 1's tuning phase as one SPMD program:

- ``state["gal_lora"]``: replicated over the client axes; its gradient mean
  over clients is the only cross-client all-reduce of the step (the paper's
  server aggregation of the GAL layers).
- ``state["local_lora"]``: a leading client-group axis, sharded over
  ``("pod", "data")``; its gradients stay client-local.
- ``state["gal_mask"]`` / ``state["local_mask"]``: FibecFed's layer and
  neuron masks, applied inside the optimizer update, the masked AdamW
  kernel (B1, ``kernels.ops.masked_adamw_update``), once for the GAL tree
  and once for the local tree. Frozen entries keep p, m and v bit for bit.

The batch (B, ...) is split into (n_groups, B / n_groups, ...) and each
client group trains on its own rows with its own local LoRA, under
``torch.func.vmap``.

On a mesh the params, state and batch are DTensors placed by
:mod:`repro_torch.launch.shardings`. The step takes the client (data) axes
itself: each rank runs its own client groups on its local rows, the GAL
gradient is summed over the client axes (one all-reduce), and B1 updates
each rank's local shards (p, g, m, v and the mask share placements). The
``"model"`` axis, where it has more than one rank, stays with DTensor:
the forward runs on DTensors of that sub-mesh, one client group after
another, and each gradient's pending sums are reduced before the update.
Every family takes it: the models run their attentions, the Mamba2
mixer's scan and the routed experts on each rank's heads or experts
(:mod:`repro_torch.models.sharding_ctx`).
Without a mesh (plain tensors) it is the one-rank program.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.kernels import ops as kops
from repro_torch.models.model_api import ModelFns
from repro_torch.train.losses import make_logits_loss
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

def make_train_state(model: ModelFns, generator: torch.Generator, n_groups: int, device=None):
    """The FibecFed distributed train state, its LoRA drawn from
    ``generator`` (on ``device``): a GAL tree, ``n_groups`` copies of it as
    the local tree, zero moments, a GAL mask of ones (all layers global),
    a local mask of zeros and an int32 step counter."""
    gal_lora = model.init_lora(generator, device)
    local_lora = tree_map(lambda x: x[None].expand(n_groups, *x.shape).clone(), gal_lora)
    zeros = lambda t: tree_map(torch.zeros_like, t)  # noqa: E731
    ones = lambda t: tree_map(lambda x: torch.ones_like(x, dtype=torch.float32), t)  # noqa: E731
    return {
        "gal_lora": gal_lora,
        "local_lora": local_lora,
        "gal_m": zeros(gal_lora),
        "gal_v": zeros(gal_lora),
        "local_m": zeros(local_lora),
        "local_v": zeros(local_lora),
        "gal_mask": ones(gal_lora),  # 0/1 per Alg. 1's init phase; ones = all GAL
        "local_mask": zeros(local_lora),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(gal_lora)[0].device),
    }


def _merge_lora(gal, local_c, mask):
    return tree_map(lambda g, l, m: (m * g + (1.0 - m) * l).to(g.dtype), gal, local_c, mask)


def _local_mask(gal_mask, local_mask):
    return tree_map(lambda m, nm: (1.0 - m)[None] * nm if nm.dim() == m.dim() + 1 else (1.0 - m) * nm,
                    gal_mask, local_mask)


def masked_adamw(params, grads, m, v, t, mask, lr):
    """One masked AdamW step over a tree, no weight decay, the bias scales
    from the step counter ``t``: B1 on the card, its plain version on the
    CPU. Returns ``(params, m, v, t + 1)``."""
    mask = tree_map(lambda mk, p: mk.to(torch.float32).expand(p.shape).contiguous()
                    if mk.shape != p.shape else mk.to(torch.float32), mask, params)
    new_p, st = kops.masked_adamw_update(grads, {"m": m, "v": v, "t": t}, params, lr, mask)
    return new_p, st["m"], st["v"], st["t"]


def _replicated(x):
    """A DTensor with every pending sum or shard gathered; a tensor as it is."""
    from repro_torch.models.sharding_ctx import _is_dtensor

    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _client_loss_fn(model: ModelFns):
    logits_loss = make_logits_loss(model.cfg)

    def loss_of(params, lora, batch):
        logits, aux = model.forward(params, lora, batch)
        # a vocab-sharded head's logits are gathered before the CE
        return logits_loss(_replicated(logits), batch) + _replicated(aux)

    return loss_of


class _Layout:
    """How a mesh's dims split between the client axes, which the step
    takes itself, and the tensor-parallel rest, which stays with DTensor."""

    def __init__(self, like_local):
        from torch.distributed.tensor import Shard

        self.mesh = like_local.device_mesh
        names = self.mesh.mesh_dim_names
        self.dp = [i for i, p in enumerate(like_local.placements) if p == Shard(0)]
        self.dp_size = 1
        for i in self.dp:
            self.dp_size *= self.mesh.size(i)
        self.tp = [i for i in range(self.mesh.ndim) if i not in self.dp and self.mesh.size(i) > 1]
        self.sub = self.mesh[tuple(names[i] for i in self.tp)] if self.tp else None

    def local(self, x):
        """The rank's block over the client axes: a DTensor on the
        tensor-parallel sub-mesh, or a plain tensor where there is none."""
        loc = x.to_local()
        if self.sub is None:
            return loc
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(loc, self.sub, [x.placements[i] for i in self.tp], run_check=False)

    def shared(self, x):
        """A tree shared by the client groups (params, the GAL tree) as
        :meth:`local` gives it, gathered first over any client axis that
        shards it."""
        from torch.distributed.tensor import Replicate

        pl = [Replicate() if i in self.dp else p for i, p in enumerate(x.placements)]
        return self.local(x if list(x.placements) == pl else x.redistribute(self.mesh, pl))

    def rows(self, x):
        """A batch leaf's rows of the rank's client groups (plain)."""
        from torch.distributed.tensor import Replicate, Shard

        want = [Shard(0) if i in self.dp else Replicate() for i in range(self.mesh.ndim)]
        return x.redistribute(self.mesh, want).to_local()

    def client_sum(self, y_local, like):
        """The sum over the client axes of each rank's block ``y_local`` (a
        leaf of ``like``'s placements on the other dims): one all-reduce."""
        from torch.distributed.tensor import DTensor, Partial

        pl = [Partial() if i in self.dp else like.placements[i] for i in range(self.mesh.ndim)]
        out = DTensor.from_local(y_local, self.mesh, pl, run_check=False, shape=like.shape, stride=like.stride())
        return out.redistribute(self.mesh, like.placements).to_local()


def _split(n: int):
    return lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _group_grads(loss_of, params, gal, local, batch_g, gal_mask, n_groups: int, looped: bool):
    """``(loss, g_gal, g_local)`` of the sum of the client groups' losses
    over ``n_groups``, for the groups ``local`` and ``batch_g`` hold."""
    def client_loss(gal_lora, local_c, batch_c):
        return loss_of(params, _merge_lora(gal_lora, local_c, gal_mask), batch_c)

    if not looped:
        def mean_loss(gal_lora, local_lora):
            return torch.sum(vmap(client_loss, in_dims=(None, 0, 0))(gal_lora, local_lora, batch_g)) / n_groups

        (g_gal, g_local), loss = grad_and_value(mean_loss, argnums=(0, 1))(gal, local)
        return loss, g_gal, g_local
    # tensor parallel: DTensor leaves, one client group after another
    from torch.distributed.tensor.experimental import implicit_replication

    gal = tree_map(lambda x: x.detach().requires_grad_(True), gal)
    local = tree_map(lambda x: x.detach().requires_grad_(True), local)
    n_local = tree_leaves(local)[0].shape[0]
    with implicit_replication():
        total = 0.0
        for c in range(n_local):
            total = total + client_loss(gal, tree_map(lambda x: x[c], local), tree_map(lambda x: x[c], batch_g))
        loss = total / n_groups
        grads = torch.autograd.grad(loss, tree_leaves(gal) + tree_leaves(local))
    n = len(tree_leaves(gal))
    return _replicated(loss).to_local().detach(), tree_unflatten(gal, grads[:n]), tree_unflatten(local, grads[n:])


def _build_train_step(model: ModelFns, n_groups: int, learning_rate: float, update: Callable) -> Callable:
    loss_of = _client_loss_fn(model)

    def apply_updates(state, g_gal, g_local, loss):
        local_mask = _local_mask(state["gal_mask"], state["local_mask"])
        new_gal, gal_m, gal_v, t = update(state["gal_lora"], g_gal, state["gal_m"], state["gal_v"],
                                          state["step"], state["gal_mask"], learning_rate)
        new_local, local_m, local_v, _ = update(state["local_lora"], g_local, state["local_m"], state["local_v"],
                                                state["step"], local_mask, learning_rate)
        new_state = {"gal_lora": new_gal, "local_lora": new_local, "gal_m": gal_m, "gal_v": gal_v,
                     "local_m": local_m, "local_v": local_v, "gal_mask": state["gal_mask"],
                     "local_mask": state["local_mask"], "step": t}
        return new_state, {"loss": loss}

    def train_step(params, state, batch):
        rows = tree_leaves(batch)[0].shape[0]
        if rows % n_groups:
            raise ValueError(f"a batch of {rows} rows does not split into {n_groups} client groups")
        first = tree_leaves(state["local_lora"])[0]
        if type(first) is torch.Tensor:
            batch_g = tree_map(_split(n_groups), batch)
            loss, g_gal, g_local = _group_grads(loss_of, params, state["gal_lora"], state["local_lora"], batch_g,
                                                state["gal_mask"], n_groups, looped=False)
            return apply_updates(state, g_gal, g_local, loss.detach())
        return _mesh_train_step(params, state, batch, _Layout(first))

    def _mesh_train_step(params, state, batch, lay: _Layout):
        n_local = n_groups // lay.dp_size
        loc = {k: tree_map(lay.local if k.startswith("local") else lay.shared, v) for k, v in state.items()}
        batch_g = tree_map(lambda x: _split(n_local)(lay.rows(x)), batch)
        loss, g_gal, g_local = _group_grads(loss_of, tree_map(lay.shared, params), loc["gal_lora"],
                                            loc["local_lora"], batch_g, loc["gal_mask"], n_groups,
                                            looped=lay.sub is not None)
        # the server aggregation: the GAL gradient summed over the clients
        g_gal = tree_map(lambda g, like: lay.client_sum(_block(g, like, lay), like), g_gal, state["gal_lora"])
        g_local = tree_map(lambda g, like: _block(g, like, lay), g_local, state["local_lora"])
        loss = lay.client_sum(loss.reshape(()), state["step"]) if lay.dp else loss  # a replicated scalar
        # B1 on each rank's shards: p, g, m, v and the mask share placements
        shards = {k: tree_map(lambda x: x.to_local(), v) for k, v in state.items()}
        new_state, metrics = apply_updates(shards, g_gal, g_local, loss)
        return {k: tree_map(_wrap, new_state[k], state[k]) for k in new_state}, metrics

    return train_step


def _block(g, like, lay: _Layout):
    """A gradient on the sub-mesh (or plain) as the rank's plain block of a
    leaf placed as ``like``: its pending sums over the model axis reduced
    first."""
    if lay.sub is None:
        return g
    return g.redistribute(lay.sub, [like.placements[i] for i in lay.tp]).to_local()


def _wrap(y, like):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y, like.device_mesh, like.placements, run_check=False, shape=like.shape,
                              stride=like.stride())


def build_train_step(model: ModelFns, n_groups: int, *, learning_rate: float = 1e-4) -> Callable:
    """Returns ``train_step(params, state, batch) -> (state, metrics)``."""
    return _build_train_step(model, n_groups, learning_rate, masked_adamw)


def _serve_inputs(params, lora, batch_like):
    """Plain inputs as they are; on a mesh, each tree as the rank's block
    (batch rows of its client groups, DTensors on the tensor-parallel
    sub-mesh) and the context the forward runs in."""
    first = tree_leaves(batch_like)[0]
    if type(first) is torch.Tensor:
        return None, params, lora, contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    lay = _Layout(first)
    return lay, tree_map(lay.shared, params), tree_map(lay.shared, lora), implicit_replication()


def build_prefill_step(model: ModelFns, cache_len: int) -> Callable:
    """``prefill_step(params, lora, batch) -> (last logits, cache)``; on a
    mesh each rank returns its client groups' rows."""
    def prefill_step(params, lora, batch):
        lay, params, lora, ctx = _serve_inputs(params, lora, batch)
        if lay is not None:
            batch = tree_map(lay.rows, batch)
        with ctx:
            logits, cache, _ = model.prefill(params, lora, batch, cache_len)
        return logits, cache

    return prefill_step


def build_decode_step(model: ModelFns) -> Callable:
    """``decode_step(params, lora, token, cache, position) -> (logits,
    cache)``; on a mesh each rank decodes its client groups' rows against
    its block of the cache: the cache placed on the whole mesh, or the
    block a prefill or decode step returned."""
    def decode_step(params, lora, token, cache, position):
        lay, params, lora, ctx = _serve_inputs(params, lora, token)
        if lay is not None:
            token = lay.rows(token)
            cache = tree_map(lambda c: lay.local(c) if type(c) is not torch.Tensor and c.device_mesh == lay.mesh
                             else c, cache)
        with ctx:
            return model.decode_step(params, lora, token, cache, position)

    return decode_step
