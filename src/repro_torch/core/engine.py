"""Vectorized and sharded federated round engines (port of
``repro.core.engine``).

The loop engine (``FibecFed(engine="loop")``) trains one (client, batch)
step at a time and aggregates on the host. This engine runs the round over
the whole cohort at once:

  gather the chosen clients' rows of the stacked client state
    -> merge the global GAL params into each client's LoRA (Alg. 1 line 15)
    -> for each padded curriculum step: per-client gradients under
       ``torch.func.vmap`` over clients, then one masked SGD/AdamW update of
       the stacked trees (lines 16-17)
    -> the weighted GAL FedAvg over the client axis (line 18)
    -> scatter the updated client state back into the stack

Client trees (LoRA, optimizer state, neuron masks) are stacked along a
leading client axis; client data lives on one padded ``(C, NB, B, ...)``
grid (:func:`repro_torch.data.pipeline.stack_clients`) with validity masks,
so padded samples and padded steps are exact no-ops. The optimizer runs
outside the vmap because ``vmap`` cannot see into the hand-written kernels:
each update launches once per step for the whole tree and all k clients,
with each client's scalars (:mod:`repro_torch.kernels.ops`). JAX's ``jit`` with
buffer donation becomes plain functions that write the stacked tensors in
place.

The initialization phase gets the same treatment: difficulty scoring is a
vmap over clients of a loop over batches, and the momentum-FIM warmup a
loop over warmup epochs of a vmap over clients.

The sharded engine (``engine="sharded"``) is this round over a client mesh
(:mod:`repro_torch.launch.mesh`) in multi-controller SPMD: every rank runs
the same runner on its own card and holds its block of the stacked client
trees; each round the cohort's rows reach their training rank by one
collective, the single-device body trains them, and the weighted FedAvg's
partial sums meet in one all-reduce, the paper's server aggregation as a
collective (:func:`build_sharded_round_fn`). The JAX package's single
controller over many devices becomes one process a rank; the numbers line
up with its layout.

The loop and async engines take one client's local round
(:func:`build_client_train_fn`), the async engine also the standalone
merges (:func:`gal_weighted_merge`, :func:`gal_delta_merge`,
:func:`lora_delta`). None of them writes its inputs: a global version a
straggler pulled must survive later merges unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad_and_value, vmap

from repro_torch.core import fisher as fish
from repro_torch.kernels import ops as _kops
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _gather(tree, idx):
    return tree_map(lambda x: x[idx], tree)


def _scatter_(tree, idx, values) -> None:
    """Write ``values`` into rows ``idx`` of the stacked ``tree``, in place
    (the indices are distinct: a cohort has no repeats)."""
    tree_map(lambda s, c: s.index_copy_(0, idx, c.to(s.dtype)), tree, values)


def make_client_step(loss_fn: Callable, opt_update: Callable) -> Callable:
    """One masked local SGD/AdamW step of k stacked clients (Alg. 1 lines
    16-17).

    ``step(params, lora, opt, mask, batch, sample_valid, lr, active) ->
    (loss (k,), new_lora, new_opt)``: every tree and batch leaf carries the
    client axis first, ``active`` (k,) is the padded-step predicate. The
    gradients of ``loss_fn.masked`` are taken per client under ``vmap``; the
    update then commits per entry (``eff = mask ⊙ active``), so an inactive
    client keeps its LoRA, moments and Adam step counter bit for bit.
    """
    masked = loss_fn.masked

    def step(params, lora, opt, mask, batch, sample_valid, lr, active):
        grads, loss = vmap(grad_and_value(lambda lo, b, sv: masked(params, lo, b, sv)))(
            lora, batch, sample_valid
        )
        new_lora, new_opt = opt_update(grads, opt, lora, lr, mask, active)
        return loss.detach(), new_lora, new_opt

    return step


def _weighted_sum(stacked, weights, reduce):
    agg = tree_map(lambda x: torch.tensordot(weights, x.to(torch.float32), dims=1), stacked)
    return agg if reduce is None else reduce(agg)


def gal_weighted_merge(global_lora, gal_mask, stacked_client_lora, weights, reduce=None):
    """Weighted FedAvg over the GAL part only (Alg. 1 line 18). ``weights``
    (k,) f32 are normalized; the contraction over the client axis is the
    server aggregation. ``reduce`` (the sharded engine's all-reduce) sums
    the partial contractions of the ranks' clients before the blend."""
    agg = _weighted_sum(stacked_client_lora, weights, reduce)
    # the float mask/weight arithmetic must not widen bf16 leaves
    return tree_map(lambda g, m, a: (m * a + (1.0 - m) * g).to(g.dtype), global_lora, gal_mask, agg)


def gal_delta_merge(global_lora, gal_mask, stacked_deltas, weights, reduce=None):
    """Delta application over the GAL part: ``global += Σ_i w_i · delta_i``
    on GAL layers, identity elsewhere. With normalized weights and lossless
    deltas it equals :func:`gal_weighted_merge`; ``reduce`` as there."""
    agg = _weighted_sum(stacked_deltas, weights, reduce)
    return tree_map(lambda g, m, d: (g + m * d).to(g.dtype), global_lora, gal_mask, agg)


def lora_delta(new_lora, pulled_lora):
    """Client-side delta for the delta merge mode: the trained LoRA minus
    the global version the client pulled, taken at completion time while
    the pulled version is still alive (only the GAL part matters
    downstream: the merge masks the rest away). New tensors: neither
    argument is written."""
    return tree_map(lambda n, p: n - p, new_lora, pulled_lora)


def merge_in(global_lora, lora, gal_mask):
    """Line 15: the global copy overwrites the GAL part of a client's LoRA
    (the mask leaves broadcast over a leading client axis). New tensors,
    each in its LoRA leaf's dtype: the float blend must not widen bf16
    leaves."""
    return tree_map(lambda g, l, m: (m * g + (1.0 - m) * l).to(l.dtype), global_lora, lora, gal_mask)


def build_client_train_fn(loss_fn: Callable, opt_update: Callable) -> Callable:
    """One client's whole local round, for the loop and async engines: the
    merge-in of the pulled global (line 15, :func:`merge_in`), then the step
    plan (Alg. 1 lines 16-17).

    ``train_fn(params, global_lora, lora, opt, neuron_mask, gal_mask,
    batch_of, batch_idx, step_valid, lr) -> (new_lora, new_opt, losses
    (S,) f32)``, where ``batch_idx``/``step_valid`` (S,) are the client's
    step plan (:func:`repro_torch.core.curriculum.step_plan`),
    ``neuron_mask`` its update mask (None: dense) and ``batch_of(j)`` its
    batch ``j`` on the device. Unlike the JAX package,
    which runs the padded steps as no-ops so that one compiled program
    serves every client, this runs only the valid steps, each a masked
    SGD/AdamW step on the client's own (unpadded) batch: one optimizer
    launch per valid step and none for padding. Both engines run this
    function, so the degenerate async run is the loop run's local training
    step for step. ``losses`` keeps the plan's padded length, with
    zeros at padded steps (they carry weight 0 in the round's loss). No
    argument is written in place: the pulled ``global_lora`` may be shared
    by other clients in flight.
    """

    def train_fn(params, global_lora, lora, opt, neuron_mask, gal_mask, batch_of, batch_idx, step_valid, lr):
        lora = merge_in(global_lora, lora, gal_mask)
        losses = {}
        for s in np.flatnonzero(np.asarray(step_valid) > 0).tolist():
            batch = batch_of(int(batch_idx[s]))
            grads, loss = grad_and_value(lambda lo: loss_fn(params, lo, batch))(lora)
            lora, opt = opt_update(grads, opt, lora, lr, neuron_mask)
            losses[s] = loss.detach().to(torch.float32)
        zero = next(iter(losses.values())).new_zeros(())
        return lora, opt, torch.stack([losses.get(s, zero) for s in range(len(step_valid))])

    return train_fn


def build_round_fn(loss_fn: Callable, opt_update: Callable, *, use_neuron_mask: bool,
                   compress: Optional[Dict[str, Any]] = None,
                   reduce: Optional[Callable[[Any], Any]] = None) -> Callable:
    """The whole tuning round over the cohort.

    ``round_fn(params, global_lora, stacked_lora, stacked_opt, neuron_mask,
    gal_mask, data, sample_valid, chosen, batch_idx, step_valid, weights, lr,
    stacked_residual=None, comp_mask=None) -> (new_global_lora, losses (S, k))``

    Stacked trees carry the population axis C; ``chosen`` (k,) int64 picks
    the cohort, ``batch_idx``/``step_valid`` (k, S) are the step plan
    (:func:`repro_torch.core.curriculum.step_plan`), ``weights`` (k,) f32.
    ``stacked_lora``, ``stacked_opt`` and ``stacked_residual`` are updated in
    place. ``neuron_mask`` is read only with ``use_neuron_mask``.

    ``compress`` (``qmax``/``topk_ratio``/``use_thresh``/``error_feedback``/
    ``has_comp_mask``) switches the server aggregation to the compressed
    upload: each client's GAL delta (plus its error-feedback residual) goes
    through :func:`repro_torch.kernels.ops.fake_compress`, stacked, and the
    server applies the reconstructions delta-style (:func:`gal_delta_merge`).
    ``comp_mask`` is then the stacked per-client top-k count mask, or None
    for the shared GAL mask. ``reduce`` goes to the merge: the sharded
    engine runs this body on each rank's part of the cohort.
    """
    client_step = make_client_step(loss_fn, opt_update)

    def round_fn(params, global_lora, stacked_lora, stacked_opt, neuron_mask, gal_mask, data,
                 sample_valid, chosen, batch_idx, step_valid, weights, lr,
                 stacked_residual=None, comp_mask=None):
        cl_lora = _gather(stacked_lora, chosen)
        cl_opt = _gather(stacked_opt, chosen)
        cl_mask = _gather(neuron_mask, chosen) if use_neuron_mask else None
        cl_lora = merge_in(global_lora, cl_lora, gal_mask)
        losses = []
        for s in range(batch_idx.shape[1]):
            bidx = batch_idx[:, s]
            batch = {kk: v[chosen, bidx] for kk, v in data.items()}
            loss, cl_lora, cl_opt = client_step(params, cl_lora, cl_opt, cl_mask, batch,
                                                sample_valid[chosen, bidx], lr, step_valid[:, s])
            losses.append(loss)
        losses = torch.stack(losses)
        _scatter_(stacked_lora, chosen, cl_lora)
        _scatter_(stacked_opt, chosen, cl_opt)
        if compress is None:
            return gal_weighted_merge(global_lora, gal_mask, cl_lora, weights, reduce), losses

        delta = tree_map(lambda l, g, m: (l - g) * m, cl_lora, global_lora, gal_mask)
        ef = compress["error_feedback"]
        y, new_res = _kops.fake_compress(
            delta,
            _gather(stacked_residual, chosen) if ef else None,
            _gather(comp_mask, chosen) if compress["has_comp_mask"] else gal_mask,
            qmax=compress["qmax"], topk_ratio=compress["topk_ratio"],
            use_thresh=compress["use_thresh"], stacked=True,
        )
        if ef:
            _scatter_(stacked_residual, chosen, new_res)
        return gal_delta_merge(global_lora, gal_mask, y, weights, reduce), losses

    return round_fn


def build_difficulty_fn(loss_fn: Callable, metric: str) -> Callable:
    """(C, NB) difficulty scores over the padded client stack:
    ``diff(params, stacked_lora, data, sample_valid)``. ``metric`` is
    "fisher" (Formula 17, :func:`fisher.batch_fisher_scores`) or "loss"
    (masked mean loss). Each client is scored with its own LoRA, which
    matters on a re-init after training rounds."""
    if metric == "fisher":

        def per_client(params, lora, cdata, csv):
            return fish.batch_fisher_scores(loss_fn, params, lora, cdata, csv)

    elif metric == "loss":
        masked = loss_fn.masked

        def per_client(params, lora, cdata, csv):
            with torch.no_grad():
                return torch.stack([masked(params, lora, {k: v[j] for k, v in cdata.items()}, csv[j])
                                    for j in range(csv.shape[0])])

    else:
        raise ValueError(f"no vectorized difficulty path for metric {metric!r}")

    def diff(params, stacked_lora, data, sample_valid):
        return vmap(lambda lo, cd, cv: per_client(params, lo, cd, cv))(stacked_lora, data, sample_valid)

    return diff


def build_fim_warmup_fn(loss_fn: Callable, momentum: float) -> Callable:
    """Momentum-FIM warmup over all clients at once: ``warm(params,
    stacked_lora, wdata, wsv)`` with the warmup batches stacked to
    ``(C, E, B, ...)`` returns the per-client momentum diag-FIM trees stacked
    to ``(C, ...)``, replaying ``fim_momentum_update`` (the first epoch
    initializes, later ones blend with ``momentum``)."""

    def per_client(params, lora, cdata, csv):
        fim = None
        for e in range(csv.shape[0]):
            new = fish.fim_diag(loss_fn, params, lora, {k: v[e] for k, v in cdata.items()}, csv[e])
            fim = fish.fim_momentum_update(fim, new, momentum)
        return fim

    def warm(params, stacked_lora, wdata, wsv):
        return vmap(lambda lo, cd, cv: per_client(params, lo, cd, cv))(stacked_lora, wdata, wsv)

    return warm


# ---------------------------------------------------------------------------
# the sharded engine: the vectorized round over a client mesh
# ---------------------------------------------------------------------------


def client_sharding(mesh):
    """Placement of the population-stacked client trees (LoRA, optimizer
    state, neuron masks, error-feedback residuals, top-k count masks, the
    data grid and ``sample_valid``): the leading client axis split over the
    mesh's client groups, rank r holding the contiguous block r."""
    from torch.distributed.tensor import Shard

    del mesh  # one client axis: the placement does not depend on the mesh's size
    return (Shard(0),)


def replicated_sharding(mesh):
    """Placement of base params, the global LoRA and the GAL mask: every rank
    holds all of it and makes the same host decisions."""
    from torch.distributed.tensor import Replicate

    del mesh
    return (Replicate(),)


def mesh_group(mesh):
    """``(process group, client groups G, this rank's index)`` of a client
    mesh: one dimension, named ``"data"`` (or ``"pod"``)."""
    from repro_torch.launch.mesh import dp_axes

    axes = dp_axes(mesh)
    if mesh.ndim != 1 or len(axes) != 1:
        raise ValueError("the sharded engine takes a one-dimensional client mesh (launch.mesh.make_client_mesh)")
    return mesh.get_group(axes[0]), mesh.size(), mesh.get_local_rank(axes[0])


def _row_bytes(leaves, rows) -> torch.Tensor:
    """Rows ``rows`` of every leaf (leading client axis) as one uint8 matrix
    ``(len(rows), bytes a row)``: a collective moves any dtypes at once, and
    moves bits, so a row arrives bit for bit."""
    n = int(rows.numel())
    parts = [x.index_select(0, rows).reshape(n, math.prod(x.shape[1:])).view(torch.uint8) for x in leaves]
    if not parts:
        return torch.empty((n, 0), dtype=torch.uint8, device=rows.device)
    return torch.cat(parts, dim=1)


def _from_row_bytes(buf: torch.Tensor, like) -> List[torch.Tensor]:
    """The inverse of :func:`_row_bytes`: leaves shaped as ``like``'s rows."""
    out, off, n = [], 0, buf.shape[0]
    for x in like:
        width = math.prod(x.shape[1:]) * x.element_size()
        # a contiguous copy: a view's byte offset and row stride need not
        # suit the wider dtype
        part = buf[:, off:off + width].clone(memory_format=torch.contiguous_format)
        out.append(part.view(x.dtype).reshape(n, *x.shape[1:]))
        off += width
    return out


def all_gather_rows(trees: Sequence[Any], mesh) -> List[Any]:
    """Client-sharded ``trees`` (each leaf's leading axis a rank's block,
    :func:`client_sharding`) replicated: every rank's rows, in rank order, on
    every rank. Collective: every rank calls it."""
    from torch.distributed.tensor import DTensor

    leaves = [x for t in trees for x in tree_leaves(t)]
    if not leaves:
        return list(trees)
    rows = _row_bytes(leaves, torch.arange(leaves[0].shape[0], device=leaves[0].device))
    full = DTensor.from_local(rows, mesh, client_sharding(mesh)).redistribute(
        mesh, replicated_sharding(mesh)).to_local()
    return _unflatten_trees(trees, _from_row_bytes(full, leaves))


def _unflatten_trees(like_trees, leaves):
    out, i = [], 0
    for t in like_trees:
        n = len(tree_leaves(t))
        out.append(tree_unflatten(t, leaves[i:i + n]))
        i += n
    return out


def _all_reduce_sum(tree, group):
    """Sum a tree over the ranks, one all-reduce a dtype (the merge's partial
    contractions are all f32)."""
    leaves = tree_leaves(tree)
    out = list(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, torch.split(flat, [leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return tree_unflatten(tree, out)


class _RowExchange:
    """Who sends which client rows where in one sharded round.

    ``chosen`` (k_pad,) are rows of the padded population stack, whose block
    r of ``rows_per_rank`` rows rank r owns; rank r trains cohort positions
    ``[r·k_loc, (r+1)·k_loc)``. :meth:`fetch` brings each position's rows to
    its trainer (one ``all_to_all``), :meth:`give_back` returns the updated
    rows to their owners (another). Every rank computes the same plan from
    the same host decisions.
    """

    def __init__(self, chosen: np.ndarray, rows_per_rank: int, G: int, rank: int, group, device):
        k_pad = len(chosen)
        self.k_loc = k_pad // G
        owner = chosen // rows_per_rank
        trainer = np.arange(k_pad) // self.k_loc
        send = [np.flatnonzero((owner == rank) & (trainer == q)) for q in range(G)]
        recv = [np.flatnonzero((trainer == rank) & (owner == q)) for q in range(G)]
        self.send_splits = [len(p) for p in send]
        self.recv_splits = [len(p) for p in recv]
        send_pos, recv_pos = np.concatenate(send), np.concatenate(recv)
        self.send_rows = torch.as_tensor(chosen[send_pos] % rows_per_rank, dtype=torch.int64, device=device)
        # received rows come grouped by owner; slot_order puts them in position order
        slots = recv_pos - rank * self.k_loc
        self.recv_slots = torch.as_tensor(slots, dtype=torch.int64, device=device)
        self.slot_order = torch.as_tensor(np.argsort(slots), dtype=torch.int64, device=device)
        self.group = group

    def fetch(self, trees: Sequence[Any]) -> List[Any]:
        """The cohort's rows of ``trees`` on their trainer: trees of k_loc rows."""
        leaves = [x for t in trees for x in tree_leaves(t)]
        out = self._swap(_row_bytes(leaves, self.send_rows), self.recv_splits, self.send_splits)
        return _unflatten_trees(trees, _from_row_bytes(out.index_select(0, self.slot_order), leaves))

    def give_back(self, cohort: Sequence[Any], stacked: Sequence[Any]) -> None:
        """Write the trained cohort rows back into their owners' ``stacked``
        blocks, in place."""
        leaves = [x for t in cohort for x in tree_leaves(t)]
        out = self._swap(_row_bytes(leaves, self.recv_slots), self.send_splits, self.recv_splits)
        dest = [x for t in stacked for x in tree_leaves(t)]
        for d, v in zip(dest, _from_row_bytes(out, leaves)):
            d.index_copy_(0, self.send_rows, v.to(d.dtype))

    def _swap(self, buf, out_splits, in_splits):
        out = buf.new_empty((sum(out_splits), buf.shape[1]))
        dist.all_to_all_single(out, buf.contiguous(), out_splits, in_splits, group=self.group)
        return out


def build_sharded_round_fn(loss_fn: Callable, opt_update: Callable, *, use_neuron_mask: bool, mesh,
                           compress: Optional[Dict[str, Any]] = None) -> Callable:
    """The round of :func:`build_round_fn` over a client mesh, run by every
    rank on its own part (multi-controller SPMD).

    ``round_fn`` takes :func:`build_round_fn`'s arguments, with the
    population-stacked trees (``stacked_lora``, ``stacked_opt``,
    ``neuron_mask``, ``data``, ``sample_valid``, ``stacked_residual``,
    ``comp_mask``) the rank's block of the padded stack (:func:`client_sharding`)
    and ``chosen`` (k_pad,), ``batch_idx``/``step_valid`` (k_pad, S) and
    ``weights`` (k_pad,) the whole padded cohort, replicated; k_pad must be
    a multiple of the mesh's size. The rank's cohort positions' rows reach it
    by one collective before the step loop (the data grid's included), the
    single-device body trains them (:func:`build_round_fn` on plain local
    tensors, with the fused kernels), the partial weighted sums of the merge
    meet in one all-reduce before the GAL blend, and the trained rows go back
    to their owners. Returns ``(new_global_lora, losses (S, k_pad))``, both
    equal on every rank. On one rank it is the vectorized round, bit for bit.
    """
    group, G, rank = mesh_group(mesh)
    body = build_round_fn(loss_fn, opt_update, use_neuron_mask=use_neuron_mask, compress=compress,
                          reduce=lambda agg: _all_reduce_sum(agg, group))
    ef = compress is not None and compress["error_feedback"]
    has_cm = compress is not None and compress["has_comp_mask"]

    def round_fn(params, global_lora, stacked_lora, stacked_opt, neuron_mask, gal_mask, data,
                 sample_valid, chosen, batch_idx, step_valid, weights, lr,
                 stacked_residual=None, comp_mask=None):
        chosen = np.asarray(chosen.cpu() if isinstance(chosen, torch.Tensor) else chosen, np.int64)
        if len(chosen) % G:
            raise ValueError(f"the padded cohort ({len(chosen)}) must divide over the mesh's {G} client groups")
        dev = sample_valid.device
        ex = _RowExchange(chosen, sample_valid.shape[0], G, rank, group, dev)
        carried = [stacked_lora, stacked_opt] + ([stacked_residual] if ef else [])
        fixed = [data, sample_valid] + ([neuron_mask] if use_neuron_mask else []) + ([comp_mask] if has_cm else [])
        cohort = ex.fetch(carried + fixed)
        c_carried, (c_data, c_sv, *rest) = cohort[:len(carried)], cohort[len(carried):]
        c_mask = rest.pop(0) if use_neuron_mask else None
        c_cm = rest.pop(0) if has_cm else None
        mine = slice(rank * ex.k_loc, (rank + 1) * ex.k_loc)
        new_global, losses = body(
            params, global_lora, c_carried[0], c_carried[1], c_mask, gal_mask, c_data, c_sv,
            torch.arange(ex.k_loc, device=dev), batch_idx[mine], step_valid[mine], weights[mine], lr,
            c_carried[2] if ef else None, c_cm,
        )
        ex.give_back(c_carried, carried)
        # (S, k_pad) laid out as the vectorized round's, so that host sums
        # over it run in the same order
        return new_global, all_gather_rows([losses.T], mesh)[0].T.contiguous()

    return round_fn


def build_sharded_compressed_round_fn(loss_fn: Callable, opt_update: Callable, *, use_neuron_mask: bool,
                                      compress: Dict[str, Any], mesh) -> Callable:
    """:func:`build_sharded_round_fn` with the compressed upload: each rank
    runs B3 once over its positions' GAL deltas, the error-feedback residual
    rows travel with the LoRA rows, and the server's delta merge sums the
    ranks' partial ``Σ w·y`` in the all-reduce."""
    return build_sharded_round_fn(loss_fn, opt_update, use_neuron_mask=use_neuron_mask, mesh=mesh,
                                  compress=compress)


def build_sharded_difficulty_fn(loss_fn: Callable, metric: str, mesh) -> Callable:
    """Difficulty scoring with each rank scoring its own rows; the padded
    ``(C_stack, NB)`` score grid is all-gathered, so every rank sorts the
    same curriculum."""
    mesh_group(mesh)
    diff = build_difficulty_fn(loss_fn, metric)

    def sharded(params, stacked_lora, data, sample_valid):
        return all_gather_rows([diff(params, stacked_lora, data, sample_valid)], mesh)[0]

    return sharded


def build_sharded_fim_warmup_fn(loss_fn: Callable, momentum: float, mesh) -> Callable:
    """The FIM warmup over each rank's own rows: the stacked FIM trees stay
    on their owner (they feed its neuron masks), so no collective runs."""
    mesh_group(mesh)
    return build_fim_warmup_fn(loss_fn, momentum)
