"""Vectorized federated round engine (port of the single-device parts of
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

The loop and async engines take one client's local round
(:func:`build_client_train_fn`), the async engine also the standalone
merges (:func:`gal_weighted_merge`, :func:`gal_delta_merge`,
:func:`lora_delta`). None of them writes its inputs: a global version a
straggler pulled must survive later merges unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import fisher as fish
from repro_torch.kernels import ops as _kops
from repro_torch.utils.tree import tree_map


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


def gal_weighted_merge(global_lora, gal_mask, stacked_client_lora, weights):
    """Weighted FedAvg over the GAL part only (Alg. 1 line 18). ``weights``
    (k,) f32 are normalized; the contraction over the client axis is the
    server aggregation."""
    agg = tree_map(lambda x: torch.tensordot(weights, x.to(torch.float32), dims=1),
                   stacked_client_lora)
    # the float mask/weight arithmetic must not widen bf16 leaves
    return tree_map(lambda g, m, a: (m * a + (1.0 - m) * g).to(g.dtype), global_lora, gal_mask, agg)


def gal_delta_merge(global_lora, gal_mask, stacked_deltas, weights):
    """Delta application over the GAL part: ``global += Σ_i w_i · delta_i``
    on GAL layers, identity elsewhere. With normalized weights and lossless
    deltas it equals :func:`gal_weighted_merge`."""
    agg = tree_map(lambda x: torch.tensordot(weights, x.to(torch.float32), dims=1), stacked_deltas)
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
                   compress: Optional[Dict[str, Any]] = None) -> Callable:
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
    for the shared GAL mask.
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
            return gal_weighted_merge(global_lora, gal_mask, cl_lora, weights), losses

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
        return gal_delta_merge(global_lora, gal_mask, y, weights), losses

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
