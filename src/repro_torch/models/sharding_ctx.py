"""Context for model-internal sharding constraints (port of
``repro.models.sharding_ctx``).

Model code cannot name mesh axes directly (one pod has no ``"pod"`` axis,
tests run on one process), so the launcher publishes the active
data-parallel axes here and models express constraints symbolically:

    constrain(h, ("dp", "model", None))   # sequence-parallel activations

A constraint redistributes a ``DTensor`` to the placements the spec names
on its own mesh; axes its mesh lacks are dropped. Outside a mesh (a plain
tensor) or while disabled, it is the identity, as in the JAX package.

The other helpers here stand where GSPMD would reshard by itself and
DTensor refuses or errs (ROADMAP.md C13): a vocab-sharded lookup
(:func:`replicate_partial`), heads split from a projection sharded across
a KV head (:func:`unshard_unless`), attention, the Mamba2 mixer's scan
and the routed experts on each rank's heads or experts
(:func:`local_heads`, :func:`local_ssm`, :func:`local_experts`), cache
writes on each rank's shards (:func:`local_write`, :func:`put`).
Each is the identity on plain tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_DP_AXES: Tuple[str, ...] = ("data",)
_ENABLED: bool = False


def set_mesh_axes(dp_axes: Sequence[str], enabled: bool = True) -> None:
    global _DP_AXES, _ENABLED
    _DP_AXES = tuple(dp_axes)
    _ENABLED = enabled


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _is_dtensor(x) -> bool:
    # a plain tensor leaves before torch.distributed.tensor is imported
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, symbolic_spec: Sequence) -> torch.Tensor:
    """Redistribute ``x`` to the spec; ``"dp"`` expands to the client axes."""
    if not _ENABLED or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    placements = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(symbolic_spec):
        if entry is None:
            continue
        axes = _DP_AXES if entry == "dp" else (entry if isinstance(entry, (tuple, list)) else (entry,))
        for a in axes:
            if a in names:
                placements[names.index(a)] = Shard(dim)
    return x.redistribute(mesh, placements)


def replicate_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums reduced to replicas; anything else as it is.

    A vocab-sharded embedding lookup leaves each rank's rows as a partial
    sum (the rows of other shards masked to zero); the model reduces it
    before its first norm, where GSPMD's gather inserts the same reduction.
    """
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])


def unshard_unless(x: torch.Tensor, dim: int, divides: int) -> torch.Tensor:
    """``x`` with its shards of ``dim`` gathered unless their count divides
    ``divides``; anything but a DTensor as it is.

    Splitting a sharded feature dim into heads needs whole (KV) heads on
    each shard (GSPMD reshards such a reshape itself; DTensor refuses it):
    a projection sharded 16 ways over 14 heads is gathered first."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    mesh = x.device_mesh
    shards = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            shards *= mesh.size(i)
    if divides % shards == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p == Shard(dim) else p for p in x.placements])


def local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``fn(q, k, v, ...)``, an attention over (B, S, heads, D) tensors, run
    on each rank's heads where the three are DTensors: heads stay sharded on
    the mesh dims that shard all three over dim 2 (whole KV groups, see
    :func:`unshard_unless`), the others replicate, and the output is
    sharded as q is. Attention is independent across heads, so the ranks
    need no exchange inside it (and DTensor sees none of its reshapes).
    Any other placement (a pending sum, a batch or time axis sharded on a
    mesh dim, as DTensor may leave one) is gathered first. Plain tensors go
    to ``fn`` as they are."""
    if not any(_is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v, *args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = next(t for t in (q, k, v) if _is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    ts = [t if _is_dtensor(t) else DTensor.from_local(t, mesh, rep, run_check=False) for t in (q, k, v)]
    pl = [Shard(2) if all(t.placements[i] == Shard(2) for t in ts) else Replicate() for i in range(mesh.ndim)]
    out = fn(*(_ContiguousGrad.apply(t.redistribute(mesh, pl).to_local()) for t in ts), *args, **kwargs)
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False)


def local_ssm(fn, zxbcdt: torch.Tensor, p, nheads: int, conv_buf=None, state=None):
    """``fn(zxbcdt, p, first, count, conv_buf, state) -> (y, z, conv,
    state)``, the Mamba2 mixer's core between its two projections (the
    conv, the scan and the skip over heads ``[first, first + count)``; see
    :func:`repro_torch.models.ssm._core`), run on each rank's heads where
    the layer's params are DTensors.

    ``in_proj``'s columns ``[z | x | B | C | dt]`` and ``conv_w``'s
    channels are sharded in blocks that cut across those parts, which
    DTensor cannot slice. So where ``out_proj`` shards its rows (the heads)
    on one mesh dim of G ranks and G divides ``nheads``, every rank gathers
    ``zxbcdt`` (its gradient a partial sum: each rank reads its heads' z, x
    and dt and the whole of B and C) and the small params, and runs the
    core on its ``nheads / G`` heads; ``y`` and ``z`` come back sharded on
    their last dim and ``state`` on its heads, as ``gate_norm_w`` and
    ``out_proj`` are, so the gated norm and ``out_proj`` stay with DTensor
    (one all-reduce of the norm's sum of squares, ``out_proj`` a partial
    sum). Otherwise every rank runs all heads on gathered inputs and the
    outputs are replicated. ``conv`` (the conv's window, every channel)
    comes back plain and whole; a cache ``state`` is read at the rank's
    heads. Plain params go to ``fn`` as they are, with all the heads."""
    w = p["out_proj"]
    if not _is_dtensor(w):
        return fn(zxbcdt, p, 0, nheads, conv_buf, state)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = w.device_mesh
    rep = [Replicate()] * mesh.ndim
    by_head = [i for i, pl in enumerate(w.placements) if pl == Shard(0)]
    split = len(by_head) == 1 and nheads % mesh.size(by_head[0]) == 0 and \
        all(pl == Replicate() for i, pl in enumerate(w.placements) if i not in by_head)
    if split:
        d = by_head[0]
        count = nheads // mesh.size(d)
        first = mesh.get_local_rank(d) * count
        grad = [Partial() if i == d else Replicate() for i in range(mesh.ndim)]
        last = lambda t: [Shard(t.dim() - 1) if i == d else Replicate() for i in range(mesh.ndim)]  # noqa: E731
        heads = [Shard(1) if i == d else Replicate() for i in range(mesh.ndim)]
    else:
        first, count, grad, last, heads = 0, nheads, rep, (lambda t: rep), rep

    def whole(t):
        if not _is_dtensor(t):
            return t
        return _ContiguousGrad.apply(t.redistribute(t.device_mesh, rep).to_local(grad_placements=grad))

    def own_heads(t):
        if t is None:
            return None
        if _is_dtensor(t):
            if split and list(t.placements) == heads:
                return t.to_local()
            t = t.full_tensor()
        return t[:, first:first + count] if split else t

    core = {k: whole(p[k]) for k in ("conv_w", "A_log", "D", "dt_bias")}
    conv_buf = conv_buf.full_tensor() if _is_dtensor(conv_buf) else conv_buf
    y, z, conv, st = fn(whole(zxbcdt), core, first, count, conv_buf, own_heads(state))
    wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)  # noqa: E731
    return wrap(y, last(y)), wrap(z, last(z)), conv, wrap(st, heads)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: ``from_local`` takes
    a local gradient to be laid out as its DTensor's strides say, and the
    attention's gradients of q, k, v may be permuted views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_write(dst: torch.Tensor, src: torch.Tensor):
    """``(dst, src)`` for an in-place write of ``src`` into ``dst`` along a
    dim neither shards: where ``dst`` is a DTensor, each rank's shards,
    ``src`` placed as ``dst`` first; into a plain ``dst``, ``src`` whole;
    plain tensors as they are. DTensor itself has no rule for such writes
    on some versions (``index_copy_`` on torch 2.11) and on others relabels
    ``dst`` instead of moving ``src`` (2.13)."""
    if not _is_dtensor(dst):
        # a plain cache (every rank's whole one) takes a DTensor gathered
        return dst, (src.full_tensor() if _is_dtensor(src) else src)
    from torch.distributed.tensor import DTensor, Replicate

    if not _is_dtensor(src):
        src = DTensor.from_local(src, dst.device_mesh, [Replicate()] * dst.device_mesh.ndim, run_check=False)
    if src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.to_local(), src.to_local()


def local_experts(fn, xe: torch.Tensor, combine: torch.Tensor, e_gate: torch.Tensor, e_up: torch.Tensor,
                  e_down: torch.Tensor) -> torch.Tensor:
    """``fn(xe, combine, e_gate, e_up, e_down)``, the routed experts and
    their combine (:func:`repro_torch.models.moe._experts`), run on each
    rank's experts where the expert weights are DTensors: a mesh dim that
    shards the experts (expert parallel, ``Shard(0)`` of (E, D, F)) takes
    its slice of ``xe``'s and ``combine``'s expert axes, one that shards
    within the experts (``Shard(2)`` of gate and up, ``Shard(1)`` of down)
    its slice of F; either leaves each rank a partial sum of the tokens'
    outputs. DTensor cannot reshape these einsums' sharded operands on
    some versions (torch 2.11). Plain tensors go to ``fn`` as they are."""
    if not _is_dtensor(e_gate):
        return fn(xe, combine, e_gate, e_up, e_down)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = e_gate.device_mesh
    rep = [Replicate()] * mesh.ndim
    if any(p not in (Replicate(), Shard(0), Shard(2)) for p in e_gate.placements):
        return fn(xe, combine, e_gate, e_up, e_down)
    by_expert = [p == Shard(0) for p in e_gate.placements]
    within = [p == Shard(2) for p in e_gate.placements]

    def placed(t, pl):
        # a rank's slice of F gives a partial gradient of its replicated inputs
        if not _is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        grad_pl = [Partial() if w and q == Replicate() else q for w, q in zip(within, pl)]
        return _ContiguousGrad.apply(t.redistribute(mesh, pl).to_local(grad_placements=grad_pl))

    out = fn(placed(xe, [Shard(0) if e else Replicate() for e in by_expert]),
             placed(combine, [Shard(3) if e else Replicate() for e in by_expert]),
             placed(e_gate, e_gate.placements), placed(e_up, e_gate.placements),
             placed(e_down, [Shard(1) if p == Shard(2) else p for p in e_gate.placements]))
    return DTensor.from_local(out.contiguous(), mesh,
                              [Replicate() if p == Replicate() else Partial() for p in e_gate.placements],
                              run_check=False)


def put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` (``dst`` a view of a cache, as ``cache[i] = src``
    writes it), through :func:`local_write` where either is a DTensor."""
    d, v = local_write(dst, src)
    d.copy_(v)
