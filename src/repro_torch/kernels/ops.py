"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on its tensors' device alone: a CUDA tensor goes to
the hand-written kernel (which raises if it cannot launch), a CPU tensor to
the plain version in :mod:`repro_torch.kernels.ref`. Each wrapper carries a
``launches`` count, raised by one for every kernel launch and by nothing
else. Masked SGD, masked AdamW and fake compression launch once for a
whole tree (up to 32 leaves); the Fisher update launches leaf by leaf; the
LoRA products take arrays with any leading dimensions.
The Fisher update, the LoRA products, flash attention and the SSD
intra-chunk scan keep the JAX package's names, signatures, argument order,
layouts and output dtypes. The kernels mask their own ragged edges, so nothing is padded
to tiles.

The wrappers are functional: new tensors come back and the inputs are left
as they were, on both devices. Each takes stacked clients (the vectorized
engine's state, k clients on every leaf's leading axis) as well as single
trees, with one launch covering all k clients.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import compress as _cp
from repro_torch.kernels import fisher_diag as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_update as _mu
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_lora as _sl
from repro_torch.kernels import ssd_chunk as _sc
from repro_torch.kernels import tree_launch as _tl
from repro_torch.utils.tree import tree_leaves, tree_leaves_like, tree_map, tree_unflatten, tree_unzip


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def as_f32(x, device) -> torch.Tensor:
    # a Python number becomes a fill on the device: no blocking host copy
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _active_f32(active, device) -> torch.Tensor:
    if active is None:
        return as_f32(1.0, device)
    if isinstance(active, torch.Tensor):
        return (active.to(device) != 0).to(torch.float32)
    return as_f32(float(active != 0), device)


def adam_step_scales(t, active, b1: float, b2: float):
    """Advance Adam's int32 step counter (only on active steps) and return
    ``(t', mhat_scale, vhat_scale)``, the scales computed once in f32."""
    if active is None:
        inc = 1
    elif isinstance(active, torch.Tensor):
        inc = (active.to(t.device) != 0).to(torch.int32)
    else:
        inc = int(active != 0)
    t = t + inc
    tf = t.to(torch.float32)
    return t, 1.0 / (1.0 - b1 ** tf), 1.0 / (1.0 - b2 ** tf)


def per_client(x, leaf):
    """A per-client (k,) tensor shaped to broadcast over a stacked leaf;
    anything else as it is."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return x


def _scal_table(*cols) -> torch.Tensor:
    """B2's contiguous f32 (k, 4) table from scalar or (k,) columns."""
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1).reshape(-1, 4).contiguous()


def _masks(mask, params):
    return mask if mask is not None else tree_map(lambda _: None, params)


def sgd_scalars(lr, active, device):
    """B2's scalars: ``(lr, active, None)`` as Python numbers when both are
    numbers (``active`` None counts as 1), so that they travel by value and
    the call makes no device work for them; else ``(0, 0, table)`` with the
    contiguous f32 (k, 4) device table of rows ``[lr, active, 0, 0]``, k
    the length of a (k,) ``active`` (1 otherwise), built once per call. The
    kernel reads a row's active as ``!= 0``, so a float active goes in as it
    is."""
    if not isinstance(lr, torch.Tensor):
        if not isinstance(active, torch.Tensor):
            return float(lr), 1.0 if active is None else float(active != 0), None
        act = active if active.dim() == 1 else active.reshape(1)
        if act.dtype != torch.float32:
            act = (act != 0).to(torch.float32)
        zero = torch.zeros_like(act)
        return 0.0, 0.0, torch.stack((torch.full_like(act, float(lr)), act, zero, zero), dim=1)
    zero = as_f32(0.0, device)
    return 0.0, 0.0, _scal_table(as_f32(lr, device), _active_f32(active, device), zero, zero)


def masked_sgd_update(grads, state, params, lr, mask=None, active=None, *, momentum: float = 0.0):
    """Masked SGD(+momentum) over a tree: on the card one kernel launch for
    the whole tree (up to 32 leaves; a larger tree takes one launch per 32).

    Same signature and frozen-moment semantics as
    :func:`repro_torch.optim.optimizers.sgd_update`: entries with
    ``mask == 0``, and every entry when ``active == 0``, keep parameter AND
    momentum bit for bit. An ``active`` of shape (k,) means every leaf
    stacks k clients on its leading axis, each with its own predicate. The
    mask tree may hold None leaves (dense leaves beside masked ones). The
    momentum may be f32 or bf16 and keeps its dtype. On the card the new
    leaves are views into one buffer per dtype.
    """
    ps = tree_leaves(params)
    cuda = [p for p in ps if _on_cuda(p)]
    if not cuda:
        lr_t = as_f32(lr, ps[0].device)

        def one(p, g, mu, mk):
            return _ref.masked_sgd_update_ref(p, g, mu if momentum else None, mk, lr_t,
                                              momentum=momentum, active=per_client(active, p))

        mus = state["mu"] if momentum else tree_map(lambda _: None, params)
        new_params, new_mu = tree_unzip(tree_map(one, params, grads, mus, _masks(mask, params)), 2)
        return (new_params, {"mu": new_mu}) if momentum else (new_params, state)

    # a tree with any leaf on the card goes to the kernel, which refuses a
    # leaf elsewhere; the other trees are read at params' leaf positions
    # (a key of params missing from one raises KeyError, as tree_map does)
    n = len(ps)
    none = [None] * n
    gs = tree_leaves_like(params, grads)
    mks = none if mask is None else tree_leaves_like(params, mask)
    mus = tree_leaves_like(params, state["mu"]) if momentum else []
    device = cuda[0].device
    lr_v, active_v, scal = sgd_scalars(lr, active, device)
    clients = 1 if scal is None else scal.shape[0]
    lay = _tl.layout(tuple((x.shape, x.dtype) for x in ps + mus))
    outs = _tl.views(lay, device)
    p_out, mu_out = outs[:n], (outs[n:] if momentum else none)
    for launch in _tl.plan(lay.sizes[:n], clients, _mu.SGD_CHUNK):
        _mu.sgd_tree_launch(launch, p_out, ps, gs, mu_out, mus or none, mks, clients=clients, scal=scal,
                            lr=lr_v, active=active_v, momentum=momentum)
        masked_sgd_update.launches += 1
    new_params = tree_unflatten(params, p_out)
    if momentum:
        return new_params, {"mu": tree_unflatten(params, mu_out)}
    return new_params, state


def masked_adamw_update(grads, state, params, lr, mask=None, active=None, *,
                        b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """Masked AdamW over a tree: on the card one kernel launch for the whole
    tree (up to 32 leaves; a larger tree takes one launch per 32).

    Same contract as :func:`repro_torch.optim.optimizers.adamw_update`:
    frozen entries hold parameter, ``m`` and ``v`` bit for bit, and the step
    counter ``t`` advances only on active steps. Stacked clients carry
    ``active`` and ``t`` of shape (k,): one step counter per client. The
    moments may be f32 or bf16 and keep their dtypes. On the card the kernel
    advances ``t`` and computes each client's bias-correction scales from it
    (the plain version's operations); lr and ``active`` travel by value when
    they are numbers, and a tensor ``active`` is read in place, so a step
    makes no device op besides the launch. The new leaves are views into one
    buffer per dtype.
    """
    ps = tree_leaves(params)
    cuda = [p for p in ps if _on_cuda(p)]
    if not cuda:
        t, mhat, vhat = adam_step_scales(state["t"], active, b1, b2)
        lr_t = as_f32(lr, t.device)

        def one(p, g, m, v, mk):
            return _ref.masked_adamw_update_ref(p, g, m, v, mk, lr_t, per_client(mhat, p),
                                                per_client(vhat, p), b1=b1, b2=b2, eps=eps, wd=wd,
                                                active=per_client(active, p))

        outs = tree_map(one, params, grads, state["m"], state["v"], _masks(mask, params))
        new_params, m, v = tree_unzip(outs, 3)
        return new_params, {"m": m, "v": v, "t": t}

    n = len(ps)
    gs = tree_leaves_like(params, grads)
    ms = tree_leaves_like(params, state["m"])
    vs = tree_leaves_like(params, state["v"])
    mks = [None] * n if mask is None else tree_leaves_like(params, mask)
    device = cuda[0].device
    t = state["t"]
    if isinstance(lr, torch.Tensor):
        lr = as_f32(lr, device)
    if active is None:
        active = 1.0
    elif not isinstance(active, torch.Tensor):
        active = float(active != 0)
    elif not (active.dtype == torch.float32 and active.is_cuda):
        active = (active.to(device) != 0).to(torch.float32)
    stacked = t.dim() == 1 or (isinstance(active, torch.Tensor) and active.dim() == 1)
    clients = t.shape[0] if t.dim() == 1 else (active.shape[0] if stacked else 1)
    t_out = torch.empty((clients,) if stacked else (), dtype=torch.int32, device=device)
    lay = _tl.layout(tuple((x.shape, x.dtype) for x in ps + ms + vs))
    outs = _tl.views(lay, device)
    launches = _tl.plan(lay.sizes[:n], clients, _mu.ADAMW_CHUNK)
    for launch in launches:
        _mu.adamw_tree_launch(launch, outs[:n], ps, gs, outs[n:2 * n], ms, outs[2 * n:], vs, mks,
                              clients=clients, t=t, t_out=t_out, lr=lr, active=active,
                              b1=b1, b2=b2, eps=eps, wd=wd)
        masked_adamw_update.launches += 1
    if not launches:  # every leaf is empty: no kernel advances t
        t_out = adam_step_scales(t, active, b1, b2)[0]
    return tree_unflatten(params, outs[:n]), {"m": tree_unflatten(params, outs[n:2 * n]),
                                              "v": tree_unflatten(params, outs[2 * n:]), "t": t_out}


def topk_rows(x2, mk, *, per_client_mask: bool, qmax: int, topk_ratio: float):
    """Per-client top-k threshold and per-leaf scale of ``x2`` (k, m): keep
    ``max(1, ceil(ratio · active))`` values, ``active`` counting the values
    under the mask's nonzero entries (a mask leaf may be broadcastable, each
    entry covering ``m // mask.numel()`` values of a client; a
    ``per_client_mask`` stacks one mask per client). The product runs in
    f32, as the JAX package computes it. The plain version: the card's
    kernel selects the same order statistic without a sort."""
    k, m = x2.shape
    flat = torch.abs(x2).to(torch.float32)
    if mk is None:
        active = torch.full((k,), float(m), device=x2.device)
    elif per_client_mask:
        active = torch.sum((mk != 0).reshape(k, -1), dim=1).to(torch.float32) * (m // (mk.numel() // k))
    else:
        active = (torch.sum(mk != 0).to(torch.float32) * (m // mk.numel())).expand(k)
    kk = torch.clamp(torch.ceil(topk_ratio * active), min=1.0).to(torch.int64)
    idx = torch.clamp(m - kk, 0, m - 1)
    thresh = torch.gather(torch.sort(flat, dim=1).values, 1, idx[:, None])[:, 0]
    scale = torch.amax(flat, dim=1) * _ref.inv_qmax(qmax) if qmax else torch.zeros(k, device=x2.device)
    return thresh, scale


def compress_rows(d, r, mk, *, qmax: int, topk_ratio: float, use_thresh: bool, stacked: bool):
    """The plain version's steps before :func:`ref.fake_compress_ref`, for
    one leaf: ``x = d + r`` flattened to ``x2`` (k, m), k the stacked
    clients (1 when not ``stacked``), and each client's threshold and scale
    (:func:`topk_rows`; zeros without top-k). Returns ``(x2, thresh,
    scale)``."""
    x = d if r is None else d + r.to(d.dtype)
    k = d.shape[0] if stacked else 1
    x2 = x.reshape(k, -1).contiguous()
    if not use_thresh:
        zeros = torch.zeros(k, device=x2.device)
        return x2, zeros, zeros
    per_client_mask = stacked and mk is not None and mk.dim() == d.dim()
    return (x2,) + topk_rows(x2, mk, per_client_mask=per_client_mask, qmax=qmax, topk_ratio=topk_ratio)


def _dense(t):
    return t if t.is_contiguous() else t.contiguous()


def fake_compress(delta, residual=None, mask=None, *, qmax: int = 0, topk_ratio: float = 1.0,
                  use_thresh: bool = False, stacked: bool = False):
    """Simulated compressed upload over a tree, with error feedback.

    Per leaf: ``x = delta + residual`` (what the client would send), ``y =
    dequant(quant(x))`` (what the server reconstructs, the value that enters
    the merge) and ``new_residual = x - y``. Returns ``(y_tree,
    new_residual_tree)``; ``residual`` None means no error feedback.

    ``qmax`` 127/7 selects int8/int4 with one scale per consecutive 128
    values of the flattened leaf; ``use_thresh`` adds per-leaf top-k, the
    threshold being the ``k``-th largest ``|x|`` with ``k = max(1,
    ceil(topk_ratio · active))`` (:func:`topk_rows`), and the scale the
    leaf's absmax·(1/qmax).

    On the card one kernel launch takes the whole tree (up to 32 leaves):
    it forms x, finds each (leaf, client) row's threshold and scale itself
    (a radix select in a thread-block cluster, no sort) and writes y and
    the residual, views into one buffer per dtype. On the CPU each leaf
    takes the plain version (:func:`compress_rows`, which sorts).

    ``stacked``: every leaf of ``delta``/``residual`` carries a leading axis
    of k clients, each compressed as its own leaf (its own threshold, scale
    and 128-groups); a mask leaf with that axis too (as many dimensions as
    the delta leaf) counts per client, one without is shared by all.
    """
    ds = tree_leaves(delta)
    cuda = [d for d in ds if _on_cuda(d)]
    if not cuda:
        per_leaf_scale = use_thresh and qmax > 0

        def one(d, r, mk):
            x2, thresh, scale = compress_rows(d, r, mk, qmax=qmax, topk_ratio=topk_ratio,
                                              use_thresh=use_thresh, stacked=stacked)
            y, res = _ref.fake_compress_ref(x2, thresh, scale, qmax=qmax, use_thresh=use_thresh,
                                            per_leaf_scale=per_leaf_scale)
            return y.reshape(d.shape), res.reshape(d.shape)

        resid = residual if residual is not None else tree_map(lambda _: None, delta)
        return tree_unzip(tree_map(one, delta, resid, _masks(mask, delta)), 2)

    n = len(ds)
    none = [None] * n
    rs = none if residual is None else tree_leaves_like(delta, residual)
    mks = none if mask is None or not use_thresh else tree_leaves_like(delta, mask)
    # the kernel reads d and r contiguous in one dtype (r rounded to d's, as
    # the plain version's r.to(d.dtype)) and counts a float32 mask's nonzeros
    ds = [_dense(d) for d in ds]
    rs = [r if r is None else _dense(r if r.dtype == d.dtype else r.to(d.dtype)) for d, r in zip(ds, rs)]
    mks = [mk if mk is None or (mk.dtype == torch.float32 and mk.is_contiguous())
           else (mk != 0).to(torch.float32).contiguous() for mk in mks]
    device = cuda[0].device
    clients = ds[0].shape[0] if stacked else 1
    lay = _tl.layout(tuple((d.shape, d.dtype) for d in ds) * 2)
    outs = _tl.views(lay, device)
    for launch in _tl.plan(lay.sizes[:n], clients, None if use_thresh else _cp.GROUP_CHUNK):
        _cp.fake_compress_tree_launch(launch, outs[:n], outs[n:], ds, rs, mks, clients=clients, stacked=stacked,
                                      qmax=qmax, topk_ratio=topk_ratio, use_thresh=use_thresh)
        fake_compress.launches += 1
    return tree_unflatten(delta, outs[:n]), tree_unflatten(delta, outs[n:])


def _kernel_float(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous f32/bf16 tensor; other floats become f32, the
    plain versions' first step."""
    t = t if t.dtype in _fd.DTYPE_CODES else t.to(torch.float32)
    return t.contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def fisher_diag_update(fim, g, momentum: float = 0.9):
    """Momentum diag-FIM update over a tree: ``γ·fim + (1-γ)·g⊙g`` per
    leaf, f32 out whatever the leaves' float dtypes; one kernel launch per
    CUDA leaf (a leaf stacking k clients is one launch)."""

    def one(f, gl):
        if _on_cuda(gl):
            out = torch.empty(gl.shape, dtype=torch.float32, device=gl.device)
            if out.numel():
                _fd.fisher_diag_launch(out, _kernel_float(gl), _kernel_float(f), momentum)
                fisher_diag_update.launches += 1
            return out
        return _ref.fisher_diag_update_ref(gl, f, momentum)

    return tree_map(one, fim, g)


def _lora_product(x, a, b, mask, idx, scale, plain, counter, packed=False):
    """The shared body of the LoRA products: flatten x's leading dimensions
    to rows, run the kernel (or the plain version on the CPU), restore them."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = b.shape[-1]
    x2 = x.reshape(-1, K)
    if not _on_cuda(x2):
        return plain(x2).reshape(*lead, N)
    y = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    if y.numel():
        path = _sl.sparse_lora_launch(y, x2.contiguous(), _f32(a), _f32(b), _f32(mask), idx, scale=scale,
                                      packed=packed)
        if path == "few_rows":
            counter.few_row_launches += 1
        elif path == "split":
            counter.split_launches += 1
        else:
            counter.launches += 1
    return y.reshape(*lead, N)


def sparse_lora_apply(x, a, b, mask, scale: float = 1.0):
    """``y = (x @ a) @ (b ⊙ mask) · scale``. x (..., K); a (K, r);
    b (r, N); mask (N,). y in x's dtype; a masked column is exactly 0."""
    return _lora_product(x, a, b, mask, None, scale,
                         lambda x2: _ref.sparse_lora_matmul_ref(x2, a, b, mask, scale), sparse_lora_apply)


def batched_sparse_lora_apply(x, idx, a, b, mask, scale: float = 1.0):
    """Multi-adapter apply: ``y[m] = x[m] @ a[idx[m]] @ (b[idx[m]] ⊙
    mask[idx[m]]) · scale``. x (..., K); idx (...,) any integer dtype;
    a (A, K, r); b (A, r, N); mask (A, N). A row whose index lies outside
    [0, A) comes out as zeros, as the JAX package's kernel gives it.

    On the card one launch groups the rows by adapter itself (no host sync,
    so a CUDA graph can capture the call), counted in ``launches``; a call
    that the SGMV kernel does not take (``sparse_lora.batched_path``) takes
    two chained launches spread over the card (no host sync) instead: the
    few-row path at most ``sparse_lora.FEW_MAX_ROWS`` rows, counted once in
    ``few_row_launches``, and the split path above, counted once in
    ``split_launches``."""
    idx2 = idx.reshape(-1)
    if _on_cuda(idx2) and idx2.dtype != torch.int32:
        # clamped first, so that no index wraps into range as int32
        idx2 = torch.clamp(idx2, -1, a.shape[0]).to(torch.int32)
    return _lora_product(x, a, b, mask, idx2.contiguous(), scale,
                         lambda x2: _ref.batched_sparse_lora_matmul_ref(x2, idx2, a, b, mask, scale),
                         batched_sparse_lora_apply)


def sparse_lora_apply_packed(x, a, b, mask, scale: float = 1.0):
    """Gather-packed apply: the result of :func:`sparse_lora_apply`, but
    the frozen columns of ``b`` never reach the product: they come out as
    exact zeros, whatever ``b`` holds there.

    On the card it is one launch that reads ``b`` only at the kept columns
    and writes all of ``(..., N)`` (no host sync, gather or scatter; all
    columns frozen: a launch that writes zeros). On the CPU the kept columns
    are gathered, multiplied and scattered into zeros, as the JAX wrapper
    does.
    """
    return _lora_product(x, a, b, mask, None, scale,
                         lambda x2: _ref.sparse_lora_apply_packed_ref(x2, a, b, mask, scale),
                         sparse_lora_apply_packed, packed=True)


def _fa_input(t):
    # contiguous, and a bf16 view off a 16-byte boundary copied to fresh
    # (aligned) storage: the tensor-core kernel's TMA maps need 16 bytes
    t = t.contiguous()
    return t.clone() if t.dtype == torch.bfloat16 and t.data_ptr() % 16 else t


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """GQA flash attention. q (B, S, H, D); k/v (B, S, KVH, D). Returns
    q-shaped, in q's dtype; query head h reads KV head ``h // (H // KVH)``.

    On the card one kernel launch reads the three tensors in place, for any
    S (a ragged last tile is masked in the kernel); D must be 64, 80, 112,
    128 or 256.
    bf16 inputs run on Hopper's tensor cores (``wgmma`` on K/V tiles that a
    producer warp brings in with TMA, two consumer warpgroups in ping-pong;
    a bf16 view off a 16-byte boundary is first copied), f32 on the CUDA
    cores; both keep the scores and p in f32 (bf16: p as hi + lo, two bf16
    products).
    Mixed dtypes, or a dtype other than f32/bf16, run in f32 and the output
    is cast to q's dtype, as the plain version does. On the CPU the heads are
    folded as the JAX wrapper folds them and the plain version runs.
    ``window`` is None or at least 1.
    """
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if _on_cuda(q):
        if not (q.dtype == k.dtype == v.dtype and q.dtype in _fa.DTYPE_CODES):
            q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
            return flash_attention(q32, k32, v32, causal=causal, window=window).to(q.dtype)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _fa.flash_attention_launch(out, *(_fa_input(t) for t in (q, k, v)), causal=causal, window=window)
        flash_attention.launches += 1
        return out
    return _ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)


def ssd_chunk_intra(x, a, b, c, heads: int = 1):
    """Intra-chunk SSD. x (G, Q, hd), a (G, 1, Q), b/c (G / heads, Q, N) ->
    (G, Q, hd) f32: ``y[g,i] = Σ_{j≤i} exp(cs_i - cs_j)·(c_i·b_j)·x[g,j]``
    with ``cs = cumsum(a[g,0])`` and b, c read at row ``g // heads`` (the
    heads of a chunk share its b and c), one kernel launch on the card.
    ``heads=1`` is the JAX kernel's contract: b and c per group.

    The kernel takes x, b and c in one dtype (f32 or bf16; otherwise all
    three run in f32, the plain version's first step) and a in f32 or bf16,
    Q a multiple of 8 up to 128 and hd a multiple of 4 up to 128.
    """
    if heads < 1 or x.shape[0] != heads * b.shape[0]:
        raise ValueError(f"{x.shape[0]} groups are not {heads} heads for each of b's {b.shape[0]} rows")
    if not _on_cuda(x):
        return _ref.ssd_chunk_intra_ref(x, a, b, c, heads)
    if not (x.dtype == b.dtype == c.dtype and x.dtype in _sc.DTYPE_CODES):
        x, b, c = _f32(x), _f32(b), _f32(c)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _sc.ssd_chunk_launch(y, x.contiguous(), _kernel_float(a), b.contiguous(), c.contiguous(), heads)
    ssd_chunk_intra.launches += 1
    return y


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk_intra_seq(x, a, b, c, chunk: int):
    """The intra-chunk SSD in the model's sequence layout: x (B, S, nh, hd),
    a (B, S, nh) log decays, b/c (B, S, N) shared by the heads, S a multiple
    of ``chunk`` -> y (B, S, nh, hd) f32, where position i of a chunk gets
    ``Σ_{j≤i} exp(cs_i - cs_j)·(c_i·b_j)·x_j`` over the chunk's positions j,
    ``cs`` the cumsum of a within the chunk, head by head. One launch of the
    kernel behind :func:`ssd_chunk_intra` (counted there), reading x, a, b
    and c where they lie (b and c may be column slices of a wider tensor):
    nothing is permuted or copied first. The same dtypes as
    :func:`ssd_chunk_intra`."""
    B, S, nh, hd = x.shape
    if S % chunk or a.shape != (B, S, nh) or b.shape[:2] != (B, S) or c.shape != b.shape:
        raise ValueError(f"x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} "
                         f"are not one sequence in chunks of {chunk}")
    if not _on_cuda(x):
        return _ref.ssd_chunk_intra_seq_ref(x, a, b, c, chunk)
    if not (x.dtype == b.dtype == c.dtype and x.dtype in _sc.DTYPE_CODES):
        x, b, c = _f32(x), _f32(b), _f32(c)
    if a.dtype not in _sc.DTYPE_CODES:
        a = a.to(torch.float32)
    x, b, c = _last_contiguous(x), _last_contiguous(b), _last_contiguous(c)
    nc = S // chunk

    def rows(t):  # (B, S, ...) -> (B·nc, chunk, ...): a view wherever the batch stride allows
        return t.unflatten(1, (nc, chunk)).flatten(0, 1)

    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=x.device)
    _sc.ssd_chunk_launch_views(rows(y).transpose(1, 2), rows(x).transpose(1, 2), rows(a).transpose(1, 2),
                               rows(b), rows(c))
    ssd_chunk_intra.launches += 1
    return y


masked_sgd_update.launches = 0
masked_adamw_update.launches = 0
fake_compress.launches = 0
fisher_diag_update.launches = 0
sparse_lora_apply.launches = 0
sparse_lora_apply_packed.launches = 0
batched_sparse_lora_apply.launches = 0
batched_sparse_lora_apply.few_row_launches = 0
batched_sparse_lora_apply.split_launches = 0
flash_attention.launches = 0
ssd_chunk_intra.launches = 0
