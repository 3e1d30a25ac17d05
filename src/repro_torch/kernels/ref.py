"""Plain PyTorch versions of the port's kernels (ground truth for the
kernels, and the path a CPU tensor takes).

Frozen semantics (paper §4.3.2), with ``eff = mask ⊙ active``:

  sgd       p' = eff ? p - lr·g            : p
  sgd+mom   μ' = eff ? momentum·μ + g      : μ        p' = eff ? p - lr·μ' : p
  adamw     m' = eff ? b1·m + (1-b1)·g     : m
            v' = eff ? b2·v + (1-b2)·g²    : v
            p' = eff ? p - lr·(m'·m̂s/(√(v'·v̂s)+ε) + wd·p) : p

Compute is f32 and each output keeps its input's dtype, so a frozen entry
keeps its bits. A leaf may stack k clients on its leading axis; ``active``,
``lr`` and the Adam scales are then per-client tensors shaped to broadcast
over it.

Fake compression (kernel B3), per client row of a (k, m) leaf with
``s`` the client's scale or the absmax·(1/qmax) of each 128-value group:

  y = (|x| >= thresh ?) clip(round(x·(1/s)), ±qmax)·s        r = x - y

The reference writes the group scale as ``absmax / qmax``; XLA computes a
division by a constant as a multiply by its f32 reciprocal, and the port
does the same so that its scales are the reference's bit for bit.

The public kernels of ``repro_torch.kernels.ops`` (B4-B7), in f32:

  fisher diag   fim' = γ·fim + ((1-γ)·g)·g                      (f32 out)
  sparse LoRA   y = scale·(x@a)@(b⊙mask)                        (x's dtype)
  packed        y = scale·(x@a)@b_packed, b_packed = b[:, keep]
  batched       y[m] = scale·(x[m]@a[i])@(b[i]⊙mask[i]), i = idx[m];
                zeros where i is outside [0, A)

and the attention and state-space kernels (B8, B9), in f32:

  flash attn    o = softmax(where(mask, q·kᵀ/√D, NEG_INF))·v        (q's dtype)
                mask: k ≤ q when causal, k > q - window with a window
  ssd intra     y[g,i] = Σ_{j≤i} exp(cs_i - cs_j)·(c_i·b_j)·x[g,j],
                cs = cumsum(a[g,0])                                  (f32 out)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QUANT_GROUP = 128  # values per quantization scale, the wire format's group
NEG_INF = -1e30  # the masked score and decay exponent of the JAX kernels


def inv_qmax(qmax: int) -> float:
    """``1/qmax`` rounded to f32, the factor of every quantization scale."""
    return float(np.float32(1.0) / np.float32(qmax))


def _update_pred(mask, active, device):
    """``eff`` as a bool tensor on ``device``, or None when every entry updates."""
    pred = None
    if mask is not None:
        pred = mask != 0
    if active is not None:
        a = torch.as_tensor(active, device=device) != 0
        pred = a if pred is None else pred & a
    return pred


def _selector(pred):
    if pred is None:
        return lambda new, old: new
    return lambda new, old: torch.where(pred, new, old)


def masked_sgd_update_ref(p, g, mu, mask, lr, *, momentum: float = 0.0, active=None):
    """Masked SGD(+momentum): frozen entries keep parameter AND momentum.
    ``mu`` is None without momentum. Returns ``(new_p, new_mu)``."""
    pf = p.to(torch.float32)
    gf = g.to(torch.float32)
    sel = _selector(_update_pred(mask, active, p.device))
    if momentum:
        muf = mu.to(torch.float32)
        mu_new = sel(momentum * muf + gf, muf)
        return sel(pf - lr * mu_new, pf).to(p.dtype), mu_new.to(mu.dtype)
    return sel(pf - lr * gf, pf).to(p.dtype), None


def masked_adamw_update_ref(p, g, m, v, mask, lr, mhat_scale, vhat_scale, *,
                            b1=0.9, b2=0.999, eps=1e-8, wd=0.0, active=None):
    """Masked AdamW with held moments under the mask. The bias-correction
    scales come from the step counter, held outside. Returns (p', m', v')."""
    pf = p.to(torch.float32)
    gf = g.to(torch.float32)
    mf = m.to(torch.float32)
    vf = v.to(torch.float32)
    sel = _selector(_update_pred(mask, active, p.device))
    m_new = sel(b1 * mf + (1.0 - b1) * gf, mf)
    v_new = sel(b2 * vf + (1.0 - b2) * gf * gf, vf)
    step = lr * (m_new * mhat_scale) / (torch.sqrt(v_new * vhat_scale) + eps)
    if wd:
        step = step + lr * wd * pf
    return sel(pf - step, pf).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def fake_compress_ref(x, thresh, scale, *, qmax: int = 0, use_thresh: bool = False,
                      per_leaf_scale: bool = False):
    """Fake-quantize / top-k round trip with error feedback.

    ``x`` (k, m): k clients' flattened leaves. ``thresh``/``scale`` (k,) f32:
    each client's top-k threshold and per-leaf scale, read only by the top-k
    (``use_thresh`` / ``per_leaf_scale``) variants. int8/int4 (``qmax``
    127/7) take one scale, absmax·(1/qmax), per 128 consecutive values of
    each client's row, the last group short when ``m % 128``. Returns ``(y, x - y)`` in
    ``x.dtype``, the difference taken in f32 before ``y`` is cast.
    """
    xf = x.to(torch.float32)
    k, m = xf.shape
    if qmax:
        if per_leaf_scale:
            s = scale.to(torch.float32).reshape(k, 1)
        else:
            groups = -(-m // QUANT_GROUP)
            padded = F.pad(xf, (0, groups * QUANT_GROUP - m)).reshape(k, groups, QUANT_GROUP)
            s = torch.amax(torch.abs(padded), dim=-1, keepdim=True) * inv_qmax(qmax)
            s = s.expand(k, groups, QUANT_GROUP).reshape(k, groups * QUANT_GROUP)[:, :m]
        safe = torch.where(s > 0.0, s, 1.0)
        inv = torch.where(s > 0.0, 1.0 / safe, 0.0)
        y = torch.clamp(torch.round(xf * inv), -qmax, qmax) * s
    else:
        y = xf
    if use_thresh:
        y = torch.where(torch.abs(xf) >= thresh.reshape(k, 1), y, 0.0)
    return y.to(x.dtype), (xf - y).to(x.dtype)


def fisher_diag_update_ref(g, fim, momentum: float):
    """Momentum diag-FIM update (kernel B4): ``γ·fim + ((1-γ)·g)·g`` in f32,
    f32 out whatever the inputs' float dtypes."""
    gf = g.to(torch.float32)
    return momentum * fim.to(torch.float32) + (1.0 - momentum) * gf * gf


def sparse_lora_matmul_ref(x, a, b, mask, scale: float = 1.0):
    """Neuron-masked LoRA product (kernel B5): ``scale·(x@a)@(b⊙mask)``.
    x (M, K); a (K, r); b (r, N); mask (N,). f32 compute, ``x.dtype`` out."""
    xa = x.to(torch.float32) @ a.to(torch.float32)
    bm = b.to(torch.float32) * mask.to(torch.float32)[None, :]
    return (scale * (xa @ bm)).to(x.dtype)


def sparse_lora_matmul_packed_ref(x, a, b_packed, scale: float = 1.0):
    """Dense product on gather-packed ``b`` (kernel B6): the columns are
    already restricted to the kept set, so this equals the masked product's
    kept columns."""
    xa = x.to(torch.float32) @ a.to(torch.float32)
    return (scale * (xa @ b_packed.to(torch.float32))).to(x.dtype)


def sparse_lora_apply_packed_ref(x, a, b, mask, scale: float = 1.0):
    """The whole gather-packed apply (kernel B6 with the JAX wrapper's
    steps): gather the kept columns of ``b`` (mask != 0), the dense product
    on them, scattered into zeros of ``(M, N)``. Frozen columns are exact
    zeros whatever ``b`` holds there."""
    keep = torch.nonzero(mask.reshape(-1)).reshape(-1)
    y = torch.zeros((x.shape[0], b.shape[1]), dtype=x.dtype, device=x.device)
    y[:, keep] = sparse_lora_matmul_packed_ref(x, a, b[:, keep], scale)
    return y


def batched_sparse_lora_matmul_ref(x, idx, a, b, mask, scale: float = 1.0):
    """Multi-adapter product (kernel B7): ``y[m] = scale·(x[m]@a[idx[m]])
    @(b[idx[m]]⊙mask[idx[m]])``. x (M, K); idx (M,) int; a (A, K, r);
    b (A, r, N); mask (A, N).

    A row whose ``idx[m]`` lies outside ``[0, A)`` comes out as zeros, as
    the TPU kernel gives it (it matches no adapter). This departs from the
    JAX package's jnp oracle, whose gather clamps the index.
    """
    n_adapters = a.shape[0]
    idx = idx.to(torch.int64)
    valid = (idx >= 0) & (idx < n_adapters)
    safe = torch.where(valid, idx, 0)
    xa = torch.einsum("mk,mkr->mr", x.to(torch.float32), a.to(torch.float32)[safe])
    bm = (b.to(torch.float32) * mask.to(torch.float32)[:, None, :])[safe]
    y = scale * torch.einsum("mr,mrn->mn", xa, bm)
    return torch.where(valid[:, None], y, 0.0).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0):
    """Exact softmax attention on (BH, S, D) (kernel B8's function): scores
    and softmax in f32, masked entries set to ``NEG_INF``, out in q's dtype.

    ``q`` may hold only the rows at positions ``q_offset, q_offset + 1, ...``
    of the sequence that k and v hold whole, so that a long sequence can be
    checked a slice of rows at a time."""
    Sq, D = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32)) / (D ** 0.5)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_gqa_ref(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0):
    """The plain version of ``ops.flash_attention``: q (B, Sq, H, D), k/v
    (B, Sk, KVH, D), heads folded as the JAX wrapper folds them (k and v
    repeated for each query head of their group), then
    :func:`flash_attention_ref`. Returns q-shaped, in q's dtype."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, t.shape[1], D)  # noqa: E731
    out = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window, q_offset=q_offset)
    return out.reshape(B, H, Sq, D).transpose(1, 2)


def ssd_chunk_intra_ref(x, a, b, c, heads: int = 1):
    """Intra-chunk SSD (kernel B9): x (G, Q, hd), a (G, 1, Q) log decays,
    b/c (G / heads, Q, N), group g reading row g // heads -> (G, Q, hd) f32,
    f32 throughout."""
    cs = torch.cumsum(a[:, 0].to(torch.float32), dim=-1)  # (G, Q)
    diff = cs[:, :, None] - cs[:, None, :]
    G, Q, hd = x.shape
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None], diff, NEG_INF)).reshape(G // heads, heads, Q, Q)
    scores = torch.einsum("gis,gjs->gij", c.to(torch.float32), b.to(torch.float32))
    y = torch.einsum("ghij,ghjd->ghid", L * scores[:, None], x.to(torch.float32).reshape(G // heads, heads, Q, hd))
    return y.reshape(G, Q, hd)


def ssd_chunk_intra_seq_ref(x, a, b, c, chunk: int):
    """The plain version of ``ops.ssd_chunk_intra_seq``: x (B, S, nh, hd), a
    (B, S, nh), b/c (B, S, N) -> (B, S, nh, hd) f32, through
    :func:`ssd_chunk_intra_ref` on the chunks' groups (batch, chunk, head),
    the heads of a chunk sharing its b and c."""
    B, S, nh, hd = x.shape
    nc, N = S // chunk, b.shape[-1]
    xg = x.reshape(B, nc, chunk, nh, hd).permute(0, 1, 3, 2, 4).reshape(B * nc * nh, chunk, hd)
    ag = a.reshape(B, nc, chunk, nh).permute(0, 1, 3, 2).reshape(B * nc * nh, 1, chunk)
    y = ssd_chunk_intra_ref(xg, ag, b.reshape(B * nc, chunk, N), c.reshape(B * nc, chunk, N), heads=nh)
    return y.reshape(B, nc, nh, chunk, hd).permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd)
