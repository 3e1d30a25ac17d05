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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QUANT_GROUP = 128  # values per quantization scale, the wire format's group


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
