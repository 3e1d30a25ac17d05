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
