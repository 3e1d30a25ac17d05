"""Plain PyTorch versions of the port's kernels (ground truth for the
kernels, and the path a CPU tensor takes).

Frozen semantics (paper §4.3.2), with ``eff = mask ⊙ active``:

  sgd       p' = eff ? p - lr·g            : p
  sgd+mom   μ' = eff ? momentum·μ + g      : μ        p' = eff ? p - lr·μ' : p
  adamw     m' = eff ? b1·m + (1-b1)·g     : m
            v' = eff ? b2·v + (1-b2)·g²    : v
            p' = eff ? p - lr·(m'·m̂s/(√(v'·v̂s)+ε) + wd·p) : p

Compute is f32 and each output keeps its input's dtype, so a frozen entry
keeps its bits.
"""
from __future__ import annotations

import torch


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
