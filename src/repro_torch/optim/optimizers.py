"""Masked SGD / AdamW over LoRA trees (port of ``repro.optim.optimizers``).

``make_optimizer`` returns ``(init_fn, update_fn)`` where
``update_fn(grads, state, params, lr, mask=None, active=None)`` applies an
optional FibecFed update mask (0/1 tree) and an optional per-step ``active``
predicate (0/1 scalar). Frozen entries (``mask == 0``, or every entry when
``active == 0``) receive no update and their moments are held bit for bit
(paper §4.3.2): the update commits per entry, ``new = eff ? updated : old``
with ``eff = mask ⊙ active``. AdamW's step counter ``t`` advances only on
active steps.

Stacked clients (the vectorized engine) pass ``active`` of shape (k,): every
leaf then carries k clients on its leading axis, each committed by its own
predicate, and AdamW's ``t`` is (k,), one counter per client, as JAX's vmap
of the update gives each client.

``fused=True`` routes every leaf through the hand-written masked-update
kernels (:mod:`repro_torch.kernels.ops`); the functions below are the
semantic spec and the unfused path.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from repro_torch.kernels import ops as _kops
from repro_torch.utils.tree import tree_leaves, tree_map, tree_zeros_like


def _commit(new, old, mask_leaf, active):
    """``eff = mask ⊙ active`` entry-wise commit; ``None`` means all-on."""
    if mask_leaf is None and active is None:
        return new
    active = _kops.per_client(active, new)
    if mask_leaf is None:
        pred = torch.as_tensor(active, device=new.device) != 0
    elif active is None:
        pred = mask_leaf != 0
    else:
        pred = (mask_leaf != 0) & (torch.as_tensor(active, device=new.device) != 0)
    return torch.where(pred, new, old)


def _masks(mask, params):
    return mask if mask is not None else tree_map(lambda _: None, params)


def sgd_init(params, momentum: float = 0.0):
    if momentum:
        return {"mu": tree_zeros_like(params)}
    return {}


def sgd_update(grads, state, params, lr, mask=None, active=None, *, momentum: float = 0.0):
    masks = _masks(mask, params)
    if momentum:
        mu = tree_map(lambda m, g, mk: _commit(momentum * m + g, m, mk, active),
                      state["mu"], grads, masks)
        new_params = tree_map(lambda p, d, mk: _commit(p - lr * d, p, mk, active),
                              params, mu, masks)
        return new_params, {"mu": mu}
    new_params = tree_map(lambda p, g, mk: _commit(p - lr * g, p, mk, active),
                          params, grads, masks)
    return new_params, state


def adamw_init(params):
    """Zero moments in the params' dtype and an int32 step counter."""
    return {
        "m": tree_zeros_like(params),
        "v": tree_zeros_like(params),
        "t": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def adamw_update(grads, state, params, lr, mask=None, active=None, *,
                 b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    if active is None:
        inc = 1
    else:
        inc = (torch.as_tensor(active, device=state["t"].device) != 0).to(torch.int32)
    t = state["t"] + inc
    masks = _masks(mask, params)
    m = tree_map(lambda mm, g, mk: _commit(b1 * mm + (1 - b1) * g, mm, mk, active),
                 state["m"], grads, masks)
    # (1-b2)·g·g in the masked-update kernel's operation order (the JAX
    # package's unfused path squares first, an ulp away), so that fused and
    # unfused updates are the same arithmetic
    v = tree_map(lambda vv, g, mk: _commit(b2 * vv + (1 - b2) * g * g, vv, mk, active),
                 state["v"], grads, masks)
    mhat_scale = 1.0 / (1 - b1 ** t.to(torch.float32))
    vhat_scale = 1.0 / (1 - b2 ** t.to(torch.float32))
    lr_t = _kops.as_f32(lr, t.device)

    def upd(p, mm, vv, mk):
        mhs, vhs = _kops.per_client(mhat_scale, p), _kops.per_client(vhat_scale, p)
        step = lr_t * (mm * mhs) / (torch.sqrt(vv * vhs) + eps)
        if wd:
            step = step + lr_t * wd * p
        return _commit(p - step, p, mk, active)

    new_params = tree_map(upd, params, m, v, masks)
    return new_params, {"m": m, "v": v, "t": t}


def make_optimizer(name: str, fused=False, **kw) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, update_fn)`` for a masked local optimizer.

    Args:
      name: ``"sgd"`` or ``"adamw"``.
      fused: ``False`` uses the tree implementations above. ``True`` (and
        ``"force"``, kept for the JAX package's callers) sends every leaf
        through the masked-update kernels: on the card the hand-written
        CUDA kernel, on the CPU its plain version.
      **kw: ``momentum`` (sgd, default 0.0); ``b1``/``b2``/``eps``/
        ``weight_decay`` (adamw, defaults 0.9/0.999/1e-8/0.0).
    """
    if name == "sgd":
        momentum = kw.get("momentum", 0.0)
        if fused:
            upd = functools.partial(_kops.masked_sgd_update, momentum=momentum)
        else:
            upd = functools.partial(sgd_update, momentum=momentum)
        return (lambda p: sgd_init(p, momentum), upd)
    if name == "adamw":
        hyper = dict(
            b1=kw.get("b1", 0.9),
            b2=kw.get("b2", 0.999),
            eps=kw.get("eps", 1e-8),
            wd=kw.get("weight_decay", 0.0),
        )
        upd = functools.partial(_kops.masked_adamw_update if fused else adamw_update, **hyper)
        return adamw_init, upd
    raise ValueError(name)
