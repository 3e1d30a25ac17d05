"""Tree wrappers around the port's kernels.

Each wrapper walks a LoRA tree leaf by leaf and dispatches on the leaf's
device alone: a CUDA tensor goes to the hand-written kernel (which raises
if it cannot launch), a CPU tensor to the plain version in
:mod:`repro_torch.kernels.ref`. Each wrapper carries a ``launches`` count,
raised by one for every kernel launch and by nothing else.

The updates are functional: new tensors come back and the inputs are left
as they were, on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import masked_update as _mu
from repro_torch.kernels import ref as _ref
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unzip


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


def _masks(mask, params):
    return mask if mask is not None else tree_map(lambda _: None, params)


def masked_sgd_update(grads, state, params, lr, mask=None, active=None, *, momentum: float = 0.0):
    """Masked SGD(+momentum) over a tree, one kernel launch per CUDA leaf.

    Same signature and frozen-moment semantics as
    :func:`repro_torch.optim.optimizers.sgd_update`: entries with
    ``mask == 0``, and every entry when ``active == 0``, keep parameter AND
    momentum bit for bit.
    """
    device = tree_leaves(params)[0].device
    lr_t = as_f32(lr, device)
    zero = as_f32(0.0, device)
    scal = torch.stack([lr_t, _active_f32(active, device), zero, zero])

    def one(p, g, mu, mk):
        if _on_cuda(p):
            p_out = torch.empty_like(p)
            mu_out = torch.empty_like(mu) if momentum else None
            _mu.sgd_launch(p_out, p, g, mu_out, mu if momentum else None, mk, scal,
                           momentum=momentum)
            masked_sgd_update.launches += 1
            return p_out, mu_out
        return _ref.masked_sgd_update_ref(p, g, mu if momentum else None, mk, lr_t,
                                          momentum=momentum, active=active)

    mus = state["mu"] if momentum else tree_map(lambda _: None, params)
    new_params, new_mu = tree_unzip(tree_map(one, params, grads, mus, _masks(mask, params)), 2)
    if momentum:
        return new_params, {"mu": new_mu}
    return new_params, state


def masked_adamw_update(grads, state, params, lr, mask=None, active=None, *,
                        b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """Masked AdamW over a tree, one kernel launch per CUDA leaf.

    Same contract as :func:`repro_torch.optim.optimizers.adamw_update`:
    frozen entries hold parameter, ``m`` and ``v`` bit for bit, and the step
    counter ``t`` advances only on active steps. The bias-correction scales
    are computed from ``t`` once, on the device, and shared by every leaf.
    """
    t, mhat, vhat = adam_step_scales(state["t"], active, b1, b2)
    device = t.device
    lr_t = as_f32(lr, device)
    scal = torch.stack([lr_t, _active_f32(active, device), mhat, vhat])

    def one(p, g, m, v, mk):
        if _on_cuda(p):
            p_out, m_out, v_out = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
            _mu.adamw_launch(p_out, p, g, m_out, m, v_out, v, mk, scal,
                             b1=b1, b2=b2, eps=eps, wd=wd)
            masked_adamw_update.launches += 1
            return p_out, m_out, v_out
        return _ref.masked_adamw_update_ref(p, g, m, v, mk, lr_t, mhat, vhat,
                                            b1=b1, b2=b2, eps=eps, wd=wd, active=active)

    outs = tree_map(one, params, grads, state["m"], state["v"], _masks(mask, params))
    new_params, m, v = tree_unzip(outs, 3)
    return new_params, {"m": m, "v": v, "t": t}


masked_sgd_update.launches = 0
masked_adamw_update.launches = 0
