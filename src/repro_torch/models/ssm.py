"""Mamba2 SSD (state-space duality) math, in plain PyTorch (port of the
framework-free part of ``repro.models.ssm``). [arXiv:2405.21060]

Train/prefill uses the chunked SSD algorithm: quadratic attention-like
computation *within* chunks of length Q plus a linear recurrence over chunk
states. Decode is the pure recurrence with a constant-size state
(B, nh, hd, N). The B/C projections are shared across heads (a single
group, as in the paper).

Like the JAX module, this one calls no kernel: the hand-written intra-chunk
kernel (B9) is reached through ``repro_torch.kernels.ops.ssd_chunk_intra``
and is held against :func:`ssd_chunked` at one chunk. The SSM block, its
initializer and the SSM model are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + x.shape[1]] * w[i].to(x.dtype)
    return out


def segsum_decay(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> L: (..., Q, Q) with L[i,j] = exp(Σ_{j<k≤i} a_k)."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # cs_i - cs_j
    Q = a.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.exp(torch.where(mask, diff, NEG_INF))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, nh, hd), already including the dt factor
    a: torch.Tensor,  # (B, S, nh) log decay per step (A·dt, negative)
    b: torch.Tensor,  # (B, S, N)
    c: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, S, nh, hd) f32, final_state (B, nh, hd, N) f32)."""
    B, S, nh, hd = x.shape
    N = b.shape[-1]
    if S % chunk:
        # zero-pad the tail: x = 0 adds nothing to the states, a = 0 decays
        # nothing, and the padded outputs are sliced off
        pad = chunk - S % chunk
        y, state = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad)),
                               F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)), chunk, initial_state)
        return y[:, :S], state
    nc = S // chunk
    xf = x.to(torch.float32).reshape(B, nc, chunk, nh, hd)
    af = a.to(torch.float32).reshape(B, nc, chunk, nh)
    bf = b.to(torch.float32).reshape(B, nc, chunk, N)
    cf = c.to(torch.float32).reshape(B, nc, chunk, N)

    # intra-chunk (quadratic within the chunk)
    L = segsum_decay(af.transpose(-1, -2))  # (B, nc, nh, Q, Q)
    scores = torch.einsum("bkis,bkjs->bkij", cf, bf)  # (B, nc, Q, Q), shared by the heads
    y_intra = torch.einsum("bkhij,bkij,bkjhd->bkihd", L, scores, xf)

    # chunk states: S_c = Σ_j exp(total - cs_j)·x_j ⊗ b_j
    cs = torch.cumsum(af, dim=2)  # (B, nc, Q, nh)
    total = cs[:, :, -1]  # (B, nc, nh)
    decay_to_end = torch.exp(total[:, :, None] - cs)
    states = torch.einsum("bkjh,bkjs,bkjhd->bkhds", decay_to_end, bf, xf)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(total)  # (B, nc, nh)
    carry = (torch.zeros((B, nh, hd, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.to(torch.float32))
    prev = []
    for k in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, nh, hd, N)

    # inter-chunk output: y_i += exp(cs_i)·c_i · state_prev
    y_inter = torch.einsum("bkih,bkis,bkhds->bkihd", torch.exp(cs), cf, prev_states)
    return (y_intra + y_inter).reshape(B, S, nh, hd), carry


def ssd_decode_step(
    x: torch.Tensor,  # (B, nh, hd), including the dt factor
    a: torch.Tensor,  # (B, nh) log decay
    b: torch.Tensor,  # (B, N)
    c: torch.Tensor,  # (B, N)
    state: torch.Tensor,  # (B, nh, hd, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. Returns (y (B, nh, hd), new_state)."""
    xf, af = x.to(torch.float32), a.to(torch.float32)
    bf, cf = b.to(torch.float32), c.to(torch.float32)
    new_state = state * torch.exp(af)[..., None, None] + torch.einsum("bhd,bn->bhdn", xf, bf)
    y = torch.einsum("bhdn,bn->bhd", new_state, cf)
    return y, new_state
