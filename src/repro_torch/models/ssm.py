"""Mamba2 (SSD, state-space duality) blocks, in PyTorch (port of
``repro.models.ssm``). [arXiv:2405.21060]

Train/prefill uses the chunked SSD algorithm: quadratic attention-like
computation *within* chunks of length Q plus a linear recurrence over chunk
states. Decode is the pure recurrence with a constant-size state
(B, nh, hd, N). The B/C projections are shared across heads (a single
group, as in the paper).

The training forward (:func:`mamba2_block`) is plain PyTorch, as the JAX
package's is. Serving's prefill (:func:`mamba2_prefill`) computes the
intra-chunk term on the card with the hand-written kernel (B9,
``repro_torch.kernels.ops.ssd_chunk_intra_seq``: x, the decays, b and c read
where the mixer holds them), the heads sharing one b and c per chunk; on
the CPU it runs the same einsums as training. The inter-chunk
recurrence stays in PyTorch.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import init_stacked_dense, linear, rms_norm

NEG_INF = -1e30


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    nheads = s.num_heads(cfg.d_model)
    conv_ch = d_inner + 2 * s.d_state
    in_dim = 2 * d_inner + 2 * s.d_state + nheads  # z, x, B, C, dt
    return dict(d_inner=d_inner, nheads=nheads, conv_ch=conv_ch, in_dim=in_dim)


def init_ssm_layers(gen: torch.Generator, n_layers: int, cfg: ModelConfig, dtype, device):
    """Stacked Mamba2 mixer weights with the JAX package's distributions,
    drawn from ``gen`` (a generator on ``device``): dense projections
    N(0, 1/d_in), a depthwise conv N(0, 1/W), A = 1..16 over the heads
    (``A_log`` its log), dt log-uniform in [1e-3, 0.1] with ``dt_bias`` its
    inverse softplus, D = 1. ``A_log``, ``D`` and ``dt_bias`` stay f32."""
    s = cfg.ssm
    dims = ssm_dims(cfg)
    nh = dims["nheads"]
    in_proj = init_stacked_dense(gen, n_layers, cfg.d_model, dims["in_dim"], dtype, device)
    conv_w = torch.randn((n_layers, s.conv_width, dims["conv_ch"]), generator=gen, device=device)
    u = torch.rand((n_layers, nh), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    out_proj = init_stacked_dense(gen, n_layers, dims["d_inner"], cfg.d_model, dtype, device)
    A = torch.linspace(1.0, 16.0, nh, device=device)[None].repeat(n_layers, 1)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(s.conv_width)).to(dtype),
        "A_log": torch.log(A),
        "D": torch.ones((n_layers, nh), dtype=torch.float32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "gate_norm_w": torch.ones((n_layers, dims["d_inner"]), dtype=dtype, device=device),
        "out_proj": out_proj,
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``logaddexp(x, 0)``, JAX's formula: unlike
    ``F.softplus`` it does not return x itself above a threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


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
    *,
    kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, S, nh, hd) f32, final_state (B, nh, hd, N) f32).

    With ``kernel`` the intra-chunk term of CUDA tensors is the B9 kernel
    (:func:`ssd_intra`); without it, or on the CPU, the plain einsums.
    """
    B, S, nh, hd = x.shape
    N = b.shape[-1]
    if S % chunk:
        # zero-pad the tail: x = 0 adds nothing to the states, a = 0 decays
        # nothing, and the padded outputs are sliced off
        pad = chunk - S % chunk
        y, state = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad)),
                               F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)), chunk, initial_state,
                               kernel=kernel)
        return y[:, :S], state
    nc = S // chunk
    xf = x.to(torch.float32).reshape(B, nc, chunk, nh, hd)
    af = a.to(torch.float32).reshape(B, nc, chunk, nh)
    bf = b.to(torch.float32).reshape(B, nc, chunk, N)
    cf = c.to(torch.float32).reshape(B, nc, chunk, N)

    # intra-chunk (quadratic within the chunk)
    if kernel and x.is_cuda:
        y_intra = ssd_intra(x, af, b, c, chunk)
    else:
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


def ssd_intra(x: torch.Tensor, af: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The intra-chunk term as one B9 launch: x (B, S, nh, hd) in its own
    dtype, af (B, nc, Q, nh) f32 log decays, b/c (B, S, N) -> (B, nc, Q, nh,
    hd) f32. The kernel reads x, the decays, b and c where they lie (b and c
    are column slices of the conv's output), the heads of a chunk sharing
    its b and c: nothing is copied before the launch."""
    B, S, nh, hd = x.shape
    y = kops.ssd_chunk_intra_seq(x, af.reshape(B, S, nh), b, c, chunk)
    return y.reshape(B, S // chunk, chunk, nh, hd)


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


def _channels(t: torch.Tensor, cfg: ModelConfig, first: int, count: int) -> torch.Tensor:
    """The conv channels of heads ``[first, first + count)`` along ``t``'s
    last dim (conv_ch wide): their x channels, then B and C."""
    dims = ssm_dims(cfg)
    if count == dims["nheads"]:
        return t
    hd, di = cfg.ssm.head_dim, dims["d_inner"]
    return torch.cat([t[..., first * hd : (first + count) * hd], t[..., di:]], dim=-1)


def _core(cfg: ModelConfig, zxbcdt, p, first: int, count: int, conv_buf, state, *, kernel: bool = False):
    """The mixer between its two projections over heads ``[first, first +
    count)``: ``zxbcdt`` is ``in_proj``'s whole output ``[z | x | B | C |
    dt]``, (B, S, in_dim) over a sequence (``conv_buf`` None: the chunked
    scan, B9 on the card with ``kernel``) or (B, in_dim) for one decode step
    against ``conv_buf`` (B, W-1, conv_ch) and the heads' ``state``; ``p``
    holds conv_w, A_log, D and dt_bias for every head. Returns ``(y, z)``
    (..., count·hd) in the model dtype, the conv's window over every
    channel (a sequence: its last W-1 inputs, zeros before its start; a
    step: the W inputs) and the heads' final state (B, count, hd, N) f32."""
    s = cfg.ssm
    dims = ssm_dims(cfg)
    di, hd, N = dims["d_inner"], s.head_dim, s.d_state
    ci = di + dims["conv_ch"]
    z = zxbcdt[..., first * hd : (first + count) * hd]
    xbc_all = zxbcdt[..., di:ci]
    dt = zxbcdt[..., ci + first : ci + first + count]
    conv_w = _channels(p["conv_w"], cfg, first, count)
    if conv_buf is None:
        S = zxbcdt.shape[1]
        window = F.pad(xbc_all, (0, 0, s.conv_width - 1, 0))[:, S:]
        conv_out = causal_conv1d(_channels(xbc_all, cfg, first, count), conv_w)
    else:
        window = torch.cat([conv_buf, xbc_all[:, None]], dim=1)  # (B, W, ch)
        conv_out = torch.einsum("bwc,wc->bc", _channels(window, cfg, first, count), conv_w.to(window.dtype))
    xbc = F.silu(conv_out.to(torch.float32)).to(zxbcdt.dtype)
    n = count * hd
    x, b, c = xbc[..., :n], xbc[..., n : n + N], xbc[..., n + N :]
    heads = slice(first, first + count)
    dtf = softplus(dt.to(torch.float32) + p["dt_bias"][heads])  # (..., count)
    A = -torch.exp(p["A_log"][heads])  # (count,)
    xh = x.reshape(*x.shape[:-1], count, hd)
    if conv_buf is None:
        y, state = ssd_chunked(xh * dtf[..., None].to(xh.dtype), A * dtf, b, c, s.chunk_size, kernel=kernel)
    else:
        y, state = ssd_decode_step(xh * dtf[..., None].to(xh.dtype), A * dtf, b, c, state)
    y = y + p["D"][heads][:, None] * xh.to(torch.float32)
    return y.reshape(*y.shape[:-2], n).to(zxbcdt.dtype), z, window, state


def _gated_out(y, z, h, p, lora, lora_scale):
    """The gated RMSNorm on ``y · silu(z)`` in the model dtype, then the
    out-projection."""
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(h.dtype), p["gate_norm_w"])
    return linear(y, {"w": p["out_proj"]}, lora.get("out_proj") if lora else None, lora_scale)


def _mixer(h, p, cfg: ModelConfig, lora, lora_scale, *, kernel: bool, cache=None):
    """The Mamba2 mixer over a sequence (``cache`` None) or one decode step
    against ``cache`` = (conv_buf, state): ``(out, conv window, state)``.
    Its core runs on each rank's heads on a tensor-parallel mesh
    (:func:`sharding_ctx.local_ssm`)."""
    zxbcdt = linear(h, {"w": p["in_proj"]}, lora.get("in_proj") if lora else None, lora_scale)
    y, z, window, state = sharding_ctx.local_ssm(functools.partial(_core, cfg, kernel=kernel), zxbcdt, p,
                                                 ssm_dims(cfg)["nheads"], *(cache or (None, None)))
    return _gated_out(y, z, h, p, lora, lora_scale), window, state


def mamba2_block(h: torch.Tensor, p, cfg: ModelConfig, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
    """The full Mamba2 mixer on the training path (plain PyTorch). h: (B,
    S, D), already normed; p: one layer's params. Returns (B, S, D)."""
    return _mixer(h, p, cfg, lora, lora_scale, kernel=False)[0]


def mamba2_prefill(h, p, cfg: ModelConfig, lora=None, lora_scale: float = 1.0):
    """:func:`mamba2_block` that also returns ``(conv_tail (B, W-1,
    conv_ch), final_state (B, nh, hd, N) f32)`` for the cache; on the card
    the intra-chunk term is the B9 kernel."""
    out, conv_tail, state = _mixer(h, p, cfg, lora, lora_scale, kernel=True)
    return out, (conv_tail, state)


def mamba2_decode(h, p, cfg: ModelConfig, cache, lora=None, lora_scale: float = 1.0):
    """One-token step. h: (B, 1, D); cache: (conv_buf (B, W-1, conv_ch),
    state (B, nh, hd, N) f32). Returns (out (B, 1, D), (conv_buf, state))."""
    out, window, state = _mixer(h[:, 0], p, cfg, lora, lora_scale, kernel=False, cache=cache)
    return out[:, None], (window[:, 1:], state)
