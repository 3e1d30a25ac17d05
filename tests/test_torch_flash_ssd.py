"""The port's flash attention (B8), SSD intra-chunk scan (B9) and chunked
SSD agree with the JAX package's.

``repro_torch.kernels.ops.flash_attention`` / ``ssd_chunk_intra`` against
``repro.kernels.ops``, and ``repro_torch.models.ssm`` against
``repro.models.ssm``, on the same inputs made from a seed with numpy. The
JAX side runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does (a ragged S goes to its dense oracle there);
the port's side gets CPU tensors and so takes the plain versions
(``kernels/ref.py``), which the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, tighter than the JAX tests' own (2e-3 for attention, 1e-4 for
SSD):
- attention: an output row is a convex combination of v's rows, and the
  scores, exponentials and sums run in another order on each side, so f32
  outputs agree within 1e-5 of the largest |v|; bf16 outputs round those
  f32 values, so they agree to that plus one bf16 ulp.
- SSD: the cumulative sums, the products c·b and the sums over j and over
  the state run in another order (and, in ``ssd_chunked``, through
  differently associated einsums), so f32 outputs and states agree within
  1e-5 of their largest magnitude; bf16 inputs are widened exactly, so
  the same holds for them.
"""
import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as tsc
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from torch_jax_refs import release_jax_programs  # noqa: F401

REL = 1e-5


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    n = np.asarray(j)
    if n.dtype.name == "bfloat16":
        return j, torch.from_numpy(n.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return j, torch.from_numpy(np.array(n))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _assert_close(port, want, scale, bf16=False):
    """Within ``REL · scale``; bf16 outputs one ulp of the larger value beyond."""
    p, w = _np(port), _np(want)
    assert p.shape == w.shape
    allowed = REL * scale
    if bf16:
        _, e = np.frexp(np.maximum(np.abs(p), np.abs(w)))
        allowed = allowed + np.ldexp(1.0, e - 8)
    excess = np.abs(p - w) - allowed
    assert np.all(excess <= 0), f"beyond tolerance by up to {excess.max()}"


def _qkv(seed, B, S, H, KVH, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, D), dtype=np.float32)
    return [_pair(t, dtype) for t in (q, k, v)]


def _check_flash(seed, B, S, H, KVH, D, *, causal=True, window=None, dtype="float32"):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(seed, B, S, H, KVH, D, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_close(got, want, float(np.max(np.abs(_np(tv)))), bf16=dtype == "bfloat16")


@pytest.mark.parametrize("S,H,KVH,D", [(128, 4, 4, 64), (256, 4, 2, 64), (256, 8, 1, 128)])
@pytest.mark.parametrize("window", [None, 128])
def test_flash_attention_matches_jax(S, H, KVH, D, window):
    _check_flash(S + H + KVH + D, 2, S, H, KVH, D, window=window)


@pytest.mark.parametrize("S", [100, 200])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_ragged_matches_jax(S, window):
    # JAX sends S % 128 != 0 to its dense oracle; the port's kernel masks it
    _check_flash(S, 2, S, 4, 2, 64, window=window)


@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_bf16_matches_jax(window):
    _check_flash(7, 2, 256, 4, 2, 64, window=window, dtype="bfloat16")


@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_not_causal_matches_jax(window):
    _check_flash(11, 2, 256, 4, 2, 64, causal=False, window=window)


def key_tile(D):
    """The card's bf16 kernel's keys a K/V tile: 128 up to D 128, 64 at D
    256 (where the output accumulator takes 128 registers a thread)."""
    return 128 if D <= 128 else 64


def _tensor_core_emulation(q, k, v, *, causal, window):
    """The arithmetic of the card's bf16 flash-attention kernel, in torch:
    raw scores as sums in f32 of exact bf16 products, the online softmax
    over the kernel's key tiles (``key_tile``, aligned to multiples of
    their width from key 0, as the kernel's are) on the raw row max m, with
    p = 2^(s·c - m·c) for c = scale·log2(e) (one fma: s·c exact, one
    rounding; m·c taken as 0 while a row has no real score) and
    alpha = 2^((m_old - m)·c), each f32 p split into hi = bf16(p) and
    lo = bf16(p - hi) with hi·v + lo·v summed in f32, and l the sum of the
    f32 p's. D 80 and 112, padded to 128 columns in the kernel's shared
    memory, add only exact zero products there, so they take the same
    arithmetic."""
    B, S, H, D = q.shape
    tile = key_tile(D)
    qf, kf, vf = (t.to(torch.float32).repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))
    c = np.float32(np.float32(np.float32(1.0) / np.sqrt(np.float32(D))) * np.float32(1.4426950408889634))
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    pos = torch.arange(S)
    for k0 in range(0, S, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        kp, qp = pos[None, k0:k0 + tile], pos[:, None]
        ok = torch.ones_like(kp <= qp)
        if causal:
            ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & (kp > qp - window)
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * float(c))
        mc = torch.where(m_new == -1e30, 0.0, m_new * float(c))
        # fma(s, c, -mc): the product exact in f64, one rounding to f32
        p = torch.exp2((s.double() * float(c) - mc.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).to(torch.float32)
        lo = (p - hi).to(torch.bfloat16).to(torch.float32)
        vt = vf[:, :, k0:k0 + tile]
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("S,H,KVH,D,causal,window", [
    (128, 4, 4, 64, True, None), (128, 4, 4, 64, True, 128), (256, 4, 2, 64, True, None),
    (256, 4, 2, 64, True, 128), (256, 8, 1, 128, True, None), (256, 8, 1, 128, True, 128),
    (100, 4, 2, 64, True, None), (200, 4, 2, 64, True, 64), (256, 4, 2, 64, False, None),
    (256, 4, 2, 64, False, 64),
    # paligemma-3b's head_dim 256 over one KV head, causal and bidirectional
    (256, 8, 1, 256, True, None), (100, 4, 1, 256, False, None),
    # D 80 and 112 (padded in the kernel's shared memory), ragged S, windows
    # that cut a 128-key tile (1, 63, 129), GQA ratios 7 and 8, bidirectional
    (256, 4, 4, 80, True, None), (1000, 4, 4, 80, False, None), (100, 4, 4, 80, True, 1),
    (256, 4, 4, 112, True, None), (200, 4, 2, 112, True, 63), (200, 4, 4, 112, False, None),
    (1000, 7, 1, 64, True, None), (200, 14, 2, 64, True, 1), (1000, 8, 1, 128, True, 129),
    (256, 8, 1, 64, False, 63), (100, 8, 1, 256, True, 63), (200, 16, 2, 256, False, 129),
])
def test_flash_tensor_core_arithmetic_matches_jax(S, H, KVH, D, causal, window):
    """The hi/lo split of p keeps the bf16 kernel within the unchanged bf16
    tolerance of the JAX package's flash attention (Pallas interpret mode;
    its dense oracle at a ragged S), before any card runs it."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(S + 13 * H + D, 2, S, H, KVH, D, "bfloat16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = _tensor_core_emulation(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, float(np.max(np.abs(_np(tv)))), bf16=True)


def test_flash_matches_model_blockwise():
    (_, q), (_, k), (_, v) = _qkv(3, 2, 256, 4, 2, 64)
    got = tops.flash_attention(q, k, v, causal=True)
    want = tattn.blockwise_attention(q, k, v, causal=True, q_block=64, kv_block=64)
    _assert_close(got, want, float(v.abs().max()))


def test_flash_attention_refuses_what_the_kernel_cannot_run():
    q, k = torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k, window=0)
    tfa.check_shape(q.shape, k.shape)
    for bad_q, bad_k in (((1, 8, 4, 96), (1, 8, 2, 96)), ((1, 8, 4, 64), (1, 8, 3, 64)),
                         ((1, 8, 4, 64), (1, 9, 2, 64)), ((8, 4, 64), (8, 2, 64))):
        with pytest.raises(ValueError):
            tfa.check_shape(bad_q, bad_k)


def _ssd_inputs(seed, G, Q, hd, N, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Q, hd), dtype=np.float32)
    a = -np.abs(rng.standard_normal((G, 1, Q), dtype=np.float32)) * 0.1
    b = rng.standard_normal((G, Q, N), dtype=np.float32)
    c = rng.standard_normal((G, Q, N), dtype=np.float32)
    return [_pair(x, dtype), _pair(a), _pair(b, dtype), _pair(c, dtype)]


@pytest.mark.parametrize("Q,hd,N", [(128, 64, 32), (128, 128, 128), (64, 32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_intra_matches_jax(Q, hd, N, dtype):
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd_inputs(Q + hd + N, 4, Q, hd, N, dtype)
    want = jops.ssd_chunk_intra(jx, ja, jb, jc)
    got = tops.ssd_chunk_intra(tx, ta, tb, tc)
    assert got.dtype == torch.float32
    _assert_close(got, want, float(np.max(np.abs(_np(want)))))


def test_ssd_chunk_refuses_what_the_kernel_cannot_run():
    tsc.check_shape(1024, 128, 64, 128)
    for bad in ((4, 12, 64, 16), (4, 256, 64, 16), (4, 64, 30, 16), (4, 64, 256, 16), (4, 64, 32, 0)):
        with pytest.raises(ValueError):
            tsc.check_shape(*bad)


def _ssd_model_inputs(seed, B, S, nh, hd, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd), dtype=np.float32)
    a = -np.abs(rng.standard_normal((B, S, nh), dtype=np.float32)) * 0.1
    b = rng.standard_normal((B, S, N), dtype=np.float32)
    c = rng.standard_normal((B, S, N), dtype=np.float32)
    return [_pair(t) for t in (x, a, b, c)]


@pytest.mark.parametrize("S,chunk,with_state", [(256, 64, False), (200, 64, True), (130, 32, True)])
def test_ssd_chunked_matches_jax(S, chunk, with_state):
    B, nh, hd, N = 2, 3, 16, 8
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd_model_inputs(S + chunk, B, S, nh, hd, N)
    js, ts = (None, None)
    if with_state:
        js, ts = _pair(np.random.default_rng(1).standard_normal((B, nh, hd, N), dtype=np.float32))
    jy, jstate = jssm.ssd_chunked(jx, ja, jb, jc, chunk, js)
    ty, tstate = tssm.ssd_chunked(tx, ta, tb, tc, chunk, ts)
    assert ty.shape == (B, S, nh, hd) and tstate.shape == (B, nh, hd, N)
    _assert_close(ty, jy, float(np.max(np.abs(_np(jy)))))
    _assert_close(tstate, jstate, float(np.max(np.abs(_np(jstate)))))


def test_ssd_decode_step_matches_jax():
    B, nh, hd, N = 2, 3, 16, 8
    rng = np.random.default_rng(5)
    (jx, tx), (ja, ta), (jb, tb), (jc, tc), (js, ts) = (
        _pair(rng.standard_normal(s, dtype=np.float32)) for s in ((B, nh, hd), (B, nh), (B, N), (B, N),
                                                                  (B, nh, hd, N)))
    jy, jnew = jssm.ssd_decode_step(jx, -jnp.abs(ja), jb, jc, js)
    ty, tnew = tssm.ssd_decode_step(tx, -ta.abs(), tb, tc, ts)
    _assert_close(ty, jy, float(np.max(np.abs(_np(jy)))))
    _assert_close(tnew, jnew, float(np.max(np.abs(_np(jnew)))))


def test_segsum_and_conv_match_jax():
    rng = np.random.default_rng(2)
    ja, ta = _pair(-np.abs(rng.standard_normal((3, 16), dtype=np.float32)))
    _assert_close(tssm.segsum_decay(ta), jssm.segsum_decay(ja), 1.0)
    (jx, tx), (jw, tw) = (_pair(rng.standard_normal(s, dtype=np.float32)) for s in ((2, 10, 6), (4, 6)))
    want = jssm.causal_conv1d(jx, jw)
    _assert_close(tssm.causal_conv1d(tx, tw), want, float(np.max(np.abs(_np(want)))))


def test_ssd_chunk_matches_model_path():
    """The intra-chunk kernel's function equals ``ssd_chunked`` with one
    chunk and no initial state (the model lays b/c out shared by the heads)."""
    B, Q, nh, hd, N = 2, 64, 2, 32, 16
    (_, x), (_, a), (_, b), (_, c) = _ssd_model_inputs(9, B, Q, nh, hd, N)
    y_model, _ = tssm.ssd_chunked(x, a, b, c, chunk=Q)
    xg = x.permute(0, 2, 1, 3).reshape(B * nh, Q, hd)
    ag = a.permute(0, 2, 1).reshape(B * nh, 1, Q)
    bg = b[:, None].expand(B, nh, Q, N).reshape(B * nh, Q, N)
    cg = c[:, None].expand(B, nh, Q, N).reshape(B * nh, Q, N)
    y_kernel = tops.ssd_chunk_intra(xg, ag, bg, cg).reshape(B, nh, Q, hd).permute(0, 2, 1, 3)
    _assert_close(y_kernel, y_model, float(y_model.abs().max()))


def _groups(x, a, b, c, chunk):
    """The model's layout (x (B, S, nh, hd), a (B, S, nh), b/c (B, S, N))
    as the JAX kernel's groups (batch, chunk, head), b and c per group."""
    B, S, nh, hd = x.shape
    nc, N = S // chunk, b.shape[-1]
    xg = x.reshape(B, nc, chunk, nh, hd).transpose(0, 1, 3, 2, 4).reshape(B * nc * nh, chunk, hd)
    ag = a.reshape(B, nc, chunk, nh).transpose(0, 1, 3, 2).reshape(B * nc * nh, 1, chunk)
    bg, cg = (np.repeat(t.reshape(B * nc, chunk, N), nh, axis=0) for t in (b, c))
    return xg, ag, bg, cg


@pytest.mark.parametrize("S,chunk,nh,hd,N", [(256, 64, 3, 16, 8), (128, 128, 2, 32, 16), (96, 32, 1, 20, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_intra_seq_matches_jax(S, chunk, nh, hd, N, dtype):
    """The strided entry (the model's layout, b and c column slices of a
    wider tensor, read where they lie) on the CPU takes its plain version,
    which agrees with JAX's ``ssd_chunk_intra`` on the same values laid out
    as its groups; no launch is counted."""
    B = 2
    rng = np.random.default_rng(S + nh + hd + N)
    xbc = rng.standard_normal((B, S, nh * hd + 2 * N + 3), dtype=np.float32)
    a = -np.abs(rng.standard_normal((B, S, nh), dtype=np.float32)) * 0.1
    (jw, tw), (ja, ta) = _pair(xbc, dtype), _pair(a)
    w = _np(jw)  # the values both sides see
    x, b, c = w[..., :nh * hd].reshape(B, S, nh, hd), w[..., nh * hd:nh * hd + N], w[..., nh * hd + N:-3]
    tx = tw[..., :nh * hd].reshape(B, S, nh, hd)
    tb, tc = tw[..., nh * hd:nh * hd + N], tw[..., nh * hd + N:-3]
    assert tb.stride(1) == nh * hd + 2 * N + 3  # column slices, not copies
    xg, ag, bg, cg = _groups(x, a, b, c, chunk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jops.ssd_chunk_intra(jnp.asarray(xg, jdt), jnp.asarray(ag), jnp.asarray(bg, jdt), jnp.asarray(cg, jdt))
    before = tops.ssd_chunk_intra.launches
    got = tops.ssd_chunk_intra_seq(tx, ta, tb, tc, chunk)
    assert tops.ssd_chunk_intra.launches == before
    assert got.dtype == torch.float32 and got.shape == (B, S, nh, hd)
    nc = S // chunk
    want = np.asarray(want).reshape(B, nc, nh, chunk, hd).transpose(0, 1, 3, 2, 4).reshape(B, S, nh, hd)
    _assert_close(got, want, float(np.max(np.abs(want))))


def test_ssd_chunk_intra_seq_is_the_model_path():
    """The model's intra-chunk term through the strided entry equals the
    plain einsums of ``ssd_chunked`` (one chunk, no state: the whole term)."""
    B, S, nh, hd, N = 2, 64, 2, 32, 16
    (_, x), (_, a), (_, b), (_, c) = _ssd_model_inputs(11, B, S, nh, hd, N)
    y_model, _ = tssm.ssd_chunked(x, a, b, c, chunk=S)
    _assert_close(tops.ssd_chunk_intra_seq(x, a, b, c, S), y_model, float(y_model.abs().max()))


def test_ssd_chunk_intra_seq_refuses_what_is_not_one_sequence():
    x, a, bc = torch.zeros(1, 96, 2, 8), torch.zeros(1, 96, 2), torch.zeros(1, 96, 4)
    for args in ((x, a, bc, bc, 64), (x, a[:, :64], bc, bc, 32), (x, a, bc[:, :64], bc[:, :64], 32),
                 (x, a, bc, bc[..., :3], 32)):
        with pytest.raises(ValueError):
            tops.ssd_chunk_intra_seq(*args)


def _calls(device):
    q, k = torch.randn(1, 8, 4, 64, device=device), torch.randn(1, 8, 2, 64, device=device)
    x, a, bc = torch.randn(2, 8, 4, device=device), -torch.rand(2, 1, 8, device=device), \
        torch.randn(2, 8, 3, device=device)
    return {"flash_attention": lambda: tops.flash_attention(q, k, k, window=3),
            "ssd_chunk_intra": lambda: tops.ssd_chunk_intra(x, a, bc, bc)}


def test_cpu_tensors_take_the_plain_versions():
    counts = {name: getattr(tops, name).launches for name in _calls("cpu")}
    for fn in _calls("cpu").values():
        fn()
    assert {name: getattr(tops, name).launches for name in counts} == counts


@pytest.mark.parametrize("name", ["flash_attention", "ssd_chunk_intra"])
def test_other_devices_raise(name):
    with pytest.raises(ValueError, match="device meta"):
        _calls("meta")[name]()
