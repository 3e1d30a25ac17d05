"""The arithmetic of the tensor-core SSD intra-chunk kernel (B9) meets the
JAX package's ``ssd_chunk_intra`` before any card runs it.

``csrc/ssd_chunk.cu`` computes both of its products on Hopper's tensor
cores (``wgmma``), the scores ``c·bᵀ`` once a row for all the heads that
share its b and c (each head's ``M`` is formed from the same scores: the
emulation computes them once a row, as the kernel does):
- f32 inputs: 3xTF32. Each operand is split into a TF32 ``hi`` (round to
  nearest, ties away, to a 10-bit mantissa: ``cvt.rna.tf32.f32``) and a TF32
  ``lo`` of the rest; each k-step of 8 adds ``lo·hi``, ``hi·lo`` and
  ``hi·hi`` to the f32 accumulator, the scores on SS ``wgmma`` (c and b
  split in shared memory), ``M·x`` on RS ``wgmma`` (M's split fragments in
  registers, x transposed and split in shared memory: TF32 ``wgmma`` reads
  its B operand K-major only). One TF32 product keeps about three decimal
  digits, which the tolerance below does not allow.
- bf16 inputs: ``c·bᵀ`` from the exact bf16 values (a product of two bf16
  values is exact in f32), and ``M·x`` with the f32 ``M = exp(cs_i − cs_j)
  ·score`` split into ``hi = bf16(M)`` and ``lo = bf16(M − hi)``, both
  multiplied by the exact bf16 x, each k-step of 16 adding ``hi·x`` then
  ``lo·x``.
The emulation below sums as the kernel does: the scores over N in steps of
8 (f32) or 16 (bf16), ``M·x`` over j in the same steps, each step's
products summed exactly and added to the f32 accumulator with one rounding
(what a tensor-core step does, up to the order within a step). Steps that
the kernel skips or pads (past N, above the diagonal, the 64-row tiles'
columns past a row's diagonal) add exact zeros. The scan
``cs = cumsum(a)`` stays in f32 and is scaled into log2 units, so that a
decay is one ``2^(cs2_i − cs2_j)`` (``ex2.approx`` on the card, within 2^-22
of it); entries above the diagonal are exactly 0.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does. Tolerance, as on the card (``chip_smoke.py``,
``SSD_REL`` and ``SSD_CS_REL``): the sums err by a few ulp of their absolute
terms and a decay ``exp(cs_i − cs_j)`` by a few ulp of ``|cs|``, so an output
may differ by ``(1e-5 + 1e-6·max|cs|)`` times the sum of its absolute terms
(the plain version on ``|x|``, ``|b|``, ``|c|``).
"""
import math

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import ref as tref
from torch_jax_refs import release_jax_programs  # noqa: F401

SSD_REL, SSD_CS_REL = 1e-5, 1e-6
LOG2E = float(np.float32(1.4426950408889634))
SHAPES = [(128, 64, 32), (128, 128, 128), (64, 32, 16), (24, 20, 5)]  # the JAX tests' (Q, hd, N), one ragged


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, ties away from 0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_bf16(x):
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def mma_steps(acc, terms, k_step):
    """``acc += Σ_t a_t @ b_t`` step by step over the shared dimension: per
    step of ``k_step`` and per term, the products summed exactly (f64) and
    added to the f32 accumulator with one rounding."""
    K = terms[0][0].shape[-1]
    for k0 in range(0, K, k_step):
        for a, b in terms:
            part = a[..., k0:k0 + k_step].double() @ b[..., k0:k0 + k_step, :].double()
            acc = (acc.double() + part).float()
    return acc


def pad_to(t, dim, size):
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def kernel_emulation(x, a, b, c, *, terms=3, heads=1):
    """The card kernel's arithmetic on CPU tensors. ``terms``: 3 for the
    kernel (3xTF32, or bf16 ``hi + lo``); 1 for a single TF32 / bf16 product
    (the design it replaces the split with). b and c hold one row for each
    ``heads`` groups; the scores are computed once a row."""
    G, Q, hd = x.shape
    N = b.shape[-1]
    Qp, Np = -(-Q // 16) * 16, -(-N // 32) * 32
    bf16 = x.dtype == torch.bfloat16
    xf, bf, cf = (t.to(torch.float32) for t in (x, b, c))
    xf, bf, cf = pad_to(xf, 1, Qp), pad_to(pad_to(bf, 1, Qp), 2, Np), pad_to(pad_to(cf, 1, Qp), 2, Np)
    cs = torch.from_numpy(np.cumsum(a[:, 0].to(torch.float32).numpy(), axis=-1, dtype=np.float32))
    cs = pad_to(cs * LOG2E, 1, Qp)
    zero = torch.zeros(G // heads, Qp, Qp)
    if bf16:
        score = mma_steps(zero, [(cf, bf.transpose(1, 2))], 16)
    else:
        (ch, cl), (bh, bl) = split_tf32(cf), split_tf32(bf.transpose(1, 2))
        pairs = [(cl, bh), (ch, bl), (ch, bh)] if terms == 3 else [(ch, bh)]
        score = mma_steps(zero, pairs, 8)
    score = score.repeat_interleave(heads, 0)  # the row's scores, each of its heads
    i = torch.arange(Qp)
    live = (i[None, :] <= i[:, None]) & (i[:, None] < Q)
    decay = torch.exp2(torch.where(live, cs[:, :, None] - cs[:, None, :], torch.zeros(())))
    m = torch.where(live, decay * score, torch.zeros(()))
    y0 = torch.zeros(G, Qp, hd)
    if bf16:
        mh, ml = split_bf16(m)
        y = mma_steps(y0, [(mh, xf), (ml, xf)] if terms == 3 else [(mh, xf)], 16)
    else:
        (mh, ml), (xh, xl) = split_tf32(m), split_tf32(xf)
        y = mma_steps(y0, [(ml, xh), (mh, xl), (mh, xh)] if terms == 3 else [(mh, xh)], 8)
    return y[:, :Q]


def _pair(arr, dtype="float32"):
    j = jnp.asarray(arr, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    n = np.asarray(j)
    if n.dtype.name == "bfloat16":
        return j, torch.from_numpy(n.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return j, torch.from_numpy(np.array(n))


def _inputs(seed, G, Q, hd, N, dtype, decays):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Q, hd), dtype=np.float32)
    b = rng.standard_normal((G, Q, N), dtype=np.float32)
    c = rng.standard_normal((G, Q, N), dtype=np.float32)
    if decays == "jax_tests":  # -|N(0, 1)|·0.1, as tests/test_kernels.py draws them
        a = -np.abs(rng.standard_normal((G, 1, Q), dtype=np.float32)) * 0.1
    else:  # Mamba2's initializer: A from 1 to 16 over the heads, dt log-uniform in [1e-3, 0.1]
        A = np.linspace(1.0, 16.0, G, dtype=np.float32)
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(0.1), (G, 1, Q))).astype(np.float32)
        a = -A[:, None, None] * dt
        x = x * dt[:, 0, :, None]
    return [_pair(x, dtype), _pair(a), _pair(b, dtype), _pair(c, dtype)]


def _excess(got, want, x, a, b, c):
    """How far each output lies beyond the card's tolerance (<= 0: within)."""
    terms = tref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs())
    cs_max = float(a.float().sum(dim=-1).abs().max())
    allowed = (SSD_REL + SSD_CS_REL * cs_max) * terms
    return (got - torch.from_numpy(np.array(want, np.float32))).abs() - allowed


@pytest.mark.parametrize("Q,hd,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decays", ["jax_tests", "mamba2"])
def test_tensor_core_arithmetic_matches_jax(Q, hd, N, dtype, decays):
    """3xTF32 (f32) and bf16 scores with ``M`` split hi/lo (bf16) stay within
    the card's tolerance of the JAX kernel (Pallas interpret mode)."""
    (jx, x), (ja, a), (jb, b), (jc, c) = _inputs(Q + 3 * hd + N, 4, Q, hd, N, dtype, decays)
    want = jops.ssd_chunk_intra(jx, ja, jb, jc)
    got = kernel_emulation(x, a, b, c)
    assert got.dtype == torch.float32 and got.shape == (4, Q, hd)
    excess = _excess(got, want, x, a, b, c)
    assert bool((excess <= 0).all()), f"beyond tolerance by up to {float(excess.max())}"


@pytest.mark.parametrize("Q,hd,N,heads", [(128, 64, 128, 4), (64, 32, 16, 3), (24, 20, 5, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_shared_by_the_heads_match_jax(Q, hd, N, heads, dtype):
    """One c·bᵀ a row for the heads sharing b and c: the same bits as the
    ``heads=1`` emulation on b and c expanded to every group, within the
    card's tolerance of the JAX kernel on those expanded inputs (Mamba2's
    decays)."""
    G = 2 * heads
    (jx, x), (ja, a), (jb, b), (jc, c) = _inputs(Q + hd + N + heads, G, Q, hd, N, dtype, "mamba2")
    b, c = b[::heads].contiguous(), c[::heads].contiguous()  # one row a chunk
    bx, cx = (t.repeat_interleave(heads, 0) for t in (b, c))
    got = kernel_emulation(x, a, b, c, heads=heads)
    assert torch.equal(got, kernel_emulation(x, a, bx, cx))
    jb, jc = (jnp.repeat(t[::heads], heads, axis=0) for t in (jb, jc))
    excess = _excess(got, jops.ssd_chunk_intra(jx, ja, jb, jc), x, a, bx, cx)
    assert bool((excess <= 0).all()), f"beyond tolerance by up to {float(excess.max())}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_product_would_miss_the_tolerance(dtype):
    """The split is needed: one TF32 product per step (f32), or ``M``
    rounded once to bf16 (bf16), leaves outputs beyond the tolerance."""
    (jx, x), (ja, a), (jb, b), (jc, c) = _inputs(5, 4, 128, 64, 128, dtype, "jax_tests")
    want = jops.ssd_chunk_intra(jx, ja, jb, jc)
    excess = _excess(kernel_emulation(x, a, b, c, terms=1), want, x, a, b, c)
    assert bool((excess > 0).any())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbour of 1
    vals = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11 + 2.0 ** -20],
                        dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    hi, lo = split_tf32(torch.tensor([math.pi], dtype=torch.float32))
    assert abs(float(hi + lo) - math.pi) < 2.0 ** -21 * math.pi
