"""The port's public kernel entry point agrees with the JAX package's.

``repro_torch.kernels.ops`` against ``repro.kernels.ops`` for the Fisher
diagonal update (B4) and the three neuron-masked LoRA products (B5-B7), on
the same inputs made from a seed with numpy. The JAX side runs its Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` does; the port's
side gets CPU tensors and so takes the plain versions (``kernels/ref.py``),
which is also what the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, tighter than the JAX tests' own (f32 1e-3, bf16 5e-2):
- B4 computes the same three f32 products and one sum on both sides; XLA
  may contract one multiply-add, so rtol 1e-6 (the JAX test's own).
- B5-B7 sum K and r products in another order on each side (XLA's dot
  against PyTorch's matmul): f32 results agree to a few ulp of the sums'
  scale, held at 1e-5 of the output's largest magnitude; bf16 results
  round those f32 values, so they agree to that plus one bf16 ulp.
"""
import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_lora
from torch_jax_refs import release_jax_programs  # noqa: F401

F32_REL = 1e-5  # of the output's largest |value|: f32 sums in another order


def _to_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU torch tensor."""
    j = _to_jax(a, dtype)
    return j, _to_torch(j)


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _assert_close(port, want, dtype):
    p, w = _np(port), _np(want)
    assert p.shape == w.shape
    f32_err = F32_REL * float(np.max(np.abs(w)))
    if dtype == "bfloat16":
        # the f32 values' difference, then one bf16 ulp (8 significant bits)
        # of the larger of the two where rounding parts them
        _, e = np.frexp(np.maximum(np.abs(p), np.abs(w)))
        excess = np.abs(p - w) - (np.ldexp(1.0, e - 8) + f32_err)
        assert np.all(excess <= 0), f"beyond one bf16 ulp by up to {excess.max()}"
    else:
        np.testing.assert_allclose(p, w, rtol=0, atol=f32_err)


# --- B4: momentum diag-FIM update over a tree ---

FISHER_SHAPES = [(3, 37), (500,), (256, 128), (7, 11, 13)]


@pytest.mark.parametrize("shape", FISHER_SHAPES)
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fisher_diag_update_matches_jax(shape, momentum, dtype):
    rng = np.random.default_rng(sum(shape))
    # a tree of two leaves: the shape under test and a second, ragged one
    shapes = {"w": shape, "b": (5, 3)}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    fim = {k: np.abs(rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    jg, tg = {}, {}
    for k in shapes:
        jg[k], tg[k] = _pair(g[k], dtype)
    jf = {k: jnp.asarray(v) for k, v in fim.items()}
    tf = {k: torch.from_numpy(v) for k, v in fim.items()}
    want = jops.fisher_diag_update(jf, jg, momentum)
    got = tops.fisher_diag_update(tf, tg, momentum)
    for k in shapes:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == shapes[k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    # the inputs are left as they were
    assert np.array_equal(tf["w"].numpy(), fim["w"])


# --- B5: the neuron-masked product ---

LORA_SHAPES = [(128, 512, 128, 8), (200, 300, 250, 4), (256, 1024, 384, 16),
               (64, 896, 128, 8)]  # the last: qwen2-0.5b's K with the wk/wv N


def _lora_inputs(M, K, N, r, dtype, seed, rho=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    a = rng.standard_normal((K, r)).astype(np.float32)
    b = rng.standard_normal((r, N)).astype(np.float32)
    mask = (rng.random(N) < rho).astype(np.float32)
    return _pair(x, dtype), _pair(a), _pair(b), _pair(mask)


@pytest.mark.parametrize("M,K,N,r", LORA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_lora_apply_matches_jax(M, K, N, r, dtype):
    (jx, tx), (ja, ta), (jb, tb), (jm, tm) = _lora_inputs(M, K, N, r, dtype, seed=M + K + N + r)
    want = jops.sparse_lora_apply(jx, ja, jb, jm, 2.0)
    got = tops.sparse_lora_apply(tx, ta, tb, tm, 2.0)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    _assert_close(got, want, dtype)
    frozen = tm.numpy() == 0
    assert frozen.any() and np.all(_np(got)[:, frozen] == 0)  # frozen neurons: no delta
    assert np.all(_np(want)[:, frozen] == 0)


def test_sparse_lora_apply_leading_dims():
    (jx, tx), (ja, ta), (jb, tb), (jm, tm) = _lora_inputs(2 * 24, 96, 80, 4, "float32", seed=3)
    want = jops.sparse_lora_apply(jx.reshape(2, 24, 96), ja, jb, jm)
    got = tops.sparse_lora_apply(tx.reshape(2, 24, 96), ta, tb, tm)
    assert tuple(got.shape) == (2, 24, 80)
    _assert_close(got, want, "float32")


# --- B6: the gather-packed product ---


@pytest.mark.parametrize("M,K,N,r", [(128, 512, 256, 8), (64, 96, 200, 4)])
@pytest.mark.parametrize("rho", [0.0, 0.25, 0.5])
def test_sparse_lora_apply_packed_matches_jax(M, K, N, r, rho):
    rng = np.random.default_rng(M + N)
    (jx, tx), (ja, ta), (jb, tb), _ = _lora_inputs(M, K, N, r, "float32", seed=M + N)
    keep = rng.permutation(N)[: int(round(rho * N))]
    mask = np.zeros(N, np.float32)
    mask[keep] = 1.0
    jm, tm = _pair(mask)
    want = jops.sparse_lora_apply_packed(jx, ja, jb, jm, 2.0)
    got = tops.sparse_lora_apply_packed(tx, ta, tb, tm, 2.0)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    if not keep.size:  # all frozen: zeros
        assert np.all(_np(got) == 0) and np.all(np.asarray(want) == 0)
        return
    _assert_close(got, want, "float32")
    # the same as the masked product, and its kept columns the packed one's
    _assert_close(got, tops.sparse_lora_apply(tx, ta, tb, tm, 2.0), "float32")
    frozen = mask == 0
    assert np.all(_np(got)[:, frozen] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_lora_apply_packed_ignores_non_finite_frozen_columns(dtype):
    """inf and nan in b's frozen columns: the JAX packed op gathers only the
    kept columns, and so does the port, so both give exact zeros there."""
    (jx, tx), (ja, ta), (_, tb), (jm, tm) = _lora_inputs(64, 96, 80, 4, dtype, seed=13)
    frozen = tm.numpy() == 0
    b = tb.numpy().copy()
    b[:, frozen] = np.nan
    b[0, frozen] = np.inf
    jb, tb = _pair(b)
    want = jops.sparse_lora_apply_packed(jx, ja, jb, jm, 2.0)
    got = tops.sparse_lora_apply_packed(tx, ta, tb, tm, 2.0)
    assert frozen.any() and np.all(_np(got)[:, frozen] == 0) and np.all(_np(want)[:, frozen] == 0)
    _assert_close(got, want, dtype)


def test_sparse_lora_apply_packed_bf16():
    (jx, tx), (ja, ta), (jb, tb), (jm, tm) = _lora_inputs(64, 896, 128, 8, "bfloat16", seed=11)
    got = tops.sparse_lora_apply_packed(tx, ta, tb, tm, 0.5)
    assert got.dtype == torch.bfloat16
    _assert_close(got, jops.sparse_lora_apply_packed(jx, ja, jb, jm, 0.5), "bfloat16")


# --- B7: the multi-adapter product ---

BATCHED_SHAPES = [(128, 512, 128, 8, 1), (128, 512, 128, 4, 4), (64, 96, 80, 4, 3),
                  (200, 1024, 250, 16, 2)]  # tests/test_kernels.py's
# rows spread at random over the adapters, and batches that group unevenly:
# skewed to one adapter, adapters with no row, every row out of range
BATCHED_CASES = [pytest.param(*shape, "random", id="-".join(map(str, shape))) for shape in BATCHED_SHAPES] + [
    pytest.param(128, 512, 128, 4, 4, "skewed", id="128-512-128-4-4-skewed"),
    pytest.param(200, 1024, 250, 16, 5, "no_rows_on_1_and_3", id="200-1024-250-16-5-no-rows-on-1-and-3"),
    pytest.param(64, 96, 80, 4, 3, "all_out_of_range", id="64-96-80-4-3-all-out-of-range"),
]


def _rows_of_kind(idx, kind, A, rng):
    """Adapter indices of a batch of the given kind, from random ones."""
    if kind == "skewed":  # 3/4 of the rows on adapter 0, the rest spread evenly
        return np.where(rng.random(idx.size) < 0.75, 0, 1 + idx % (A - 1)).astype(np.int32)
    if kind == "no_rows_on_1_and_3":
        return np.where((idx == 1) | (idx == 3), 2, idx).astype(np.int32)
    if kind == "all_out_of_range":
        return np.where(idx % 2 == 0, -1, A + idx).astype(np.int32)
    return idx


def _batched_inputs(M, K, N, r, A, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    idx = rng.integers(0, A, M).astype(np.int32)
    a = rng.standard_normal((A, K, r)).astype(np.float32)
    b = rng.standard_normal((A, r, N)).astype(np.float32)
    # adapter i keeps about (i+1)/(A+1) of its columns
    mask = (rng.random((A, N)) < (np.arange(1, A + 1)[:, None] / (A + 1))).astype(np.float32)
    return _pair(x, dtype), idx, _pair(a), _pair(b), _pair(mask)


@pytest.mark.parametrize("M,K,N,r,A,kind", BATCHED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_sparse_lora_apply_matches_jax(M, K, N, r, A, kind, dtype):
    (jx, tx), idx, (ja, ta), (jb, tb), (jm, tm) = _batched_inputs(M, K, N, r, A, dtype, seed=M + K + A)
    idx = _rows_of_kind(idx, kind, A, np.random.default_rng(A))
    want = jops.batched_sparse_lora_apply(jx, jnp.asarray(idx), ja, jb, jm, 2.0)
    got = tops.batched_sparse_lora_apply(tx, torch.from_numpy(idx), ta, tb, tm, 2.0)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    _assert_close(got, want, dtype)
    out = (idx < 0) | (idx >= A)  # out of range: zero rows
    assert np.all(_np(got)[out] == 0) and np.all(_np(want)[out] == 0)
    frozen = tm.numpy()[np.clip(idx, 0, A - 1)] == 0  # each row's own adapter's frozen columns
    assert np.all(_np(got)[frozen & ~out[:, None]] == 0)
    if A == 1:  # a single adapter is the unbatched product
        _assert_close(got, tops.sparse_lora_apply(tx, ta[0], tb[0], tm[0], 2.0), dtype)


def test_batched_sparse_lora_apply_leading_dims():
    # (B, S, K) activations with a (B, S) per-row index, int64 as PyTorch makes it
    (jx, tx), _, (ja, ta), (jb, tb), (jm, tm) = _batched_inputs(2 * 32, 96, 80, 4, 3, "float32", seed=5)
    idx = np.broadcast_to(np.array([0, 2])[:, None], (2, 32))
    want = jops.batched_sparse_lora_apply(jx.reshape(2, 32, 96), jnp.asarray(idx, jnp.int32), ja, jb, jm)
    got = tops.batched_sparse_lora_apply(tx.reshape(2, 32, 96), torch.from_numpy(idx.astype(np.int64)),
                                         ta, tb, tm)
    assert tuple(got.shape) == (2, 32, 80)
    _assert_close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_sparse_lora_apply_out_of_range_rows_are_zero(dtype):
    """Held against the JAX kernel path, which gives zeros where no adapter
    matches; the JAX oracle's clamped gather does not (ROADMAP.md §C)."""
    M, K, N, r, A = 128, 512, 128, 4, 3
    (jx, tx), idx, (ja, ta), (jb, tb), (jm, tm) = _batched_inputs(M, K, N, r, A, dtype, seed=7)
    idx[::2] = A
    idx[1::8] = -1
    want = jops.batched_sparse_lora_apply(jx, jnp.asarray(idx), ja, jb, jm)
    got = tops.batched_sparse_lora_apply(tx, torch.from_numpy(idx), ta, tb, tm)
    out = (idx < 0) | (idx >= A)
    assert np.all(np.asarray(_np(want))[out] == 0)
    assert np.all(_np(got)[out] == 0) and np.any(_np(got)[~out] != 0)
    _assert_close(got, want, dtype)


# B7 at small counterparts of the card's split path (more than 64 rows whose
# adapters the SGMV kernel does not stage): rows slot-contiguous as a served
# prefill gives them (a tail out of range where the slots do not divide the
# rows) and mixed segments with indices out of range; K and N not multiples
# of 16; the (slots, S, K) activations of the serve path's per-row LoRA
SPLIT_CASES = [
    pytest.param(4, 40, 200, 330, 8, "slots", id="4x40-200-330-8-slots"),
    pytest.param(3, 43, 300, 250, 8, "slots_tail", id="3x43-300-250-8-slots-tail"),
    pytest.param(2, 65, 90, 170, 4, "mixed", id="2x65-90-170-4-mixed"),
    pytest.param(5, 26, 130, 60, 16, "mixed", id="5x26-130-60-16-mixed"),
]


def _split_rows(kind, A, S, rng):
    """A batch of A·S rows: slot s owns rows s·S.., all but the last few
    with ``slots_tail`` (indices A and -1: zeros); ``mixed`` draws every row's
    index from -1..A."""
    M = A * S
    if kind == "mixed":
        return rng.integers(-1, A + 1, M).astype(np.int32)
    idx = np.repeat(np.arange(A, dtype=np.int32), S)
    if kind == "slots_tail":
        idx[-5:] = A
        idx[-2] = -1
    return idx


@pytest.mark.parametrize("A,S,K,N,r,kind", SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_sparse_lora_apply_split_shapes_match_jax(A, S, K, N, r, kind, dtype):
    M = A * S
    (jx, tx), _, (ja, ta), (jb, tb), (jm, tm) = _batched_inputs(M, K, N, r, A, dtype, seed=M + K + N)
    idx = _split_rows(kind, A, S, np.random.default_rng(S))
    assert M > 64 and np.any((idx < 0) | (idx >= A)) == (kind != "slots")
    want = jops.batched_sparse_lora_apply(jx.reshape(A, S, K), jnp.asarray(idx.reshape(A, S)), ja, jb, jm, 0.5)
    got = tops.batched_sparse_lora_apply(tx.reshape(A, S, K), torch.from_numpy(idx.reshape(A, S)), ta, tb, tm, 0.5)
    assert got.dtype == tx.dtype and tuple(got.shape) == (A, S, N)
    _assert_close(got.reshape(M, N), jnp.reshape(want, (M, N)), dtype)
    out = (idx < 0) | (idx >= A)
    assert np.all(_np(got).reshape(M, N)[out] == 0) and np.all(_np(want).reshape(M, N)[out] == 0)
    frozen = tm.numpy()[np.clip(idx, 0, A - 1)] == 0
    assert np.all(_np(got).reshape(M, N)[frozen & ~out[:, None]] == 0)


# --- B7's plan: its plain twin against a numpy construction ---


@pytest.mark.parametrize("M,A", [(4096, 8), (1000, 3), (777, 64), (5, 2)])
@pytest.mark.parametrize("kind", ["random", "skewed", "no_rows_on_1_and_3", "all_out_of_range", "int64"])
def test_sgmv_plan_twin_matches_numpy(M, A, kind):
    """The rows sorted by segment (an adapter in [0, A), then every index
    outside it), stably, then each segment's first row and the end: what
    the SGMV kernel lists on the card (tests/test_torch_cuda.py holds the
    card's plan to this twin)."""
    rng = np.random.default_rng(M + A)
    idx = rng.integers(-1, A + 1, M)
    if kind == "int64":  # indices that wrap into range as int32
        idx = np.where(idx % 3 == 0, 2**32 + idx, idx)
    else:
        idx = _rows_of_kind(idx.astype(np.int32), kind, A, rng)
    plan = sparse_lora.sgmv_plan(torch.from_numpy(idx), A)
    seg = np.where((idx >= 0) & (idx < A), idx, A)
    want = np.concatenate([np.argsort(seg, kind="stable"), [0], np.cumsum(np.bincount(seg, minlength=A + 1))])
    assert plan.dtype == torch.int32 and np.array_equal(plan.numpy(), want)


# --- dispatch ---


def _calls(device):
    x = torch.randn(8, 16, device=device)
    a, b = torch.randn(16, 4, device=device), torch.randn(4, 12, device=device)
    mask = torch.ones(12, device=device)
    idx = torch.zeros(8, dtype=torch.int64, device=device)
    return {
        "fisher_diag_update": lambda: tops.fisher_diag_update({"w": x}, {"w": x}, 0.9),
        "sparse_lora_apply": lambda: tops.sparse_lora_apply(x, a, b, mask),
        "sparse_lora_apply_packed": lambda: tops.sparse_lora_apply_packed(x, a, b, mask),
        "batched_sparse_lora_apply": lambda: tops.batched_sparse_lora_apply(x, idx, a[None], b[None], mask[None]),
    }


def test_cpu_tensors_take_the_plain_versions():
    counts = {name: getattr(tops, name).launches for name in _calls("cpu")}
    for fn in _calls("cpu").values():
        fn()
    assert {name: getattr(tops, name).launches for name in counts} == counts == dict.fromkeys(counts, 0)


@pytest.mark.parametrize("name", list(_calls("cpu")))
def test_other_devices_raise(name):
    with pytest.raises(ValueError, match="device meta"):
        _calls("meta")[name]()
