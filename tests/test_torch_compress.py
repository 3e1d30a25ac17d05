"""The port's compressed-upload channel agrees with the JAX package's.

The plain version of kernel B3 (what a CPU tensor takes in
``repro_torch.kernels.ops.fake_compress``) against JAX's ``ops.fake_compress``
through its jnp oracle (``use_kernel=False``) and through the Pallas kernel
in interpret mode (``"force"``), single and stacked (the JAX engine's
``vmap`` over clients), for every mode, f32 and bf16. Same operations on the
same f32 values: ``y`` equal, the residual up to one ulp of the values'
scale, because XLA contracts ``x - y`` (``y = q·s``) into a fused
multiply-add where the port rounds ``y`` first, as the kernel's source
says. The wire-format byte counts and the rank masks are copied code and
must agree exactly.
"""
import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.federated import compress as jcomp
from repro.kernels import ops as jops
from repro.lora import rank_mask_tree as j_rank_mask_tree

from repro_torch.federated import compress as tcomp
from repro_torch.kernels import ops as tops
from repro_torch.lora import rank_mask_tree
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

SHAPES = [(256, 128), (300, 130), (7, 5)]
MODES = {  # (qmax, topk_ratio, use_thresh)
    "int8": (127, 1.0, False),
    "int4": (7, 1.0, False),
    "topk_int8": (127, 0.1, True),
    "topk_float": (0, 0.25, True),
}
K = 3  # stacked clients


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((K,) + shape).astype(np.float32) * 1e-2
    d[:, 0] = 0.0  # an all-zero row: a safe scale of zero
    d[1, 1, :3] = [5e-3, -5e-3, 5e-3]  # ties at the top-k boundary
    r = rng.standard_normal((K,) + shape).astype(np.float32) * 1e-3
    # a broadcastable GAL-style mask (one entry per row) and a per-client one
    shared = (rng.random((shape[0], 1)) < 0.6).astype(np.float32)
    per_client = (rng.random((K,) + shape) < 0.5).astype(np.float32)
    if dtype == "bfloat16":
        d, r = _bf16(d), _bf16(r)
    return d, r, shared, per_client


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_ulp_equal(port, want, x):
    """Equal up to one ulp (of ``port``'s dtype) of the largest ``|x|``."""
    p = port.to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    eps = np.finfo(np.float32).eps if port.dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(p, w, rtol=0, atol=eps * float(np.max(np.abs(x))))


def _assert_equal(port, want):
    np.testing.assert_array_equal(port.to(torch.float32).numpy(), np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fake_compress_matches_jax(shape, mode, dtype):
    qmax, ratio, use_thresh = MODES[mode]
    d, r, shared, per_client = _inputs(shape, dtype, seed=SHAPES.index(shape) * 10 + list(MODES).index(mode))
    kw = dict(qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh)
    for use_kernel in (False, "force"):
        jfc = lambda dd, rr, mk: jops.fake_compress(  # noqa: E731
            dd, rr, mk, use_kernel=use_kernel, **kw)
        # single leaves: client 0, with and without a residual and a mask
        for res, mk in ((None, None), (r[0], shared)):
            jy, jr = jfc({"w": d[0]}, None if res is None else {"w": res},
                         None if mk is None else {"w": mk})
            ty, tr = tops.fake_compress(
                {"w": _to_torch(d[0])}, None if res is None else {"w": _to_torch(res)},
                None if mk is None else {"w": _to_torch(mk)}, **kw)
            assert ty["w"].dtype == _to_torch(d[0]).dtype
            x = np.asarray(d[0], np.float32) + (0 if res is None else np.asarray(res, np.float32))
            _assert_equal(ty["w"], jy["w"])
            _assert_ulp_equal(tr["w"], jr["w"], x)
        # stacked: JAX's vmap over clients, with a per-client and a shared mask
        for mk, axis in ((per_client, 0), (shared, None)):
            jy, jr = jax.vmap(jfc, in_axes=(0, 0, axis))({"w": d}, {"w": r}, {"w": mk})
            ty, tr = tops.fake_compress({"w": _to_torch(d)}, {"w": _to_torch(r)},
                                        {"w": _to_torch(mk)}, stacked=True, **kw)
            x = np.asarray(d, np.float32) + np.asarray(r, np.float32)
            _assert_equal(ty["w"], jy["w"])
            _assert_ulp_equal(tr["w"], jr["w"], x)


def test_fake_compress_telescopes_and_launches_nothing_on_cpu():
    """y + residual = x exactly in f32, and no kernel launch on the CPU."""
    d, r, _, _ = _inputs((300, 130), "float32", seed=1)
    before = tops.fake_compress.launches
    for qmax, ratio, use_thresh in MODES.values():
        y, res = tops.fake_compress({"w": _to_torch(d)}, {"w": _to_torch(r)}, None,
                                    qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh,
                                    stacked=True)
        x = _to_torch(d) + _to_torch(r)
        torch.testing.assert_close(y["w"] + res["w"], x, rtol=0, atol=1e-9)
    assert tops.fake_compress.launches == before


@pytest.mark.parametrize("itemsize", [4, 2])
def test_wire_bytes_match_jax(itemsize):
    cfgs = [None, dict(mode="none"), dict(mode="int8"), dict(mode="int4"),
            dict(mode="topk", topk_ratio=0.1), dict(mode="topk", topk_ratio=0.25, topk_values="int4"),
            dict(mode="topk", topk_ratio=0.5, topk_values="float", error_feedback=False)]
    for n in (0, 1, 7, 127, 128, 129, 1000, 172_032, 1_081_344):
        for c in cfgs:
            jc = None if c is None else jcomp.CompressionConfig(**c)
            tc = None if c is None else tcomp.CompressionConfig(**c)
            assert tcomp.leaf_upload_breakdown(n, itemsize, tc) == jcomp.leaf_upload_breakdown(n, itemsize, jc)
            assert tcomp.leaf_upload_bytes(n, itemsize, tc) == jcomp.leaf_upload_bytes(n, itemsize, jc)
        for ratio in (0.01, 0.1, 0.25, 1.0):
            assert tcomp.topk_k(n, ratio) == jcomp.topk_k(n, ratio)
    for c in cfgs[1:]:
        jc, tc = jcomp.CompressionConfig(**c), tcomp.CompressionConfig(**c)
        assert (tc.qmax, tc.use_thresh, tc.enabled) == (jc.qmax, jc.use_thresh, jc.enabled)


@pytest.mark.parametrize("rank", [1, 2, 3, 8])
def test_rank_mask_tree_matches_jax(rank):
    lora = {"layers": {"wq": {"a": np.zeros((2, 6, 3), np.float32), "b": np.zeros((2, 3, 5), np.float32)}}}
    want = j_rank_mask_tree(jax.tree.map(jnp.asarray, lora), rank)
    got = rank_mask_tree(jax.tree.map(torch.from_numpy, lora), rank)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- B3 on the card: the threshold is selected in the kernel, one
# thread-block cluster per (leaf, client) row, by an MSB-first radix select.
# Its arithmetic is emulated here in numpy, block by block, and held to the
# plain version's sort; its host table is plain Python. ---

CLUSTER = 8  # blocks per row (kCluster in csrc/compress.cu)
DIGIT_SHIFTS = {"float32": (20, 9, 0), "bfloat16": (20, 16)}  # digits of the f32 bits of |x|


def _cluster_select(row, mask_row, mask_n, ratio, qmax, dtype):
    """The kernel's threshold and scale of one row (f32 values, already
    rounded to ``dtype``): each of CLUSTER blocks counts its slice's mask
    entries and histograms its slice's digits; the summed histograms pick
    each digit in turn. Returns ``(thresh, scale)`` as float32."""
    m = row.size
    keys = np.abs(row).astype(np.float32).view(np.uint32)
    sl = ((m + CLUSTER - 1) // CLUSTER + 3) // 4 * 4
    slices = [keys[min(b * sl, m):min(b * sl + sl, m)] for b in range(CLUSTER)]
    if mask_row is None:
        active = np.float32(m)
    else:
        part = -(-mask_n // CLUSTER)
        count = sum(int(np.count_nonzero(mask_row[min(b * part, mask_n):min(b * part + part, mask_n)]))
                    for b in range(CLUSTER))
        active = np.float32(count) * np.float32(m // mask_n)
    k = max(np.float32(1.0), np.ceil(np.float32(ratio) * active))
    target = int(np.clip(m - int(k), 0, m - 1))
    prefix, prev = 0, 31
    for shift in DIGIT_SHIFTS[dtype]:
        bits = prev - shift
        total = np.zeros(1 << bits, np.int64)
        for s in slices:
            cand = s[(s >> np.uint32(prev)) == (prefix >> prev)] if prev < 31 else s
            total += np.bincount((cand >> np.uint32(shift)) & np.uint32((1 << bits) - 1), minlength=1 << bits)
        before = np.cumsum(total) - total
        digit = int(np.nonzero((before <= target) & (target < before + total))[0][0])
        target -= int(before[digit])
        prefix |= digit << shift
        prev = shift
    amax = max((s.max() if s.size else np.uint32(0)) for s in slices).view(np.float32)
    scale = amax * np.float32(1.0 / qmax) if qmax else np.float32(0.0)
    return np.uint32(prefix).view(np.float32), np.float32(scale)


def _rows_case(kind, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 24, 7, 13)) * 1e-2).astype(np.float32)
    if kind == "ties_zeros":
        x[:, :10] = 0.0
        x[1, 10:, :, :5] = 3e-3  # a run of ties at the boundary
        x[2] = np.round(x[2] * 300) / 300  # few distinct values
    elif kind == "all_equal":
        x[:] = -2.5e-3
        x[3] = 0.0  # an all-zero row
    if dtype == "bfloat16":
        x = _bf16(x).astype(np.float32)
    return x


MASK_KINDS = {  # name -> (mask of a (4, 24, 7, 13) stacked leaf, counted per client?)
    "none": None,
    "gal": lambda rng: (rng.random((24, 1, 1)) < 0.6).astype(np.float32),
    "shared": lambda rng: (rng.random((24, 7, 13)) < 0.3).astype(np.float32),
    "per_client": lambda rng: (rng.random((4, 24, 7, 13)) < 0.5).astype(np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "ties_zeros", "all_equal"])
@pytest.mark.parametrize("mask_kind", list(MASK_KINDS))
@pytest.mark.parametrize("ratio", [1e-9, 0.1, 1.0], ids=["k1", "k10pct", "km"])
def test_cluster_radix_select_equals_sorted_order_statistic(dtype, kind, mask_kind, ratio):
    """The kernel's select (emulated) finds the very value ``topk_rows``
    reads off its sort, ties included, for every mask kind, k = 1 (the
    row's largest |x|) and k = m (its smallest), f32 and bf16 values; and
    the same absmax scale."""
    rng = np.random.default_rng(7)
    x = _rows_case(kind, dtype, seed=3)
    mk = None if MASK_KINDS[mask_kind] is None else MASK_KINDS[mask_kind](rng)
    per_client = mask_kind == "per_client"
    x2 = torch.from_numpy(x.reshape(4, -1))
    want_t, want_s = tops.topk_rows(x2, None if mk is None else torch.from_numpy(mk),
                                    per_client_mask=per_client, qmax=127, topk_ratio=ratio)
    m = x2.shape[1]
    for c in range(4):
        mask_row, mask_n = None, 0
        if mk is not None:
            mask_row = mk[c].reshape(-1) if per_client else mk.reshape(-1)
            mask_n = mask_row.size
        thresh, scale = _cluster_select(x[c].reshape(-1), mask_row, mask_n, ratio, 127, dtype)
        assert thresh == np.float32(want_t[c]), (c, thresh, float(want_t[c]))
        assert scale == np.float32(want_s[c])
        if ratio == 1e-9:
            assert thresh == np.abs(x[c]).max()
        if ratio == 1.0 and mask_kind == "none":
            assert thresh == np.abs(x[c]).min()
    assert m == 24 * 7 * 13


def test_compress_table_reads_masks_in_place():
    """The B3 launcher's host table, on CPU tensors: per leaf the delta,
    residual, mask and output pointers, the row length, the mask entries per
    row and their stride (0: shared), the first row and the dtype; and
    what it refuses."""
    from repro_torch.kernels import compress, tree_launch

    k = 4
    d = [torch.zeros(k, 24, 896, 8), torch.zeros(k, 24, 8, 128, dtype=torch.bfloat16), torch.zeros(k, 131)]
    r = [torch.zeros_like(d[0]), None, torch.zeros_like(d[2])]
    mk = [torch.ones(k, 24, 896, 8), torch.ones(24, 1, 1), None]  # per client, GAL, none
    lay = tree_launch.layout(tuple((x.shape, x.dtype) for x in d) * 2)
    outs = tree_launch.views(lay, "cpu")
    y, res = outs[:3], outs[3:]
    (launch,) = tree_launch.plan(lay.sizes[:3], k, None)
    words = np.asarray(compress.table(launch, y, res, d, r, mk, clients=k, stacked=True, use_thresh=True))
    rows = words.reshape(3, 11)
    np.testing.assert_array_equal(rows[:, 0], [x.data_ptr() for x in d])
    np.testing.assert_array_equal(rows[:, 1], [r[0].data_ptr(), 0, r[2].data_ptr()])
    np.testing.assert_array_equal(rows[:, 2], [mk[0].data_ptr(), mk[1].data_ptr(), 0])
    np.testing.assert_array_equal(rows[:, 3], [t.data_ptr() for t in y])
    np.testing.assert_array_equal(rows[:, 4], [t.data_ptr() for t in res])
    np.testing.assert_array_equal(rows[:, 5], [x.numel() for x in d])
    np.testing.assert_array_equal(rows[:, 6], [x.numel() // k for x in d])
    np.testing.assert_array_equal(rows[:, 7], [24 * 896 * 8, 24, 0])  # mask entries per row
    np.testing.assert_array_equal(rows[:, 8], [24 * 896 * 8, 0, 0])  # per client, shared
    np.testing.assert_array_equal(rows[:, 9], [0, k, 2 * k])  # first row of each leaf
    np.testing.assert_array_equal(rows[:, 10], [0, 1, 0])
    # without top-k the mask is not read
    words = np.asarray(compress.table(launch, y, res, d, r, mk, clients=k, stacked=True, use_thresh=False))
    assert not words.reshape(3, 11)[:, 2].any()
    with pytest.raises(ValueError, match="alias"):
        compress.table(launch, [d[0], y[1], y[2]], res, d, r, mk, clients=k, stacked=True, use_thresh=True)
    with pytest.raises(TypeError, match="residual"):
        compress.table(launch, y, res, d, [r[0], torch.zeros_like(d[1], dtype=torch.float32), None], mk,
                       clients=k, stacked=True, use_thresh=True)
    with pytest.raises(ValueError, match="client rows"):
        compress.table(launch, y, res, d, r, [torch.ones(3, 5, 1, 1), None, None], clients=k, stacked=True,
                       use_thresh=True)
    with pytest.raises(TypeError, match="mask"):
        compress.table(launch, y, res, d, r, [mk[0].bool(), None, None], clients=k, stacked=True, use_thresh=True)
