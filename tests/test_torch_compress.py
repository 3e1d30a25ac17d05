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

pytest.importorskip("torch")

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
