"""The port's masked AdamW / SGD update (B1/B2) against the JAX package.

On the CPU the port's wrappers take the plain versions, which are held
against ``repro.kernels.ops.masked_*_update(use_kernel=True)`` (the Pallas
kernels in interpret mode) and against ``repro.kernels.ref``, over the cases
of ``tests/test_masked_update.py``: non-tile shapes, f32 and bf16 params,
mask densities, ``active`` in {None, 0, 1} and several steps of Adam's
counter. Frozen entries must be bit-identical; live entries agree to atol
1e-6, rtol 1e-6 (sqrt and division may differ by an ulp across libms; a
bf16 output is compared in bf16, where one such ulp can flip the last bit).

The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops as tops
from repro_torch.optim import adamw_init, make_optimizer
from repro_torch.utils.tree import tree_leaves

SHAPES = [(48, 32), (300, 140), (2, 8, 17)]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, density, seed):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.3
    mask = (rng.uniform(size=shape) < density).astype(np.float32)
    return p, g, m * 0.3, v, mask


def _j(x, dtype="float32"):
    return jnp.asarray(x, JNP[dtype])


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(TORCH[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_update(port, ref, old, mask, active, bf16):
    """Frozen entries bit-identical to ``old``; live entries close to ``ref``."""
    port, ref, old = _np(port), _np(ref), _np(old)
    frozen = (mask == 0) | (active is not None and active == 0)
    np.testing.assert_array_equal(port[frozen], old[frozen])
    live = ~frozen
    if bf16:  # one f32 ulp upstream may round to the neighbouring bf16 value
        np.testing.assert_allclose(port[live], ref[live], atol=1e-6, rtol=2.0 ** -7)
    else:
        np.testing.assert_allclose(port[live], ref[live], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_adamw_matches_pallas_and_ref(shape, dtype, density, active):
    p, g, m, v, mask = _inputs(shape, density, seed=len(shape) * 7 + int(density * 10))
    t0 = 3
    lr, wd = 0.01, 0.01
    jp, jg = _j(p, dtype), _j(g, dtype)
    jst = {"m": {"w": _j(m)}, "v": {"w": _j(v)}, "t": jnp.int32(t0)}
    kern_p, kern_st = jops.masked_adamw_update(
        {"w": jg}, jst, {"w": jp}, lr, {"w": _j(mask)}, active, wd=wd, use_kernel=True
    )
    tst = {"m": {"w": _t(m)}, "v": {"w": _t(v)}, "t": torch.tensor(t0, dtype=torch.int32)}
    out_p, out_st = tops.masked_adamw_update(
        {"w": _t(g, dtype)}, tst, {"w": _t(p, dtype)}, lr, {"w": _t(mask)}, active, wd=wd
    )
    assert out_p["w"].dtype == TORCH[dtype] and out_st["m"]["w"].dtype == torch.float32
    assert int(out_st["t"]) == int(kern_st["t"]) == t0 + (0 if active == 0.0 else 1)
    bf16 = dtype == "bfloat16"
    _assert_update(out_p["w"], kern_p["w"], jp, mask, active, bf16)
    _assert_update(out_st["m"]["w"], kern_st["m"]["w"], m, mask, active, False)
    _assert_update(out_st["v"]["w"], kern_st["v"]["w"], v, mask, active, False)
    # the JAX package's oracle, called directly with its own scale definition
    tf = jnp.float32(int(kern_st["t"]))
    oracle = jref.masked_adamw_update_ref(
        jp, jg, _j(m), _j(v), _j(mask), jnp.float32(lr),
        1.0 / (1.0 - 0.9 ** tf), 1.0 / (1.0 - 0.999 ** tf), wd=wd, active=active,
    )
    _assert_update(out_p["w"], oracle[0], jp, mask, active, bf16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_sgd_matches_pallas_and_ref(shape, dtype, momentum, with_mask, active):
    p, g, mu, _, mask = _inputs(shape, 0.5, seed=len(shape) + int(momentum * 10))
    if not with_mask:
        mask = np.ones_like(mask)
    lr = 0.05
    jmask = {"w": _j(mask)} if with_mask else None
    tmask = {"w": _t(mask)} if with_mask else None
    jst = {"mu": {"w": _j(mu)}} if momentum else {}
    tst = {"mu": {"w": _t(mu)}} if momentum else {}
    kern_p, kern_st = jops.masked_sgd_update(
        {"w": _j(g, dtype)}, jst, {"w": _j(p, dtype)}, lr, jmask, active,
        momentum=momentum, use_kernel=True,
    )
    out_p, out_st = tops.masked_sgd_update(
        {"w": _t(g, dtype)}, tst, {"w": _t(p, dtype)}, lr, tmask, active, momentum=momentum
    )
    bf16 = dtype == "bfloat16"
    _assert_update(out_p["w"], kern_p["w"], _j(p, dtype), mask, active, bf16)
    oracle_p, _ = jref.masked_sgd_update_ref(
        _j(p, dtype), _j(g, dtype), _j(mu) if momentum else None,
        _j(mask) if with_mask else None, jnp.float32(lr), momentum=momentum, active=active,
    )
    _assert_update(out_p["w"], oracle_p, _j(p, dtype), mask, active, bf16)
    if momentum:
        _assert_update(out_st["mu"]["w"], kern_st["mu"]["w"], mu, mask, active, False)
    else:
        assert out_st == {}


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_multi_step_fused_matches_unfused_and_jax(name):
    """Five steps with an inactive step in the middle: Adam's ``t`` skips it,
    fused (the plain version on the CPU) equals unfused, and both follow the
    JAX package's fused optimizer."""
    from repro.optim import make_optimizer as j_make_optimizer

    rng = np.random.default_rng(5)
    shapes = [(6, 33), (130,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mask = [(rng.uniform(size=s) > 0.4).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    actives = [None, 1.0, 0.0, 1.0, None]
    kw = {"momentum": 0.9} if name == "sgd" else {}

    def tree(leaves, conv):
        return {"a": conv(leaves[0]), "b": {"c": conv(leaves[1])}}

    runs = {}
    for fused in (False, True):
        init, upd = make_optimizer(name, fused=fused, **kw)
        tp, tm = tree(params, _t), tree(mask, _t)
        st = init(tp)
        for g, active in zip(grads, actives):
            tp, st = upd(tree(g, _t), st, tp, 0.02, tm, active)
        runs[fused] = (tp, st)
    for x, y in zip(tree_leaves(dict(enumerate(runs[False]))), tree_leaves(dict(enumerate(runs[True])))):
        np.testing.assert_allclose(_np(x), _np(y), atol=1e-6, rtol=1e-6)
    if name == "adamw":
        assert int(runs[True][1]["t"]) == 4  # the inactive step does not count

    init, upd = j_make_optimizer(name, fused="force", **kw)
    jp, jm = tree(params, _j), tree(mask, _j)
    st = init(jp)
    for g, active in zip(grads, actives):
        jp, st = upd(tree(g, _j), st, jp, 0.02, jm, active)
    for x, y in zip(tree_leaves(runs[True][0]), [jp["a"], jp["b"]["c"]]):
        np.testing.assert_allclose(_np(x), _np(y), atol=1e-6, rtol=1e-6)


def test_adamw_init_matches_jax_layout():
    st = adamw_init({"w": torch.zeros(3, 2)})
    assert st["t"].dtype == torch.int32 and int(st["t"]) == 0
    assert st["m"]["w"].shape == (3, 2) and st["v"]["w"].dtype == torch.float32


def test_kernel_launchers_refuse_what_the_kernel_does_not_take():
    """The launchers check device, dtype, size and contiguity before they
    build or call the CUDA library; here every tensor lies on the CPU."""
    from repro_torch.kernels import masked_update

    from repro_torch.kernels import compress

    x = torch.zeros(4, 6)
    scal = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="must lie on"):
        masked_update.adamw_launch(x, x, x, x, x, x, x, None, scal, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    with pytest.raises(ValueError, match="must lie on"):
        masked_update.sgd_launch(x, x, x, None, None, None, scal, momentum=0.0)
    with pytest.raises(ValueError, match="scal"):
        masked_update.sgd_launch(x, x, x, None, None, None, torch.zeros(3), momentum=0.0)
    # a (k, 4) table needs a leaf that stacks k clients on its leading axis
    with pytest.raises(ValueError, match="stack"):
        masked_update.sgd_launch(x, x, x, None, None, None, torch.zeros(3, 4), momentum=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        compress.fake_compress_launch(x, x.clone(), x.clone(), torch.zeros(4, 2), qmax=127,
                                      use_thresh=False, per_leaf_scale=False)
    assert masked_update.library.cache_info().currsize == 0  # nothing was built
    assert compress.library.cache_info().currsize == 0
