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

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import masked_update, tree_launch
from repro_torch.kernels import ops as tops
from repro_torch.optim import adamw_init, make_optimizer
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

SHAPES = [(48, 32), (300, 140), (2, 8, 17)]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# params' dtype, or "<params' dtype>/bf16_moments": moments (m, v, mu) in bf16
DTYPES = ["float32", "bfloat16", "bfloat16/bf16_moments", "float32/bf16_moments"]


def _dtypes(case):
    """(params' dtype, moments' dtype) of a ``DTYPES`` case."""
    p, _, moments = case.partition("/")
    return p, "bfloat16" if moments else "float32"


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_adamw_matches_pallas_and_ref(shape, dtype, density, active):
    dtype, mdt = _dtypes(dtype)
    p, g, m, v, mask = _inputs(shape, density, seed=len(shape) * 7 + int(density * 10))
    t0 = 3
    lr, wd = 0.01, 0.01
    jp, jg = _j(p, dtype), _j(g, dtype)
    jm, jv = _j(m, mdt), _j(v, mdt)
    jst = {"m": {"w": jm}, "v": {"w": jv}, "t": jnp.int32(t0)}
    kern_p, kern_st = jops.masked_adamw_update(
        {"w": jg}, jst, {"w": jp}, lr, {"w": _j(mask)}, active, wd=wd, use_kernel=True
    )
    tst = {"m": {"w": _t(m, mdt)}, "v": {"w": _t(v, mdt)}, "t": torch.tensor(t0, dtype=torch.int32)}
    out_p, out_st = tops.masked_adamw_update(
        {"w": _t(g, dtype)}, tst, {"w": _t(p, dtype)}, lr, {"w": _t(mask)}, active, wd=wd
    )
    assert out_p["w"].dtype == TORCH[dtype] and out_st["m"]["w"].dtype == out_st["v"]["w"].dtype == TORCH[mdt]
    assert int(out_st["t"]) == int(kern_st["t"]) == t0 + (0 if active == 0.0 else 1)
    bf16 = dtype == "bfloat16"
    _assert_update(out_p["w"], kern_p["w"], jp, mask, active, bf16)
    _assert_update(out_st["m"]["w"], kern_st["m"]["w"], jm, mask, active, mdt == "bfloat16")
    _assert_update(out_st["v"]["w"], kern_st["v"]["w"], jv, mask, active, mdt == "bfloat16")
    # the JAX package's oracle, called directly with its own scale definition
    tf = jnp.float32(int(kern_st["t"]))
    oracle = jref.masked_adamw_update_ref(
        jp, jg, jm, jv, _j(mask), jnp.float32(lr),
        1.0 / (1.0 - 0.9 ** tf), 1.0 / (1.0 - 0.999 ** tf), wd=wd, active=active,
    )
    _assert_update(out_p["w"], oracle[0], jp, mask, active, bf16)


# (dtype, momentum): bf16 moments only where there is a momentum
SGD_CASES = [pytest.param(dt, mom, id=f"{mom}-{dt}") for dt in DTYPES for mom in (0.0, 0.9)
             if mom or "/" not in dt]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,momentum", SGD_CASES)
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_sgd_matches_pallas_and_ref(shape, dtype, momentum, with_mask, active):
    dtype, mdt = _dtypes(dtype)
    p, g, mu, _, mask = _inputs(shape, 0.5, seed=len(shape) + int(momentum * 10))
    if not with_mask:
        mask = np.ones_like(mask)
    lr = 0.05
    jmask = {"w": _j(mask)} if with_mask else None
    tmask = {"w": _t(mask)} if with_mask else None
    jst = {"mu": {"w": _j(mu, mdt)}} if momentum else {}
    tst = {"mu": {"w": _t(mu, mdt)}} if momentum else {}
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
        _j(p, dtype), _j(g, dtype), _j(mu, mdt) if momentum else None,
        _j(mask) if with_mask else None, jnp.float32(lr), momentum=momentum, active=active,
    )
    _assert_update(out_p["w"], oracle_p, _j(p, dtype), mask, active, bf16)
    if momentum:
        assert out_st["mu"]["w"].dtype == TORCH[mdt]
        _assert_update(out_st["mu"]["w"], kern_st["mu"]["w"], _j(mu, mdt), mask, active, mdt == "bfloat16")
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
    from repro_torch.kernels import compress

    x = torch.zeros(4, 6)
    launch = tree_launch.plan((x.numel(),))[0]
    sgd = dict(lr=0.1, active=1.0, momentum=0.0)
    none = [None]
    with pytest.raises(ValueError, match="must lie on"):
        masked_update.adamw_tree_launch(launch, [x], [x], [x], [x], [x], [x], [x], none, clients=1,
                                        t=torch.zeros((), dtype=torch.int32), t_out=torch.zeros(1, dtype=torch.int32),
                                        lr=0.1, active=1.0, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    with pytest.raises(ValueError, match="must lie on"):
        masked_update.sgd_tree_launch(launch, [x], [x], [x], none, none, none, clients=1, scal=None, **sgd)
    with pytest.raises(ValueError, match="scal"):
        masked_update.sgd_tree_launch(launch, [x], [x], [x], none, none, none, clients=1,
                                      scal=torch.zeros(3), **sgd)
    # a (k, 4) table needs leaves that stack k clients on their leading axis
    with pytest.raises(ValueError, match="stack"):
        masked_update.sgd_tree_launch(launch, [x], [x], [x], none, none, none, clients=3,
                                      scal=torch.zeros(3, 4), **sgd)
    with pytest.raises(ValueError, match="CUDA"):
        compress.fake_compress_tree_launch(launch, [x.clone()], [x.clone()], [x], none, none, clients=1,
                                           stacked=False, qmax=127, topk_ratio=1.0, use_thresh=False)
    assert masked_update.library.cache_info().currsize == 0  # nothing was built
    assert compress.library.cache_info().currsize == 0


# --- B1/B2/B3 on the card: one launch per tree. The planner, scalars,
# tables and outputs are plain Python, checked here; the kernels on the card. ---

LORA_SIZES = [24 * 896 * 8, 24 * 8 * 128, 24 * 896 * 8, 24 * 8 * 896] * 2  # qwen2-0.5b's 8 leaves
CHUNKS = {"sgd": masked_update.SGD_CHUNK, "adamw": masked_update.ADAMW_CHUNK, "groups": 1024}
# id -> (leaf sizes, clients stacked on every leaf, chunk)
PLAN_CASES = {
    "lora": (LORA_SIZES, 1, CHUNKS["sgd"]),
    "lora_stacked": ([4 * n for n in LORA_SIZES], 1, CHUNKS["sgd"]),
    "ragged": ([1, 3, 1000, 4097], 1, CHUNKS["sgd"]),
    "chunks": ([4096, 4096, 1], 1, CHUNKS["sgd"]),
    "empty": ([0, 5, 0, 8192 * 3 + 1], 1, CHUNKS["sgd"]),
    "many": ([7] * 40, 1, CHUNKS["sgd"]),
    # client rows: no chunk straddles two clients, rows not a multiple of the chunk
    "lora_rows": ([4 * n for n in LORA_SIZES], 4, CHUNKS["sgd"]),
    "lora_rows_adamw": ([4 * n for n in LORA_SIZES], 4, CHUNKS["adamw"]),
    "ragged_rows_sgd": ([3 * 5000, 3 * 1, 3 * 4097, 0, 3 * 2048], 3, CHUNKS["sgd"]),
    "ragged_rows_adamw": ([3 * 5000, 3 * 1, 3 * 4097, 0, 3 * 2049], 3, CHUNKS["adamw"]),
    "ragged_adamw": ([1, 3, 1000, 2049, 6000], 1, CHUNKS["adamw"]),
    "groups_rows": ([4 * 131 * 7 * 24, 4 * 33], 4, CHUNKS["groups"]),
}


def _chunk_of_block(launch, sizes, clients, chunk, b):
    """The kernels' map: block b of a launch -> (leaf, client, first element,
    end element) of the chunk it works on, leaf l owning the blocks from
    block0[l] on, client row after client row."""
    j = 0
    while j + 1 < len(launch.leaves) and launch.block0[j + 1] <= b:
        j += 1
    leaf = launch.leaves[j]
    row = sizes[leaf] // clients
    c, k = divmod(b - launch.block0[j], -(-row // chunk))
    start = c * row + k * chunk
    return leaf, c, start, min(start + chunk, (c + 1) * row)


@pytest.mark.parametrize("case", list(PLAN_CASES.values()), ids=list(PLAN_CASES))
@pytest.mark.parametrize("capacity", [tree_launch.MAX_LEAVES, 3, 1])
def test_sgd_plan_covers_every_element_once_in_order(case, capacity):
    """Block b of a launch updates chunk b - block0[l] of its leaf l, client
    row after client row (the kernels' map): every element of every
    non-empty leaf exactly once, chunk after chunk, the leaves in tree order,
    and no chunk straddles two clients' rows. The planner is shared by B1,
    B2 and B3; each kernel has its own chunk."""
    sizes, clients, chunk = case
    plans = tree_launch.plan(tuple(sizes), clients, chunk, capacity)
    covered = {i: [] for i in range(len(sizes))}
    for launch in plans:
        assert 1 <= len(launch.leaves) <= capacity
        for b in range(launch.grid):
            leaf, c, start, end = _chunk_of_block(launch, sizes, clients, chunk, b)
            row = sizes[leaf] // clients
            assert c * row <= start < end <= min(start + chunk, (c + 1) * row)
            covered[leaf].append((start, end))
    for i, n in enumerate(sizes):
        done = 0
        for start, end in covered[i]:
            assert start == done
            done = end
        assert done == n
    assert [i for launch in plans for i in launch.leaves] == [i for i, n in enumerate(sizes) if n > 0]


@pytest.mark.parametrize("clients", [1, 4])
def test_plan_one_block_per_row(clients):
    """B3's top-k plan: each (leaf, client) row is one block of the plan (a
    thread-block cluster on the card), numbered in leaf order."""
    sizes = (clients * 172032, 0, clients * 24576, clients * 131)
    (launch,) = tree_launch.plan(sizes, clients, None)
    assert launch.leaves == (0, 2, 3)
    assert launch.block0 == (0, clients, 2 * clients) and launch.grid == 3 * clients


def test_adamw_table_keeps_each_tensors_dtype():
    """B1's host table, on CPU tensors: per leaf the eight pointers, the
    element count, the client row, the first block and the dtype codes of
    p, g, m and v (0 f32, 1 bf16), each moment with its own; an output in
    another dtype than its input is refused."""
    k, bf = 2, torch.bfloat16
    p = [torch.zeros(k, 5), torch.zeros(k, 3, dtype=bf)]
    g = [torch.zeros(k, 5, dtype=bf), torch.zeros(k, 3, dtype=bf)]
    m = [torch.zeros(k, 5, dtype=bf), torch.zeros(k, 3)]
    v = [torch.zeros(k, 5), torch.zeros(k, 3, dtype=bf)]
    mask = [None, torch.ones(k, 3)]
    outs = tree_launch.views(tree_launch.layout(tuple((x.shape, x.dtype) for x in p + m + v)), "cpu")
    (launch,) = tree_launch.plan((10, 6), k, masked_update.ADAMW_CHUNK)
    words = masked_update.table(launch, k, outs[:2], p, g, outs[2:4], m, outs[4:], v, mask)
    rows = np.asarray(words).reshape(2, 12)
    for j in range(2):
        want = [p[j], g[j], m[j], v[j], mask[j], outs[j], outs[2 + j], outs[4 + j]]
        assert rows[j, :8].tolist() == [0 if t is None else t.data_ptr() for t in want]
    assert rows[:, 8].tolist() == [10, 6] and rows[:, 9].tolist() == [5, 3] and rows[:, 10].tolist() == [0, 2]
    assert rows[:, 11].tolist() == [0 | 1 << 8 | 1 << 16 | 0 << 24, 1 | 1 << 8 | 0 << 16 | 1 << 24]
    with pytest.raises(TypeError, match="m_out"):
        masked_update.table(launch, k, outs[:2], p, g, [outs[2].float(), outs[3]], m, outs[4:], v, mask)


@pytest.mark.parametrize("n_leaves,launches", [(1, 1), (8, 1), (32, 1), (33, 2), (64, 2), (70, 3)])
def test_sgd_plan_splits_beyond_the_table(n_leaves, launches):
    plans = tree_launch.plan((100,) * n_leaves)
    assert tree_launch.MAX_LEAVES == 32
    assert len(plans) == launches
    assert sum(len(p.leaves) for p in plans) == n_leaves


@pytest.mark.parametrize("lr,active,by_value", [
    (0.05, None, True), (0.05, 0.0, True), (0.05, 2, True), (np.float32(0.05), np.float32(1.0), True),
    (torch.tensor(0.05), None, False), (0.05, torch.tensor([1.0, 0.0, 3.0]), False),
    (torch.tensor(0.05), torch.tensor(0.0), False), (0.05, torch.tensor([True, False]), False),
    (0.05, torch.tensor(0.0), False),
], ids=["float", "inactive", "int_active", "numpy", "tensor_lr", "per_client", "tensor_both", "bool_active",
        "scalar_active"])
def test_sgd_scalars_by_value_or_device_table(lr, active, by_value):
    """Python numbers travel by value (no device work); a tensor lr or
    active makes the (k, 4) f32 row table [lr, active, 0, 0], whose active
    column the kernel reads as != 0."""
    lr_v, active_v, table = tops.sgd_scalars(lr, active, "cpu")
    if by_value:
        assert table is None
        assert lr_v == float(lr) and active_v == (1.0 if active is None else float(active != 0))
        return
    k = active.shape[0] if isinstance(active, torch.Tensor) and active.dim() == 1 else 1
    assert table.shape == (k, 4) and table.dtype == torch.float32 and table.is_contiguous()
    want_active = np.ones(k) if active is None else (np.asarray(active, np.float32) != 0) * np.ones(k)
    np.testing.assert_array_equal(table[:, 0].numpy(), np.full(k, np.float32(float(lr))))
    np.testing.assert_array_equal(table[:, 1].numpy() != 0, want_active != 0)
    assert not table[:, 2:].any()


def test_sgd_outputs_are_views_of_one_buffer_per_dtype():
    leaves = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16), torch.zeros(2, 2), torch.zeros(0),
              torch.zeros(9, dtype=torch.bfloat16)]
    sig = tuple((t.shape, t.dtype) for t in leaves)
    lay = tree_launch.layout(sig)
    assert lay.sizes == (15, 7, 4, 0, 9) and tree_launch.layout(sig) is lay  # cached per signature
    out = tree_launch.views(lay, "cpu")
    for o, t in zip(out, leaves):
        assert o.shape == t.shape and o.dtype == t.dtype and o.is_contiguous()
        assert o.data_ptr() % 16 == 0
    assert out[0].untyped_storage().data_ptr() == out[2].untyped_storage().data_ptr()
    assert out[1].untyped_storage().data_ptr() == out[4].untyped_storage().data_ptr()
    for i, o in enumerate(out):  # no two leaves overlap
        o.fill_(i + 1)
    for i, o in enumerate(out):
        assert bool((o == i + 1).all())
    mus = tree_launch.views(tree_launch.layout(tuple((s, torch.float32) for s, _ in sig[:3])), "cpu")
    assert [m.dtype for m in mus] == [torch.float32] * 3


def test_unflattened_outputs_are_freed_without_the_garbage_collector():
    """B2 returns its new leaves through ``tree_unflatten``: the tree holds
    them in leaf order, and dropping it frees them at once (a reference
    cycle would keep each step's output buffer until the collector ran,
    and the card's allocator would take fresh memory every step)."""
    import gc
    import weakref

    from repro_torch.utils.tree import tree_unflatten

    like = {"b": {"y": 0, "x": None}, "a": 0}
    leaves = [torch.zeros(3), torch.ones(2), torch.full((1,), 2.0)]
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        tree = tree_unflatten(like, leaves)
        assert tree_leaves(tree) == leaves and tree["b"]["x"] is leaves[1]
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_sgd_tree_dispatch_looks_at_every_leaf():
    """The tree's device is not read off its first leaf: a leaf neither on
    the CPU nor on the card is refused wherever it stands in leaf order,
    before any leaf takes the plain version."""
    for odd in ("a", "b"):
        params = {"a": torch.zeros(4), "b": torch.zeros(4)}
        params[odd] = torch.zeros(4, device="meta")
        grads = {k: torch.ones_like(p) for k, p in params.items()}
        with pytest.raises(ValueError, match="no kernel or plain version"):
            tops.masked_sgd_update(grads, {}, params, 0.1)


def test_tree_leaves_like_reads_at_the_first_trees_positions():
    """B2's CUDA path pairs the leaves of grads, mask and momentum with
    params' by position: they are read at params' keys, so a tree that
    lacks one of them raises KeyError (as tree_map does) instead of
    shifting every later leaf onto the wrong parameter."""
    from repro_torch.utils.tree import tree_leaves_like

    like = {"l": {"b": 0, "a": 0}, "c": 0}
    assert tree_leaves_like(like, {"c": 3, "l": {"a": 1, "b": 2}}) == [3, 1, 2]
    assert tree_leaves_like(like, {"c": 3, "l": {"a": 1, "b": 2, "z": 9}}) == [3, 1, 2]
    assert tree_leaves_like(like, {"c": None, "l": {"a": None, "b": 2}}) == [None, None, 2]
    with pytest.raises(KeyError):
        tree_leaves_like(like, {"c": 3, "l": {"a": 1, "z": 2}})


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_sgd_tree_with_mixed_masks_matches_pallas(momentum, active):
    """One tree, as the card's single launch takes it: f32 and bf16 leaves,
    masked and dense leaves side by side (the mask tree holds None), ragged
    sizes; leaf by leaf against the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(int(momentum * 10) + (3 if active is None else int(active)))
    spec = {"a": ((48, 32), "float32", True), "b": ((300, 140), "bfloat16", False),
            "c": ((2, 8, 17), "bfloat16", True), "d": ((130,), "float32", False), "e": ((1,), "float32", True)}
    p, g, mu, mk = ({k: rng.standard_normal(s).astype(np.float32) for k, (s, _, _) in spec.items()}
                    for _ in range(4))
    mk = {k: (rng.uniform(size=s) < 0.5).astype(np.float32) if masked else None
          for k, (s, _, masked) in spec.items()}
    dt = {k: d for k, (_, d, _) in spec.items()}
    jout, jst = jops.masked_sgd_update(
        {k: _j(g[k], dt[k]) for k in spec}, {"mu": {k: _j(mu[k]) for k in spec}} if momentum else {},
        {k: _j(p[k], dt[k]) for k in spec}, 0.05, {k: None if mk[k] is None else _j(mk[k]) for k in spec},
        active, momentum=momentum, use_kernel=True)
    tout, tst = tops.masked_sgd_update(
        {k: _t(g[k], dt[k]) for k in spec}, {"mu": {k: _t(mu[k]) for k in spec}} if momentum else {},
        {k: _t(p[k], dt[k]) for k in spec}, 0.05, {k: None if mk[k] is None else _t(mk[k]) for k in spec},
        active, momentum=momentum)
    for k in spec:
        mask = np.ones(spec[k][0], np.float32) if mk[k] is None else mk[k]
        assert tout[k].dtype == TORCH[dt[k]]
        _assert_update(tout[k], jout[k], _j(p[k], dt[k]), mask, active, dt[k] == "bfloat16")
        if momentum:
            _assert_update(tst["mu"][k], jst["mu"][k], mu[k], mask, active, False)
