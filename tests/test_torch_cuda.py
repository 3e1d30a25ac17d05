"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one; the kernels have no
CPU mode. The file imports neither JAX nor the JAX package, so that it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ops, ref, sparse_lora, ssd_chunk  # noqa: E402

SHAPES = [(24, 896, 8), (24, 8, 128), (1000, 3)]  # LoRA a, b of wk/wv; a ragged size


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, shape, dtype):
    p, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
    m = torch.randn(shape, generator=gen, device="cuda") * 0.1
    v = torch.rand(shape, generator=gen, device="cuda") * 0.1
    mask = (torch.rand(shape, generator=gen, device="cuda") < 0.5).float()
    return p, g, m, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_adamw_kernel_matches_plain(cuda, shape, dtype, active):
    p, g, m, v, mask = _inputs(cuda, shape, dtype)
    t = torch.tensor(2, dtype=torch.int32, device="cuda")
    before = ops.masked_adamw_update.launches
    new_p, st = ops.masked_adamw_update(
        {"w": g}, {"m": {"w": m}, "v": {"w": v}, "t": t}, {"w": p}, 0.01, {"w": mask}, active, wd=0.01
    )
    assert ops.masked_adamw_update.launches == before + 1
    t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
    assert int(st["t"]) == int(t2)
    want = ref.masked_adamw_update_ref(p, g, m, v, mask, ops.as_f32(0.01, "cuda"), mhat, vhat,
                                       wd=0.01, active=active)
    torch.cuda.synchronize()
    for out, w in zip((new_p["w"], st["m"]["w"], st["v"]["w"]), want):
        assert out.dtype == w.dtype
        assert torch.equal(out, w)  # same operations in the same order


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sgd_kernel_matches_plain(cuda, shape, dtype, momentum, with_mask):
    p, g, mu, _, mask = _inputs(cuda, shape, dtype)
    mk = mask if with_mask else None
    before = ops.masked_sgd_update.launches
    new_p, st = ops.masked_sgd_update(
        {"w": g}, {"mu": {"w": mu}} if momentum else {}, {"w": p}, 0.05,
        {"w": mk} if with_mask else None, momentum=momentum,
    )
    assert ops.masked_sgd_update.launches == before + 1
    want_p, want_mu = ref.masked_sgd_update_ref(p, g, mu if momentum else None, mk,
                                                ops.as_f32(0.05, "cuda"), momentum=momentum)
    torch.cuda.synchronize()
    assert torch.equal(new_p["w"], want_p)
    if momentum:
        assert torch.equal(st["mu"]["w"], want_mu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stacked", [False, True])
def test_kernel_bf16_moments_match_plain(cuda, shape, dtype, stacked):
    """B1 and B2 take moments in bf16 (as the optimizers' init makes them
    for a bf16 tree), compute in f32 and return each moment rounded to its
    own dtype, bit for bit equal to the plain version; frozen entries keep
    their bits."""
    shape = ((K,) if stacked else ()) + shape
    p, g, m, v, mask = _inputs(cuda, shape, dtype)
    m, v = m.bfloat16(), v.bfloat16()
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda") if stacked else 1.0
    t = torch.tensor([0, 3, 7, 1] if stacked else 2, dtype=torch.int32, device="cuda")
    new_p, st = ops.masked_adamw_update({"w": g}, {"m": {"w": m}, "v": {"w": v}, "t": t}, {"w": p}, 0.01,
                                        {"w": mask}, active, wd=0.01)
    t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
    rows = (lambda x: _rows(x, p)) if stacked else (lambda x: x)
    want = ref.masked_adamw_update_ref(p, g, m, v, mask, ops.as_f32(0.01, "cuda"), rows(mhat), rows(vhat),
                                       wd=0.01, active=rows(active) if stacked else active)
    torch.cuda.synchronize()
    assert torch.equal(st["t"], t2)
    for out, w in zip((new_p["w"], st["m"]["w"], st["v"]["w"]), want):
        assert out.dtype == w.dtype and torch.equal(out, w)
    assert torch.equal(st["m"]["w"][mask == 0], m[mask == 0])
    new_p, st = ops.masked_sgd_update({"w": g}, {"mu": {"w": m}}, {"w": p}, 0.05, {"w": mask}, active, momentum=0.9)
    want_p, want_mu = ref.masked_sgd_update_ref(p, g, m, mask, ops.as_f32(0.05, "cuda"), momentum=0.9,
                                                active=rows(active) if stacked else active)
    torch.cuda.synchronize()
    assert st["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(new_p["w"], want_p) and torch.equal(st["mu"]["w"], want_mu)


# --- stacked clients: one (k, 4) row of scalars per client (B1/B2) ---

K = 4


def _rows(x, leaf):
    return x.reshape((-1,) + (1,) * (leaf.dim() - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_stacked_rows_match_plain(cuda, dtype):
    p, g, m, v, mask = _inputs(cuda, (K, 24, 8, 128), dtype)
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    t = torch.tensor([0, 3, 7, 1], dtype=torch.int32, device="cuda")
    new_p, st = ops.masked_adamw_update({"w": g}, {"m": {"w": m}, "v": {"w": v}, "t": t},
                                        {"w": p}, 0.01, {"w": mask}, active, wd=0.01)
    t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
    assert torch.equal(st["t"], t2) and st["t"].tolist() == [1, 3, 8, 2]
    want = ref.masked_adamw_update_ref(p, g, m, v, mask, ops.as_f32(0.01, "cuda"), _rows(mhat, p),
                                       _rows(vhat, p), wd=0.01, active=_rows(active, p))
    torch.cuda.synchronize()
    for out, w in zip((new_p["w"], st["m"]["w"], st["v"]["w"]), want):
        assert torch.equal(out, w)
    assert torch.equal(new_p["w"][1], p[1])  # the inactive client keeps its bits


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_kernel_stacked_rows_match_plain(cuda, momentum):
    p, g, mu, _, mask = _inputs(cuda, (K, 24, 8, 896), torch.float32)
    active = torch.tensor([0.0, 1.0, 1.0, 0.0], device="cuda")
    new_p, st = ops.masked_sgd_update({"w": g}, {"mu": {"w": mu}} if momentum else {}, {"w": p}, 0.05,
                                      {"w": mask}, active, momentum=momentum)
    want_p, want_mu = ref.masked_sgd_update_ref(p, g, mu if momentum else None, mask, ops.as_f32(0.05, "cuda"),
                                                momentum=momentum, active=_rows(active, p))
    torch.cuda.synchronize()
    assert torch.equal(new_p["w"], want_p)
    if momentum:
        assert torch.equal(st["mu"]["w"], want_mu)


# --- B2 over whole trees: one launch per tree of up to 32 leaves ---

LORA_LEAVES = {"wq": ((24, 896, 8), (24, 8, 896)), "wk": ((24, 896, 8), (24, 8, 128)),
               "wv": ((24, 896, 8), (24, 8, 128)), "wo": ((24, 896, 8), (24, 8, 896))}  # qwen2-0.5b


def _lr(kind, lr=0.05):
    return lr if kind == "float" else torch.tensor(lr, dtype=torch.float32, device="cuda")


def _assert_sgd_tree(new_p, new_st, params, grads, mus, masks, lr, active, momentum):
    """Leaf by leaf, bit for bit against the plain version."""
    lr_t = lr if isinstance(lr, torch.Tensor) else ops.as_f32(lr, "cuda")
    torch.cuda.synchronize()
    for key in params:
        p, g = params[key], grads[key]
        mk = None if masks is None else masks[key]
        want_p, want_mu = ref.masked_sgd_update_ref(p, g, mus[key] if momentum else None, mk, lr_t,
                                                    momentum=momentum, active=ops.per_client(active, p))
        assert new_p[key].dtype == p.dtype and new_p[key].shape == p.shape
        assert torch.equal(new_p[key], want_p), key
        if momentum:
            assert torch.equal(new_st["mu"][key], want_mu), key


def _sgd_tree_case(gen, shapes, dtypes, masked, momentum):
    params = {k: torch.randn(s, generator=gen, device="cuda").to(dtypes[k]) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen, device="cuda").to(dtypes[k]) for k, s in shapes.items()}
    mus = {k: torch.randn(s, generator=gen, device="cuda") for k, s in shapes.items()}
    masks = {k: (torch.rand(s, generator=gen, device="cuda") < 0.5).float() if masked[k] else None
             for k, s in shapes.items()}
    return params, grads, mus, masks


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("masked", [False, True])
def test_sgd_tree_lora_one_launch_matches_plain(cuda, stacked, momentum, lr_kind, masked):
    """qwen2-0.5b's 8-leaf LoRA tree, one client or 4 stacked with a (k,)
    active that holds zeros: one launch, every leaf bit for bit."""
    lead = (K,) if stacked else ()
    shapes = {f"{t}_{ab}": lead + s for t, (sa, sb) in LORA_LEAVES.items() for ab, s in (("a", sa), ("b", sb))}
    params, grads, mus, masks = _sgd_tree_case(cuda, shapes, dict.fromkeys(shapes, torch.float32),
                                               dict.fromkeys(shapes, masked), momentum)
    active = torch.tensor([1.0, 0.0, 1.0, 0.0], device="cuda") if stacked else None
    lr = _lr(lr_kind)
    before = ops.masked_sgd_update.launches
    new_p, st = ops.masked_sgd_update(grads, {"mu": mus} if momentum else {}, params, lr,
                                      masks if masked else None, active, momentum=momentum)
    assert ops.masked_sgd_update.launches == before + 1
    _assert_sgd_tree(new_p, st, params, grads, mus, masks if masked else None, lr, active, momentum)
    if stacked:
        assert torch.equal(new_p["wq_a"][1], params["wq_a"][1])  # an inactive client keeps its bits


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_sgd_tree_ragged_mixed_leaves_match_plain(cuda, momentum, lr_kind, active):
    """Leaves of 1, 3, 1000 and 4097 elements, f32 and bf16, masked and
    dense, and views one element into a larger buffer (unaligned: the
    kernel's element-by-element path) in one tree and one launch."""
    shapes = {"a": (1,), "b": (3,), "c": (1000,), "d": (4097,), "e": (8, 17), "f": (4097,)}
    dtypes = {"a": torch.float32, "b": torch.bfloat16, "c": torch.float32, "d": torch.bfloat16,
              "e": torch.bfloat16, "f": torch.float32}
    masked = {"a": True, "b": False, "c": True, "d": True, "e": False, "f": True}
    params, grads, mus, masks = _sgd_tree_case(cuda, shapes, dtypes, masked, momentum)
    # unaligned views: p, g, mu and the mask of leaf "f" start one element into their buffers
    for tree in (params, grads, mus, masks):
        base = torch.randn(4098, generator=cuda, device="cuda")
        tree["f"] = ((base > 0).float() if tree is masks else base)[1:]
        assert tree["f"].data_ptr() % 16 != 0
    lr = _lr(lr_kind)
    before = ops.masked_sgd_update.launches
    new_p, st = ops.masked_sgd_update(grads, {"mu": mus} if momentum else {}, params, lr, masks, active,
                                      momentum=momentum)
    assert ops.masked_sgd_update.launches == before + 1
    _assert_sgd_tree(new_p, st, params, grads, mus, masks, lr, active, momentum)


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_leaf", ["a", "b"])
def test_sgd_tree_with_a_cpu_leaf_is_refused(cuda, cpu_leaf):
    """A tree with any leaf on the card goes to the kernel, which refuses a
    leaf elsewhere, whichever comes first in leaf order: no leaf takes the
    plain version."""
    params = {"a": torch.randn(64, generator=cuda, device="cuda"), "b": torch.randn(64, generator=cuda, device="cuda")}
    params[cpu_leaf] = params[cpu_leaf].cpu()
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    before = ops.masked_sgd_update.launches
    with pytest.raises(ValueError, match="must lie on"):
        ops.masked_sgd_update(grads, {}, params, 0.1)
    assert ops.masked_sgd_update.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [32, 33, 70])
def test_sgd_tree_beyond_the_table_splits_into_launches(cuda, n_leaves):
    shapes = {f"w{i:03d}": (5 + i,) for i in range(n_leaves)}
    params, grads, mus, masks = _sgd_tree_case(cuda, shapes, dict.fromkeys(shapes, torch.float32),
                                               {k: i % 2 == 0 for i, k in enumerate(shapes)}, 0.9)
    before = ops.masked_sgd_update.launches
    new_p, st = ops.masked_sgd_update(grads, {"mu": mus}, params, 0.05, masks, momentum=0.9)
    assert ops.masked_sgd_update.launches == before + -(-n_leaves // 32)
    _assert_sgd_tree(new_p, st, params, grads, mus, masks, 0.05, None, 0.9)


# --- B1 over whole trees: one launch per tree of up to 32 leaves ---


def _assert_adamw_tree(new_p, new_st, params, grads, st, masks, lr, active, wd=0.01):
    """Leaf by leaf, bit for bit against the plain version, with the step
    counters advanced as the plain version advances them."""
    lr_t = lr if isinstance(lr, torch.Tensor) else ops.as_f32(lr, "cuda")
    t2, mhat, vhat = ops.adam_step_scales(st["t"], active, 0.9, 0.999)
    torch.cuda.synchronize()
    assert torch.equal(new_st["t"], t2) and new_st["t"].dtype == torch.int32
    for key in params:
        p = params[key]
        mk = None if masks is None else masks[key]
        want = ref.masked_adamw_update_ref(p, grads[key], st["m"][key], st["v"][key], mk, lr_t,
                                           ops.per_client(mhat, p), ops.per_client(vhat, p), wd=wd,
                                           active=ops.per_client(active, p))
        for out, w, name in zip((new_p[key], new_st["m"][key], new_st["v"][key]), want, "pmv"):
            assert out.dtype == w.dtype and out.shape == w.shape, (key, name)
            assert torch.equal(out, w), (key, name)


def _adamw_tree_case(gen, shapes, dtypes, mdtypes, masked, t):
    params, grads, mus, masks = _sgd_tree_case(gen, shapes, dtypes, masked, 0.0)
    m = {k: (0.1 * mus[k]).to(mdtypes[k]) for k in shapes}
    v = {k: (0.1 * torch.rand(s, generator=gen, device="cuda")).to(mdtypes[k]) for k, s in shapes.items()}
    return params, grads, {"m": m, "v": v, "t": t}, masks


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("masked", [False, True])
def test_adamw_tree_lora_one_launch_matches_plain(cuda, stacked, mixed, lr_kind, masked):
    """qwen2-0.5b's 8-leaf LoRA tree, one client or 4 stacked with per-client
    step counters and an ``active`` read in place from a column of a step
    plan (a strided view holding zeros); f32, or half the leaves bf16 with
    bf16 moments: one launch, every leaf bit for bit."""
    lead = (K,) if stacked else ()
    shapes = {f"{t}_{ab}": lead + s for t, (sa, sb) in LORA_LEAVES.items() for ab, s in (("a", sa), ("b", sb))}
    low = {k: torch.bfloat16 if mixed and k.endswith("_a") else torch.float32 for k in shapes}
    t = torch.tensor([0, 3, 7, 1], dtype=torch.int32, device="cuda") if stacked else \
        torch.tensor(5, dtype=torch.int32, device="cuda")
    params, grads, st, masks = _adamw_tree_case(cuda, shapes, low, low, dict.fromkeys(shapes, masked), t)
    plan = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.0]], device="cuda")
    active = plan[:, 0] if stacked else None
    lr = _lr(lr_kind, 1e-3)
    before = ops.masked_adamw_update.launches
    new_p, new_st = ops.masked_adamw_update(grads, st, params, lr, masks if masked else None, active, wd=0.01)
    assert ops.masked_adamw_update.launches == before + 1
    _assert_adamw_tree(new_p, new_st, params, grads, st, masks if masked else None, lr, active)
    if stacked:
        assert torch.equal(new_p["wq_a"][1], params["wq_a"][1])  # an inactive client keeps its bits
        assert torch.equal(new_st["v"]["wo_b"][1], st["v"]["wo_b"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_adamw_tree_hybrid_groups_match_plain(cuda, stacked):
    """zamba2-7b's LoRA at full width over 2 Mamba layers: the stacked (L, d,
    r) in_proj/out_proj leaves and the shared block's unstacked (d, r)
    wq-wo leaves in one tree, one client or 4 stacked, masked: one launch,
    every leaf bit for bit."""
    lead = (K,) if stacked else ()
    shapes = {}
    for t, (d_in, d_out) in {"in_proj": (3584, 14576), "out_proj": (7168, 3584)}.items():
        shapes.update({f"mamba_{t}_a": lead + (2, d_in, 8), f"mamba_{t}_b": lead + (2, 8, d_out)})
    for t in ("wq", "wk", "wv", "wo"):
        shapes.update({f"shared_{t}_a": lead + (3584, 8), f"shared_{t}_b": lead + (8, 3584)})
    f32 = dict.fromkeys(shapes, torch.float32)
    t = torch.tensor([0, 3, 7, 1], dtype=torch.int32, device="cuda") if stacked else \
        torch.tensor(2, dtype=torch.int32, device="cuda")
    params, grads, st, masks = _adamw_tree_case(cuda, shapes, f32, f32, dict.fromkeys(shapes, True), t)
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda") if stacked else None
    before = ops.masked_adamw_update.launches
    new_p, new_st = ops.masked_adamw_update(grads, st, params, 1e-3, masks, active, wd=0.01)
    assert ops.masked_adamw_update.launches == before + 1
    _assert_adamw_tree(new_p, new_st, params, grads, st, masks, 1e-3, active)


@pytest.mark.cuda
@pytest.mark.parametrize("active", [None, 0.0, 1.0])
def test_adamw_tree_ragged_mixed_leaves_match_plain(cuda, active):
    """Leaves of 1, 3, 1000 and 2049 elements, every mix of f32 and bf16
    params and moments, masked and dense, and a leaf of unaligned views
    (the kernel's element-by-element path), in one tree and one launch."""
    shapes = {"a": (1,), "b": (3,), "c": (1000,), "d": (2049,), "e": (8, 17), "f": (4097,)}
    dtypes = {"a": torch.float32, "b": torch.bfloat16, "c": torch.float32, "d": torch.bfloat16,
              "e": torch.bfloat16, "f": torch.float32}
    mdtypes = {"a": torch.bfloat16, "b": torch.float32, "c": torch.float32, "d": torch.bfloat16,
               "e": torch.float32, "f": torch.bfloat16}
    masked = {"a": True, "b": False, "c": True, "d": True, "e": False, "f": True}
    t = torch.tensor(0, dtype=torch.int32, device="cuda")
    params, grads, st, masks = _adamw_tree_case(cuda, shapes, dtypes, mdtypes, masked, t)
    for tree in (params, grads, st["m"], st["v"], masks):  # leaf "f": one element into its buffer
        base = torch.randn(4098, generator=cuda, device="cuda")
        tree["f"] = ((base > 0).float() if tree is masks else base.to(tree["f"].dtype).abs())[1:]
        assert tree["f"].data_ptr() % 16 != 0
    before = ops.masked_adamw_update.launches
    new_p, new_st = ops.masked_adamw_update(grads, st, params, 0.01, masks, active, wd=0.01)
    assert ops.masked_adamw_update.launches == before + 1
    _assert_adamw_tree(new_p, new_st, params, grads, st, masks, 0.01, active)


@pytest.mark.cuda
@pytest.mark.parametrize("clients,n_leaves", [(1, 33), (3, 70)])
def test_adamw_tree_rows_and_table_splits(cuda, clients, n_leaves):
    """Stacked rows of a length that is not a multiple of the kernel's 2048
    chunk (no chunk straddles two clients), and trees beyond the 32-leaf
    table: one launch per 32 leaves, every leaf bit for bit."""
    lead = (clients,) if clients > 1 else ()
    shapes = {f"w{i:03d}": lead + (2049 + 7 * i,) for i in range(n_leaves)}
    t = torch.arange(clients, dtype=torch.int32, device="cuda") if clients > 1 else \
        torch.tensor(1, dtype=torch.int32, device="cuda")
    f32 = dict.fromkeys(shapes, torch.float32)
    params, grads, st, masks = _adamw_tree_case(cuda, shapes, f32, f32, {k: i % 2 == 0 for i, k in enumerate(shapes)},
                                                t)
    active = torch.tensor([1.0, 0.0, 1.0], device="cuda") if clients > 1 else None
    before = ops.masked_adamw_update.launches
    new_p, new_st = ops.masked_adamw_update(grads, st, params, 0.02, masks, active, wd=0.01)
    assert ops.masked_adamw_update.launches == before + -(-n_leaves // 32)
    _assert_adamw_tree(new_p, new_st, params, grads, st, masks, 0.02, active)


# --- B3: fake compression ---

COMPRESS_MODES = [(127, 1.0, False), (7, 1.0, False), (127, 0.1, True), (0, 0.25, True)]


def plain_fake_compress(d, r, mk, *, qmax, topk_ratio, use_thresh, stacked):
    """The wrapper's steps with the plain version in place of the kernel."""
    x2, thresh, scale = ops.compress_rows(d, r, mk, qmax=qmax, topk_ratio=topk_ratio,
                                          use_thresh=use_thresh, stacked=stacked)
    y, res = ref.fake_compress_ref(x2, thresh, scale, qmax=qmax, use_thresh=use_thresh,
                                   per_leaf_scale=use_thresh and qmax > 0)
    return y.reshape(d.shape), res.reshape(d.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stacked", [((24, 896, 8), False), ((24, 8, 128), False),
                                           ((7, 5), False), ((K, 300, 130), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", COMPRESS_MODES)
def test_fake_compress_kernel_matches_plain(cuda, shape, stacked, dtype, mode):
    qmax, ratio, use_thresh = mode
    d = (torch.randn(shape, generator=cuda, device="cuda") * 1e-2).to(dtype)
    r = (torch.randn(shape, generator=cuda, device="cuda") * 1e-3).to(dtype)
    mk = (torch.rand(shape, generator=cuda, device="cuda") < 0.5).float()
    kw = dict(qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh)
    before = ops.fake_compress.launches
    y, res = ops.fake_compress({"w": d}, {"w": r}, {"w": mk}, stacked=stacked, **kw)
    assert ops.fake_compress.launches == before + 1
    want_y, want_r = plain_fake_compress(d, r, mk, stacked=stacked, **kw)
    torch.cuda.synchronize()
    assert y["w"].dtype == dtype
    assert torch.equal(y["w"], want_y) and torch.equal(res["w"], want_r)


# --- B4: the momentum diag-FIM update ---


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 896, 8), (8, 24, 8, 896), (1000, 3), (7,)])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fim_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_fisher_diag_kernel_matches_plain(cuda, shape, g_dtype, fim_dtype, momentum):
    g = torch.randn(shape, generator=cuda, device="cuda").to(g_dtype)
    fim = torch.rand(shape, generator=cuda, device="cuda").to(fim_dtype)
    before = ops.fisher_diag_update.launches
    out = ops.fisher_diag_update({"w": fim}, {"w": g}, momentum)["w"]
    assert ops.fisher_diag_update.launches == before + 1
    want = ref.fisher_diag_update_ref(g, fim, momentum)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.equal(out, want)  # same operations in the same order


@pytest.mark.cuda
def test_fisher_diag_kernel_unaligned_views(cuda):
    # views one element into their storage: the kernel's elementwise path
    g = torch.randn(4097, generator=cuda, device="cuda")[1:]
    fim = torch.rand(4097, generator=cuda, device="cuda").bfloat16()[1:]
    out = ops.fisher_diag_update(fim, g, 0.95)  # a bare tensor is a one-leaf tree
    torch.cuda.synchronize()
    assert torch.equal(out, ref.fisher_diag_update_ref(g, fim, 0.95))


# --- B5-B7: the neuron-masked LoRA products ---


def assert_lora_close(out, plain):
    """The kernel sums in another order than the plain version's matmuls, so
    their f32 results differ by up to 1e-5 of the largest |value| (the sums'
    scale, not each value's). On top of that: f32 within atol = rtol =
    1e-4; bf16 at most one ulp apart, where rounding parts them."""
    assert out.dtype == plain.dtype and out.shape == plain.shape
    o, p = out.float(), plain.float()
    order = 1e-5 * p.abs().max()
    if out.dtype == torch.float32:
        allowed = 1e-4 + 1e-4 * p.abs() + order
    else:
        _, e = torch.frexp(torch.maximum(o.abs(), p.abs()))
        allowed = torch.ldexp(torch.ones_like(o), e - 8) + order
    assert bool(((o - p).abs() <= allowed).all()), float((o - p).abs().max())


LORA_CASES = [(256, 896, 896, 8), (256, 896, 128, 8), (200, 300, 250, 4), (200, 300, 250, 16),
              (64, 96, 80, 6), (33, 7, 5, 3), (17, 64, 40, 64)]


def _lora(gen, M, K, N, r, dtype, rho=0.5):
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    a = torch.randn(K, r, generator=gen, device="cuda")
    b = torch.randn(r, N, generator=gen, device="cuda")
    mask = (torch.rand(N, generator=gen, device="cuda") < rho).float()
    return x, a, b, mask


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", LORA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_lora_kernel_matches_plain(cuda, M, K, N, r, dtype):
    x, a, b, mask = _lora(cuda, M, K, N, r, dtype)
    before = ops.sparse_lora_apply.launches
    y = ops.sparse_lora_apply(x, a, b, mask, 0.5)
    assert ops.sparse_lora_apply.launches == before + 1
    torch.cuda.synchronize()
    assert_lora_close(y, ref.sparse_lora_matmul_ref(x, a, b, mask, 0.5))
    assert bool((y[:, mask == 0] == 0).all())  # frozen neurons: no delta


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", LORA_CASES)
@pytest.mark.parametrize("rho", [0.0, 0.25, 0.5, 1.0])
def test_sparse_lora_packed_kernel_matches_plain(cuda, M, K, N, r, rho):
    x, a, b, mask = _lora(cuda, M, K, N, r, torch.bfloat16, rho)
    before = ops.sparse_lora_apply_packed.launches
    y = ops.sparse_lora_apply_packed(x, a, b, mask, 2.0)
    assert ops.sparse_lora_apply_packed.launches == before + 1  # all frozen too: the kernel writes the zeros
    y5 = ops.sparse_lora_apply(x, a, b, mask, 2.0)
    torch.cuda.synchronize()
    assert_lora_close(y, y5)
    keep = torch.nonzero(mask).reshape(-1)
    if keep.numel():
        assert_lora_close(y[:, keep], ref.sparse_lora_matmul_packed_ref(x, a, b[:, keep], 2.0))
    # the kept columns are B5's bits (b · 1 is b); the frozen ones exactly 0
    assert torch.equal(y[:, keep], y5[:, keep])
    assert bool((y[:, mask == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 64])  # the resident kernel and the L2 one
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_lora_packed_never_reads_frozen_columns(cuda, r, dtype):
    """inf and nan in b's frozen columns: B6 still gives exact zeros there,
    as the JAX packed op does (it gathers only the kept columns), and B5's
    kept columns elsewhere."""
    M, K, N = 1000, 896, 896
    x, a, b, mask = _lora(cuda, M, K, N, r, dtype)
    frozen = mask == 0
    bad = b.clone()
    bad[:, frozen] = float("nan")
    bad[0, frozen] = float("inf")
    y = ops.sparse_lora_apply_packed(x, a, bad, mask, 0.5)
    y5 = ops.sparse_lora_apply(x, a, b, mask, 0.5)
    torch.cuda.synchronize()
    assert bool((y[:, frozen] == 0).all())
    assert torch.equal(y[:, ~frozen], y5[:, ~frozen])


BATCHED_CASES = [(256, 896, 896, 8, 8), (200, 300, 250, 4, 3), (64, 96, 80, 6, 2), (128, 512, 128, 16, 1)]
# A adapters at ranks 4-64, ragged widths and 896: every rank up to 16 takes
# the SGMV kernel where M >= 16 A (A 64 only at 4096 rows), rank 64 and A 64
# at 1000 rows the L2 kernel
BATCHED_PATHS = [(M, K, N, r, A) for A in (1, 3, 8, 64) for r in (4, 8, 16, 64)
                 for M, K, N in ((1000, 300, 250), (4096, 896, 896))]
# prefill at the new families' widths, rank 8: zamba2-7b's in_proj and
# out_proj (a and b too wide to stage: BGMV) and shared block, llama4's wq
# and wk, granite's wq and wk, 4 prompts of 1024 tokens over 4 adapters
BATCHED_PATHS += [(4096, K, N, 8, 4) for K, N in ((3584, 14576), (7168, 3584), (3584, 3584), (5120, 5120),
                                                   (5120, 1024), (1536, 1536), (1536, 512))]


def _b7_launches():
    """B7's launches on its three counters: the resident and L2 kernels'
    (``launches``), the few-row path's (``few_row_launches``) and the split
    path's (``split_launches``)."""
    fn = ops.batched_sparse_lora_apply
    return fn.launches, fn.few_row_launches, fn.split_launches


def _b7_counted(before, M, K, N, r, A, dtype):
    """One call since ``before``, on the counter of the path it took: SGMV
    where it stages, else the few-row path at most FEW_MAX_ROWS rows and
    the split path above."""
    path = sparse_lora.batched_path(M, K, N, r, dtype, A)
    sgmv = sparse_lora.resident_stages(K, N, r, dtype, adapters=A, rows=M) > 0
    assert path == ("sgmv" if sgmv else "few_rows" if M <= sparse_lora.FEW_MAX_ROWS else "split")
    moved = tuple(n - b for n, b in zip(_b7_launches(), before))
    assert moved == {"sgmv": (1, 0, 0), "few_rows": (0, 1, 0), "split": (0, 0, 1)}[path]


def _batched(gen, M, K, N, r, A, dtype):
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    a = torch.randn(A, K, r, generator=gen, device="cuda")
    b = torch.randn(A, r, N, generator=gen, device="cuda")
    mask = (torch.rand(A, N, generator=gen, device="cuda") < 0.5).float()
    return x, a, b, mask


def _sgmv(M, K, N, r, A, dtype):
    """Whether the multi-adapter launch takes the SGMV kernel, by its rule."""
    sgmv = sparse_lora.resident_stages(K, N, r, dtype, adapters=A, rows=M) > 0
    fits = sparse_lora.resident_stages(K, N, r, dtype) > 0
    assert sgmv == (fits and A <= 1024 and M >= 16 * A)
    return sgmv


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r,A", BATCHED_CASES + BATCHED_PATHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sparse_lora_kernel_matches_plain(cuda, M, K, N, r, A, dtype):
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = torch.randint(0, A, (M,), generator=cuda, device="cuda")
    idx[::7] = A  # out of range: zeros
    idx[3::11] = -1
    _sgmv(M, K, N, r, A, dtype)
    before = _b7_launches()
    y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 1.5)
    _b7_counted(before, M, K, N, r, A, dtype)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 1.5))
    out = (idx < 0) | (idx >= A)
    assert bool((y[out] == 0).all())
    if A == 1:  # a single adapter is the unbatched product
        ok = ~out
        assert_lora_close(y[ok], ops.sparse_lora_apply(x, a[0], b[0], mask[0], 1.5)[ok])
    # leading dimensions are flattened and restored; int32 indices as they are
    y3 = ops.batched_sparse_lora_apply(x.reshape(1, M, K), idx.reshape(1, M).int(), a, b, mask, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(y3.reshape(M, N), y)


def _segments(gen, kind, M, A):
    """Adapter indices of a batch: skewed (3/4 of the rows on adapter 0, the
    rest spread evenly), adapters 1 and 3 with no row, every row out of
    range, or -1 and A among the others."""
    idx = torch.randint(0, A, (M,), generator=gen, device="cuda")
    if kind == "skewed":
        idx = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.75, 0, 1 + idx % (A - 1))
    elif kind == "empty":
        idx = torch.where((idx == 1) | (idx == 3), 2, idx)
    elif kind == "all_out":
        idx = torch.where(idx % 2 == 0, -1, A + idx)
    elif kind == "mixed_out":
        idx[::5] = -1
        idx[2::9] = A
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["skewed", "empty", "all_out", "mixed_out"])
# 8000 rows: the plan reads idx in two batches; rank 16 has one team, rank 64
# takes the L2 kernel
@pytest.mark.parametrize("M,K,N,r,A", [(1000, 300, 250, 8, 8), (4096, 896, 896, 8, 8), (4096, 896, 896, 16, 64),
                                       (777, 301, 131, 4, 5), (300, 64, 40, 64, 4), (8000, 896, 896, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sparse_lora_segments_match_plain(cuda, kind, M, K, N, r, A, dtype):
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = _segments(cuda, kind, M, A)
    y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 0.5)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 0.5))
    out = (idx < 0) | (idx >= A)
    assert bool((y[out] == 0).all())
    frozen = mask[idx.clamp(0, A - 1)] == 0
    assert bool((y[frozen & ~out[:, None]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", [(4096, 896, 896, 8), (1000, 300, 250, 4), (777, 301, 131, 16),
                                     (1000, 896, 128, 64)])
@pytest.mark.parametrize("A", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sparse_lora_one_adapter_equals_single(cuda, M, K, N, r, A, dtype):
    """Every row on adapter 0: B5's bits where both take the resident kernel
    (the same per-tile code), else B5 within the tolerance."""
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = torch.zeros(M, dtype=torch.int32, device="cuda")
    y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 1.5)
    y5 = ops.sparse_lora_apply(x, a[0], b[0], mask[0], 1.5)
    torch.cuda.synchronize()
    if _sgmv(M, K, N, r, A, dtype):
        assert torch.equal(y, y5)
    else:
        assert_lora_close(y, y5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "skewed", "empty", "all_out", "mixed_out"])
@pytest.mark.parametrize("M,A", [(4096, 8), (1000, 3), (4096, 64), (16 * 132 * 64 + 5, 7)])
def test_sgmv_plan_matches_twin(cuda, kind, M, A):
    """The SGMV kernel's plan (rows sorted by segment, stably, and the
    segments' offsets) equals its plain twin; every row is placed once."""
    K, N, r = 64, 40, 8
    x, a, b, mask = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    idx = _segments(cuda, kind, M, A).int()
    assert _sgmv(M, K, N, r, A, torch.bfloat16)
    plan = torch.full((M + A + 2,), -7, dtype=torch.int32, device="cuda")
    y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    sparse_lora.sparse_lora_launch(y, x, a, b, mask, idx, scale=0.5, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(plan, sparse_lora.sgmv_plan(idx, A))
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 0.5))


def _replays_equal_eager(fn, inputs, fresh):
    """``fn(*inputs)`` captured in a CUDA graph, replayed after ``fresh``
    values are copied into the captured inputs: equal to an eager call on
    them. A host sync inside ``fn`` would fail the capture."""
    fn(*inputs)  # warm-up: the library built, the kernel's attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    for t, v in zip(inputs, fresh):
        if isinstance(t, torch.Tensor):
            t.copy_(v)
    graph.replay()
    want = fn(*fresh)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 64])
def test_packed_and_batched_capture_in_a_cuda_graph(cuda, r):
    M, K, N, A = 1000, 896, 896, 8
    x, a, b, mask = _lora(cuda, M, K, N, r, torch.bfloat16)
    x2, a2, b2, mask2 = _lora(cuda, M, K, N, r, torch.bfloat16)
    before = ops.sparse_lora_apply_packed.launches
    _replays_equal_eager(lambda *t: ops.sparse_lora_apply_packed(*t, 2.0), [x, a, b, mask], [x2, a2, b2, mask2])
    assert ops.sparse_lora_apply_packed.launches == before + 3  # warm-up, capture, eager
    xb, ab, bb, mb = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    fresh = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    idx = _segments(cuda, "mixed_out", M, A)
    _replays_equal_eager(lambda x_, i_, a_, b_, m_: ops.batched_sparse_lora_apply(x_, i_, a_, b_, m_, 2.0),
                         [xb, idx, ab, bb, mb], [fresh[0], _segments(cuda, "skewed", M, A)] + list(fresh[1:]))


# the few-row path (at most FEW_MAX_ROWS rows, fewer than 16 an adapter):
# decode widths of the served configs and ragged ones, one row to 64, ranks
# 1-64, adapters shared by rows, out of range and owning no row
FEW_CASES = [  # M, K, N, A
    (8, 896, 896, 8), (8, 2048, 8512, 8), (8, 4096, 2048, 8), (1, 896, 128, 1), (8, 2560, 2560, 4),
    (8, 1024, 2048, 8), (33, 300, 250, 5), (64, 896, 896, 64), (64, 7, 5, 5), (17, 4096, 13696, 6),
    # zamba2-7b's in_proj, out_proj and shared block; llama4's wq and wk
    (8, 3584, 14576, 8), (8, 7168, 3584, 8), (8, 3584, 3584, 8), (8, 5120, 5120, 4), (8, 5120, 1024, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,A", FEW_CASES)
@pytest.mark.parametrize("r", [1, 8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_few_row_path_matches_plain(cuda, M, K, N, A, r, dtype):
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = torch.randint(0, A, (M,), generator=cuda, device="cuda")
    if M > 2:
        idx[1] = A  # out of range: zeros
        idx[2] = -1
    assert sparse_lora.batched_path(M, K, N, r, dtype, A) == "few_rows"
    before = _b7_launches()
    y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 1.5)
    _b7_counted(before, M, K, N, r, A, dtype)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 1.5))
    out = (idx < 0) | (idx >= A)
    assert bool((y[out] == 0).all())
    frozen = mask[idx.clamp(0, A - 1)] == 0
    assert bool((y[frozen & ~out[:, None]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["skewed", "empty", "all_out", "mixed_out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_few_row_path_segments_match_plain(cuda, kind, dtype):
    M, K, N, r, A = 64, 896, 896, 8, 8
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = _segments(cuda, kind, M, A)
    y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 0.5)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 0.5))
    assert bool((y[(idx < 0) | (idx >= A)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 16, 64])
def test_few_row_path_captures_in_a_cuda_graph(cuda, r):
    """Both launches (the second behind the first with programmatic stream
    serialization) are captured and replayed on fresh inputs."""
    M, K, N, A = 8, 2048, 8512, 8
    xb, ab, bb, mb = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    fresh = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    idx = torch.arange(M, device="cuda", dtype=torch.int32)
    idx[3] = A
    fresh_idx = torch.randint(0, A, (M,), generator=cuda, device="cuda", dtype=torch.int32)
    before = _b7_launches()
    _replays_equal_eager(lambda x_, i_, a_, b_, m_: ops.batched_sparse_lora_apply(x_, i_, a_, b_, m_, 2.0),
                         [xb, idx, ab, bb, mb], [fresh[0], fresh_idx] + list(fresh[1:]))
    assert _b7_launches()[1] == before[1] + 3  # warm-up, capture, eager


@pytest.mark.cuda
def test_b7_entry_takes_the_few_row_path_with_its_scratch(cuda):
    """One C entry picks B7's path: at the few-row widths a launch without
    the scratch takes the L2 kernel (the kernel timed beside the path), and
    a scratch is refused where the path takes none."""
    lib = sparse_lora.library()

    def launch(y, x, idx, a, b, mask, scratch):
        M, K = x.shape
        A, r, N = b.shape
        return lib.repro_sparse_lora(y.data_ptr(), x.data_ptr(), idx.data_ptr(), a.data_ptr(), b.data_ptr(),
                                     mask.data_ptr(), None, scratch.data_ptr() if scratch is not None else None,
                                     M, K, N, r, A, 1, 0, 1.5, torch.cuda.current_stream().cuda_stream)

    x, a, b, mask = _batched(cuda, 8, 896, 896, 8, 8, torch.bfloat16)
    idx = torch.arange(8, dtype=torch.int32, device="cuda")
    y = torch.empty(8, 896, dtype=torch.bfloat16, device="cuda")
    assert launch(y, x, idx, a, b, mask, None) == 0
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 1.5))
    scratch = torch.empty(1 << 16, device="cuda")
    x, a, b, mask = _batched(cuda, 64, 896, 896, 8, 4, torch.bfloat16)
    idx = torch.arange(4, dtype=torch.int32, device="cuda").repeat_interleave(16)
    assert sparse_lora.batched_path(64, 896, 896, 8, torch.bfloat16, 4) == "sgmv"
    assert launch(torch.empty(64, 896, dtype=torch.bfloat16, device="cuda"), x, idx, a, b, mask, scratch) != 0


@pytest.mark.cuda
def test_decode_shapes_take_the_few_row_path(cuda):
    """A decode step's per-slot LoRA (8 slots, one row each, rank 8) at every
    served config's widths (every LoRA group's targets, the hybrid's
    unstacked shared block included) takes the few-row path; 65 rows do
    not, nor 64 rows on 4 adapters where the SGMV kernel stages them."""
    from repro_torch.configs import ARCHS
    from repro_torch.lora import init_lora

    gen = torch.Generator().manual_seed(0)
    for name, cfg in ARCHS.items():
        targets = [(t, ab) for group in init_lora(gen, cfg, "cpu").values() for t, ab in group.items()]
        for target, ab in targets:
            K, N = ab["a"].shape[-2], ab["b"].shape[-1]
            for dtype in (torch.float32, torch.bfloat16):
                assert sparse_lora.batched_path(8, K, N, cfg.lora_rank, dtype, 8) == "few_rows", (name, target)
                assert sparse_lora.batched_path(65, K, N, cfg.lora_rank, dtype, 8) != "few_rows", (name, target)
    assert sparse_lora.batched_path(64, 896, 896, 8, torch.bfloat16, 4) == "sgmv"
    with pytest.raises(ValueError, match="plan"):
        x, a, b, mask = _batched(cuda, 8, 64, 40, 8, 2, torch.bfloat16)
        sparse_lora.sparse_lora_launch(torch.empty(8, 40, dtype=torch.bfloat16, device="cuda"), x, a, b, mask,
                                       torch.zeros(8, dtype=torch.int32, device="cuda"),
                                       plan=torch.empty(12, dtype=torch.int32, device="cuda"))


# the split path (more than FEW_MAX_ROWS rows whose adapters do not stage
# for SGMV): every width of BATCHED_PATHS that takes it, rows in every kind of
# segment, x off a 16-byte boundary
SPLIT_KINDS = ["random", "skewed", "empty", "all_out", "mixed_out", "on0", "slots"]


def _split_rows(gen, kind, M, A):
    """The segments of ``_segments``, every row on adapter 0, or the serve
    path's slot-contiguous rows (M // A rows a slot, the rest out of range)."""
    if kind == "on0" or (kind == "skewed" and A == 1):
        return torch.zeros(M, dtype=torch.int32, device="cuda")
    if kind == "slots":
        return torch.clamp(torch.arange(M, device="cuda") // (M // A), max=A).int()
    return _segments(gen, kind, M, A)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r,A", BATCHED_PATHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_path_matches_plain(cuda, M, K, N, r, A, dtype):
    """Where SGMV does not stage the adapters, the split path takes the
    launch and matches the plain version in every kind of segment; rows out
    of range are exact zeros, and so is each row's own frozen column."""
    if _sgmv(M, K, N, r, A, dtype):
        assert sparse_lora.batched_path(M, K, N, r, dtype, A) == "sgmv"
        return
    assert M > sparse_lora.FEW_MAX_ROWS and sparse_lora.batched_path(M, K, N, r, dtype, A) == "split"
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    for kind in SPLIT_KINDS:
        idx = _split_rows(cuda, kind, M, A)
        before = _b7_launches()
        y = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 0.5)
        _b7_counted(before, M, K, N, r, A, dtype)
        torch.cuda.synchronize()
        assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 0.5))
        out = (idx < 0) | (idx >= A)
        assert bool((y[out] == 0).all()), kind
        frozen = mask[idx.clamp(0, A - 1)] == 0
        assert bool((y[frozen & ~out[:, None]] == 0).all()), kind


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r,A", [(1000, 300, 250, 8, 64), (4096, 3584, 14576, 8, 4), (777, 301, 131, 64, 5),
                                       (300, 1000, 2000, 12, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_path_takes_misaligned_views(cuda, M, K, N, r, A, dtype):
    """x, y and the adapters off a 16-byte boundary (element by element
    copies and stores), against the plain version."""
    x, a, b, mask = _batched(cuda, M, K, N, r, A, dtype)
    idx = _split_rows(cuda, "mixed_out", M, A).int()

    def off(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
        return v.copy_(t)

    y = torch.empty(M * N + 1, dtype=dtype, device="cuda")[1:].view(M, N)
    assert sparse_lora.sparse_lora_launch(y, off(x), off(a), off(b), off(mask), idx, scale=0.5) == "split"
    torch.cuda.synchronize()
    assert_lora_close(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r,A", [(4096, 2048, 8512, 8, 4), (1024, 2560, 2560, 8, 1), (1000, 300, 250, 64, 8)])
def test_split_path_is_the_same_every_run(cuda, M, K, N, r, A):
    """No atomics and a fixed order of summation: two launches on the same
    inputs give the same bits."""
    x, a, b, mask = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    idx = _split_rows(cuda, "slots", M, A)
    y1 = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 2.0)
    y2 = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4, 8, 16, 64])
def test_split_path_captures_in_a_cuda_graph(cuda, r):
    """Both launches (the expand behind the shrink with programmatic stream
    serialization) are captured and replayed on fresh inputs."""
    M, K, N, A = 1024, 2048, 8512, 4
    assert sparse_lora.batched_path(M, K, N, r, torch.bfloat16, A) == "split"
    xb, ab, bb, mb = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    fresh = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    before = _b7_launches()
    _replays_equal_eager(lambda x_, i_, a_, b_, m_: ops.batched_sparse_lora_apply(x_, i_, a_, b_, m_, 2.0),
                         [xb, _split_rows(cuda, "slots", M, A), ab, bb, mb],
                         [fresh[0], _split_rows(cuda, "mixed_out", M, A)] + list(fresh[1:]))
    assert _b7_launches()[2] == before[2] + 3  # warm-up, capture, eager


@pytest.mark.cuda
def test_b7_entry_takes_the_split_path_with_its_scratch(cuda):
    """At the split path's widths a launch without the scratch takes the L2
    kernel (the kernel timed beside the path), and both match the plain
    version."""
    lib = sparse_lora.library()
    M, K, N, r, A = 1024, 2048, 8512, 8, 4
    x, a, b, mask = _batched(cuda, M, K, N, r, A, torch.bfloat16)
    idx = _split_rows(cuda, "slots", M, A)
    assert sparse_lora.batched_path(M, K, N, r, torch.bfloat16, A) == "split"
    y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    assert lib.repro_sparse_lora(y.data_ptr(), x.data_ptr(), idx.data_ptr(), a.data_ptr(), b.data_ptr(),
                                 mask.data_ptr(), None, None, M, K, N, r, A, 1, 0, 1.5,
                                 torch.cuda.current_stream().cuda_stream) == 0
    y2 = ops.batched_sparse_lora_apply(x, idx, a, b, mask, 1.5)
    torch.cuda.synchronize()
    want = ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, 1.5)
    assert_lora_close(y, want)
    assert_lora_close(y2, want)


@pytest.mark.cuda
def test_prefill_shapes_take_the_split_path(cuda):
    """A served prefill's per-slot LoRA (1 x 1024, 4 x 128 and 4 x 1024 rows
    over one adapter a prompt, rank 8) at every config's widths takes SGMV
    where the adapters stage and the split path everywhere else: no served
    shape is left on the L2 kernel."""
    from repro_torch.configs import ARCHS
    from repro_torch.lora import init_lora

    gen = torch.Generator().manual_seed(0)
    split = 0
    for name, cfg in ARCHS.items():
        targets = [(t, ab) for group in init_lora(gen, cfg, "cpu").values() for t, ab in group.items()]
        for target, ab in targets:
            K, N = ab["a"].shape[-2], ab["b"].shape[-1]
            for dtype in (torch.float32, torch.bfloat16):
                for g, S in ((1, 1024), (4, 128), (4, 1024)):
                    stages = sparse_lora.resident_stages(K, N, cfg.lora_rank, dtype, adapters=g, rows=g * S)
                    path = sparse_lora.batched_path(g * S, K, N, cfg.lora_rank, dtype, g)
                    assert path == ("sgmv" if stages else "split"), (name, target, g, S)
                    split += path == "split"
    assert split > 0


# the single-adapter product's two kernels: a and b ⊙ mask resident in
# shared memory (rank up to 16 where they fit) or read from L2 (rank 64)
LORA_MASKS = {"zero": 0.0, "one": 1.1, "half": 0.5}


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 16, 64])
@pytest.mark.parametrize("N", [1, 128, 896])
@pytest.mark.parametrize("mask_kind", list(LORA_MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_lora_single_adapter_paths_match_plain(cuda, r, N, mask_kind, dtype):
    M, K = 1000, 896  # rows past the last whole tile of 16
    x, a, b, _ = _lora(cuda, M, K, N, r, dtype)
    mask = (torch.rand(N, generator=cuda, device="cuda") < LORA_MASKS[mask_kind]).float()
    stages = sparse_lora.resident_stages(K, N, r, dtype)
    assert (stages > 0) == (r <= 8 or (r == 16 and (dtype == torch.bfloat16 or N < 896)))
    y = ops.sparse_lora_apply(x, a, b, mask, 0.5)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.sparse_lora_matmul_ref(x, a, b, mask, 0.5))
    assert bool((y[:, mask == 0] == 0).all())
    yp = ops.sparse_lora_apply_packed(x, a, b, mask, 0.5)
    torch.cuda.synchronize()
    assert_lora_close(yp, y)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [7, 300, 301, 1000])
@pytest.mark.parametrize("r", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_lora_resident_ragged_k_matches_plain(cuda, K, r, dtype):
    """K whose rows allow no 16-byte copies (odd, or not a multiple of 8 in
    bf16) goes element by element; rows and columns off the tiles."""
    x, a, b, mask = _lora(cuda, 777, K, 250, r, dtype)
    assert sparse_lora.resident_stages(K, 250, r, dtype) > 0
    y = ops.sparse_lora_apply(x, a, b, mask, 1.5)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.sparse_lora_matmul_ref(x, a, b, mask, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 4096, 16 * 132 * 6 + 5])
def test_sparse_lora_resident_rows_and_unaligned_x(cuda, dtype, M):
    """From one row to more tiles than the ring holds per block, with x at an
    aligned and at a misaligned address (the same values)."""
    K, N, r = 896, 896, 8
    _, a, b, mask = _lora(cuda, 1, K, N, r, dtype)
    x = torch.empty(M * K + 1, device="cuda", dtype=dtype)[1:].view(M, K)
    x.copy_(torch.randn(M, K, generator=cuda, device="cuda"))
    assert x.data_ptr() % 16
    y = ops.sparse_lora_apply(x, a, b, mask, 2.0)
    y_aligned = ops.sparse_lora_apply(x.clone(), a, b, mask, 2.0)
    torch.cuda.synchronize()
    assert_lora_close(y, ref.sparse_lora_matmul_ref(x, a, b, mask, 2.0))
    assert torch.equal(y, y_aligned)  # the same sums in the same order


@pytest.mark.cuda
def test_sparse_lora_launcher_refuses_what_it_cannot_run(cuda):
    x, a, b, mask = _lora(cuda, 8, 16, 12, 65, torch.float32)
    with pytest.raises(ValueError, match="rank"):
        ops.sparse_lora_apply(x, a, b, mask)
    x, a, b, mask = _lora(cuda, 8, 16, 12, 4, torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        ops.sparse_lora_apply(x, a, b, mask)


# --- B8: flash attention ---


def assert_attention_close(out, plain, v):
    """An output row is a convex combination of v's rows; the kernel takes
    the scores, exponentials and sums in another order than the plain
    version, so f32 outputs agree within 1e-5 of the largest |v|, and bf16
    outputs, which round those f32 values, to that plus one bf16 ulp."""
    assert out.dtype == plain.dtype and out.shape == plain.shape
    o, p = out.float(), plain.float()
    allowed = 1e-5 * v.float().abs().max()
    if out.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(o.abs(), p.abs()))
        allowed = allowed + torch.ldexp(torch.ones_like(o), e - 8)
    assert bool(((o - p).abs() <= allowed).all()), float((o - p).abs().max())


FLASH_CASES = [  # B, S, H, KVH, D, causal, window
    (2, 256, 4, 2, 64, True, None),
    (2, 256, 8, 1, 128, True, 128),
    (1, 300, 14, 2, 64, True, 100),  # ragged; rows whose first visited tile is wholly masked
    (1, 1000, 4, 2, 64, True, 300),  # S > window + tile
    (1, 321, 4, 4, 128, True, 64),  # a window of one tile
    (1, 200, 4, 4, 128, False, None),
    (1, 200, 4, 2, 64, False, 50),
    (3, 1, 2, 1, 64, True, None),
    (1, 70, 6, 3, 64, True, 9000),  # a window longer than the sequence
    # D 80 (stablelm-3b: 32 heads, MHA), ragged S, with and without the window
    (1, 300, 4, 4, 80, True, None),
    (2, 256, 4, 2, 80, True, 100),
    (1, 200, 4, 4, 80, False, None),
    # D 112 (zamba2-7b: 32 heads, MHA, no window), ragged S, with and without a window
    (1, 300, 4, 4, 112, True, None),
    (2, 256, 4, 2, 112, True, 100),
    (1, 200, 4, 4, 112, False, None),
    # ragged S of 100, 200 and 1000, windows that cut a 128-key tile (1, 63,
    # 129), GQA ratios of 7 and 8, bidirectional, at every head_dim
    (1, 100, 7, 1, 64, True, 1),
    (2, 200, 8, 1, 128, True, 63),
    (1, 1000, 14, 2, 64, True, 129),
    (1, 1000, 8, 1, 80, False, None),
    (2, 200, 4, 4, 112, True, 63),
    (1, 100, 4, 4, 112, False, 129),
    (1, 1000, 8, 1, 256, True, 129),
    (2, 200, 7, 1, 256, False, 63),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KVH, D, causal, window, dtype):
    q = torch.randn(B, S, H, D, generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, KVH, D, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window), v)


@pytest.mark.cuda
def test_flash_attention_query_slices_match_whole(cuda):
    """The plain version by slices of query rows (how long sequences are
    checked) equals it whole."""
    q = torch.randn(1, 384, 4, 64, generator=cuda, device="cuda")
    k, v = (torch.randn(1, 384, 2, 64, generator=cuda, device="cuda") for _ in range(2))
    whole = ref.flash_attention_gqa_ref(q, k, v, causal=True, window=100)
    parts = [ref.flash_attention_gqa_ref(q[:, r:r + 128], k, v, causal=True, window=100, q_offset=r)
             for r in range(0, 384, 128)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), whole)


def wgmma_smem(D):
    """The bf16 kernel's shared memory: 1024 bytes of alignment slack, Q
    (128 rows), two stages of K and V tiles (128 keys, 64 at D 256), rows
    of D padded to 64, 128 or 256 columns, and 10 mbarriers of 8 bytes."""
    width = 64 if D <= 64 else 128 if D <= 128 else 256
    keys = 128 if D <= 128 else 64
    return 1024 + (128 + 2 * 2 * keys) * width * 2 + 8 * 10


def f32_smem(D):
    return (D * 68 + D * 65 + 64 * D + 64 * 68) * 4


@pytest.mark.cuda
def test_flash_attention_head_dim_80_opts_into_its_shared_memory(cuda):
    """D 80 pads its 160-byte rows to 128 columns in shared memory only (bf16:
    Q and two K/V stages, 164944 bytes, over the 48 KB default) and the f32
    kernel's tiles (80448)."""
    lay = flash_attention.layout(80, torch.bfloat16)
    assert lay["smem_bytes"] == wgmma_smem(80) == 164944
    assert flash_attention.layout(80, torch.float32)["smem_bytes"] == f32_smem(80)
    assert (lay["query_rows"], lay["key_tile"], lay["stages"], lay["smem_width"], lay["threads"]) == (128, 128, 2, 128, 384)
    assert lay["local_bytes"] == 0
    q = torch.randn(1, 1024, 32, 80, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(1, 1024, 32, 80, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=True, window=8192)
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=True, window=8192), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.layout(96, torch.bfloat16)


@pytest.mark.cuda
def test_flash_attention_head_dim_112_opts_into_its_shared_memory(cuda):
    """D 112 pads its 224-byte rows to 128 columns in shared memory (bf16:
    164944 bytes) beside the f32 kernel's tiles (105664); zamba2-7b's prefill
    shape (32 heads, causal, no window) in bf16 and f32."""
    lay = flash_attention.layout(112, torch.bfloat16)
    assert lay["smem_bytes"] == wgmma_smem(112) == 164944 and lay["smem_width"] == 128
    assert flash_attention.layout(112, torch.float32)["smem_bytes"] == f32_smem(112)
    for dtype, S in ((torch.bfloat16, 1024), (torch.float32, 333)):
        q = torch.randn(2, S, 32, 112, generator=cuda, device="cuda").to(dtype)
        k, v = (torch.randn(2, S, 32, 112, generator=cuda, device="cuda").to(dtype) for _ in range(2))
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=True), v)


@pytest.mark.cuda
def test_flash_attention_head_dim_256_opts_into_its_shared_memory(cuda):
    """D 256 stages Q and two K/V stages of 64 keys x 512 bytes (bf16:
    197712 bytes) beside the f32 kernel's tiles (219136); paligemma-3b's
    heads (8 over 1 KV head) causal in bf16 under the model's window, f32 at
    a ragged S with a window, and bidirectional."""
    lay = flash_attention.layout(256, torch.bfloat16)
    assert lay["smem_bytes"] == wgmma_smem(256) == 197712
    assert flash_attention.layout(256, torch.float32)["smem_bytes"] == f32_smem(256)
    assert (lay["key_tile"], lay["smem_width"], lay["local_bytes"]) == (64, 256, 0)
    for dtype, S, causal, window in ((torch.bfloat16, 1280, True, 8192), (torch.float32, 333, True, 100),
                                     (torch.bfloat16, 300, False, None)):
        q = torch.randn(2, S, 8, 256, generator=cuda, device="cuda").to(dtype)
        k, v = (torch.randn(2, S, 1, 256, generator=cuda, device="cuda").to(dtype) for _ in range(2))
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bidirectional_at_whisper_encoder_width(cuda, dtype):
    """whisper-large-v3's encoder attention: 1500 frames (a ragged last
    tile of 28 keys), 20 heads of 64, no mask."""
    q, k, v = (torch.randn(1, 1500, 20, 64, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=False), v)


@pytest.mark.cuda
def test_flash_attention_mixed_dtypes_and_refusals(cuda):
    q = torch.randn(1, 130, 4, 64, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(1, 130, 2, 64, generator=cuda, device="cuda") for _ in range(2))
    out = ops.flash_attention(q, k, v)  # f32 k, v: the kernel runs in f32, out in q's dtype
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v), v)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(torch.zeros(1, 8, 2, 32, device="cuda"), torch.zeros(1, 8, 2, 32, device="cuda"),
                            torch.zeros(1, 8, 2, 32, device="cuda"))


# the bf16 tensor-core kernel: every case above, ragged S off the tile grid
# (17, 129), H 14 over one KV head, a non-causal window with B 2, D 128 at S
# 1000; and more query tiles than the card has SMs, so that each block of
# the persistent grid walks several (its K/V ring and Q buffer reused from
# tile to tile)
FLASH_TC_CASES = FLASH_CASES + [
    (2, 17, 4, 2, 64, True, None),
    (1, 129, 4, 2, 128, True, 100),
    (1, 300, 14, 1, 64, True, None),
    (2, 300, 4, 2, 64, False, 100),
    (1, 1000, 4, 2, 128, True, None),
    (4, 1000, 16, 2, 64, True, 129),
    (3, 700, 32, 4, 128, False, None),
    (2, 1300, 8, 1, 256, True, None),
    (4, 600, 24, 24, 80, True, 63),
    (4, 600, 24, 24, 112, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,causal,window", FLASH_TC_CASES)
def test_flash_attention_tensor_core_kernel_matches_plain(cuda, B, S, H, KVH, D, causal, window):
    q = torch.randn(B, S, H, D, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KVH, D, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window), v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,causal,window", [
    (2, 256, 4, 2, 64, True, None), (2, 256, 8, 1, 128, True, 128), (1, 300, 14, 2, 64, True, 100),
    (1, 200, 4, 2, 64, False, 50), (1, 300, 14, 1, 64, True, None), (1, 1000, 4, 2, 128, True, None),
    (2, 256, 4, 2, 80, True, 100), (2, 256, 4, 2, 112, True, 100),
])
def test_flash_attention_kernels_agree(cuda, B, S, H, KVH, D, causal, window):
    """The same bf16 inputs through the tensor-core kernel and, cast to
    f32, through the CUDA-core kernel agree within the attention tolerance."""
    q = torch.randn(B, S, H, D, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KVH, D, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    tc = ops.flash_attention(q, k, v, causal=causal, window=window)
    cc = ops.flash_attention(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.cuda.synchronize()
    assert cc.dtype == torch.float32
    assert_attention_close(tc, cc.bfloat16(), v)


@pytest.mark.cuda
def test_flash_attention_unaligned_bf16_matches_plain(cuda):
    """bf16 at an address off 16 bytes: the wrapper copies it to aligned
    storage for the tensor-core kernel, whose launcher refuses the view."""
    B, S, H, KVH, D = 1, 130, 4, 2, 64
    q = torch.randn(B * S * H * D + 1, generator=cuda, device="cuda").bfloat16()[1:].view(B, S, H, D)
    k, v = (torch.randn(B * S * KVH * D + 1, generator=cuda, device="cuda").bfloat16()[1:].view(B, S, KVH, D)
            for _ in range(2))
    assert q.data_ptr() % 16 != 0
    out = ops.flash_attention(q, k, v, causal=True, window=50)
    torch.cuda.synchronize()
    assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=True, window=50), v)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention_launch(torch.empty_like(q), q, k, v, causal=True, window=50)


@pytest.mark.cuda
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_reruns_are_bit_identical(cuda, D):
    """The bf16 kernel sums in a fixed order: a second launch on the same
    inputs gives the same bits (causal with a window, and bidirectional)."""
    q = torch.randn(2, 700, 8, D, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(2, 700, 2, D, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    for causal, window in ((True, 300), (False, None)):
        first = ops.flash_attention(q, k, v, causal=causal, window=window)
        second = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 256])
def test_flash_attention_graph_of_two_launches_on_different_buffers(cuda, D):
    """A CUDA graph captures each launch's tensor maps by value: two launches
    on different inputs and outputs replay into their own results, equal to
    eager launches bit for bit."""
    shapes = ((1, 300, 4, 2), (2, 129, 8, 1))
    ins = [tuple(torch.randn(B, S, h, D, generator=cuda, device="cuda").bfloat16() for h in (H, KVH, KVH))
           for B, S, H, KVH in shapes]
    outs = [torch.empty_like(q) for q, _, _ in ins]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for (q, k, v), out in zip(ins, outs):
            flash_attention.flash_attention_launch(out, q, k, v, causal=True, window=None)
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for (q, k, v), out in zip(ins, outs):
        assert torch.equal(out, ops.flash_attention(q, k, v, causal=True))
        assert_attention_close(out, ref.flash_attention_gqa_ref(q, k, v, causal=True), v)


def sass_by_function(lib_path):
    """``cuobjdump -sass`` of a built library, as function name -> its SASS."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    functions, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            functions[name] = []
        elif name is not None:
            functions[name].append(line)
    return {n: "\n".join(lines) for n, lines in functions.items()}


@pytest.mark.cuda
def test_flash_attention_bf16_kernels_run_wgmma_on_tma_tiles(cuda):
    """Every bf16 instantiation (one per head_dim) issues HGMMA (wgmma) and
    UTMALDG (TMA tile loads) in its SASS."""
    from repro_torch.kernels import build

    flash_attention.library()
    sass = sass_by_function(build.library_path(flash_attention.SOURCE))
    wgmma = {n: body for n, body in sass.items() if "flash_attention_wgmma_kernel" in n}
    assert sorted(int(n.split("ILi", 1)[1].split("E", 1)[0]) for n in wgmma) == sorted(flash_attention.HEAD_DIMS)
    for name, body in wgmma.items():
        assert "HGMMA" in body and "UTMALDG" in body, name


# --- B9: the SSD intra-chunk scan ---


def mamba_decays(gen, G, Q, nh):
    """a = -exp(A_log)·dt as the Mamba2 initializer draws them: A from 1 to
    16 over the heads, dt log-uniform in [1e-3, 0.1] (here per step)."""
    A = torch.linspace(1.0, 16.0, nh, device="cuda").repeat(G // nh + 1)[:G]
    u = torch.rand(G, 1, Q, generator=gen, device="cuda")
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return -A[:, None, None] * dt


def assert_ssd_close(y, x, a, b, c):
    """The kernel sums c·b, the scan of a and M·x in other orders than the
    plain version. The sums err by a few ulp of their absolute terms, and a
    decay exp(cs_i - cs_j) by a few ulp of |cs|, so the bound per output is
    (1e-5 + 1e-6·max|cs|) times the sum of the absolute terms
    (the plain version on |x|, |b|, |c|)."""
    plain = ref.ssd_chunk_intra_ref(x, a, b, c)
    assert y.dtype == torch.float32 and y.shape == plain.shape
    terms = ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs())
    cs_max = float(a.float().sum(dim=-1).abs().max())
    allowed = (1e-5 + 1e-6 * cs_max) * terms
    assert bool(((y - plain).abs() <= allowed).all()), float(((y - plain).abs() / terms.clamp_min(1e-30)).max())


# the JAX tests' shapes, mamba2's, and Q, hd and N with and without padding
# to the kernel's tiles (16 rows, 64 or 128 columns of hd, 32 of N)
SSD_CASES = [(128, 64, 32), (128, 128, 128), (64, 32, 16), (72, 20, 33)] + [
    (Q, hd, N) for Q in (8, 24, 64, 128) for hd in (4, 20, 64, 128) for N in (1, 5, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,hd,N", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_matches_plain(cuda, Q, hd, N, dtype, a_dtype):
    G, nh = 12, 4
    x = torch.randn(G, Q, hd, generator=cuda, device="cuda").to(dtype)
    b, c = (torch.randn(G, Q, N, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    a = mamba_decays(cuda, G, Q, nh).to(a_dtype)
    before = ops.ssd_chunk_intra.launches
    y = ops.ssd_chunk_intra(x, a, b, c)
    assert ops.ssd_chunk_intra.launches == before + 1
    torch.cuda.synchronize()
    assert_ssd_close(y, x, a, b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_unaligned_views(cuda, dtype):
    """Inputs off a 16-byte boundary are copied element by element."""
    G, Q, hd, N = 6, 128, 64, 128

    def shifted(*shape):
        t = torch.empty(math.prod(shape) + 1, device="cuda", dtype=dtype)[1:].view(*shape)
        return t.copy_(torch.randn(shape, generator=cuda, device="cuda"))

    x, b, c = shifted(G, Q, hd), shifted(G, Q, N), shifted(G, Q, N)
    assert x.data_ptr() % 16 and b.data_ptr() % 16
    a = mamba_decays(cuda, G, Q, 2)
    y = ops.ssd_chunk_intra(x, a, b, c)
    torch.cuda.synchronize()
    assert_ssd_close(y, x, a, b, c)
    assert torch.equal(y, ops.ssd_chunk_intra(x.clone(), a, b.clone(), c.clone()))


def _offset(t):
    """``t``'s values in a view one element past a 16-byte boundary: TMA
    cannot take it, so the kernel copies its tiles itself."""
    v = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:].view(t.shape)
    return v.copy_(t)


# phase 5c's small and ragged B9 shapes (chip_smoke.py SSD_SMALL, SSD_RAGGED)
SSD_ROUTE_CASES = [(128, 64, 32), (128, 128, 128), (64, 32, 16)] + [
    (Q, hd, N) for Q in (8, 24, 64, 128) for hd in (4, 20, 64, 128) for N in (1, 5, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,hd,N", SSD_ROUTE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_both_load_routes(cuda, Q, hd, N, dtype):
    """Each shape through TMA where the shape allows it (rows of x, b and c
    whole multiples of 16 bytes) and through the kernel's own copies (inputs
    off a 16-byte boundary): each launch on the route it should take, both
    within the tolerance of the plain version, and the same bits."""
    G = 4
    x = torch.randn(G, Q, hd, generator=cuda, device="cuda").to(dtype)
    b, c = (torch.randn(G, Q, N, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    a = mamba_decays(cuda, G, Q, 2)
    tma = hd * x.element_size() % 16 == 0 and N * x.element_size() % 16 == 0
    copies = ssd_chunk.copy_route_launches()
    y = ops.ssd_chunk_intra(x, a, b, c)
    assert ssd_chunk.copy_route_launches() == copies + (not tma)
    xo, bo, co = _offset(x), _offset(b), _offset(c)
    assert xo.data_ptr() % 16 and bo.data_ptr() % 16 and co.data_ptr() % 16
    y_copy = ops.ssd_chunk_intra(xo, a, bo, co)
    assert ssd_chunk.copy_route_launches() == copies + (not tma) + 1
    torch.cuda.synchronize()
    assert_ssd_close(y, x, a, b, c)
    assert torch.equal(y, y_copy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_same_bits_twice(cuda, dtype):
    """Two launches on the same inputs, and a CUDA graph of two launches,
    give the same bits (no atomics, no order that depends on the run)."""
    x, a, b, c = _ssd_heads_inputs(cuda, 8, 64, 128, 64, 128, dtype)
    y1 = ops.ssd_chunk_intra(x, a, b, c, heads=64)
    y2 = ops.ssd_chunk_intra(x, a, b, c, heads=64)
    outs = [torch.empty_like(y1) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for out in outs:
            ssd_chunk.ssd_chunk_launch(out, x, a, b, c, 64)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(outs[0], y1) and torch.equal(outs[1], y1)


def _ssd_heads_inputs(gen, R, heads, Q, hd, N, dtype):
    G = R * heads
    x = torch.randn(G, Q, hd, generator=gen, device="cuda").to(dtype)
    b, c = (torch.randn(R, Q, N, generator=gen, device="cuda").to(dtype) for _ in range(2))
    return x, mamba_decays(gen, G, Q, heads), b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_head_blocks_that_do_not_divide(cuda, dtype):
    """40 rows of zamba2-7b's 112 heads: the launch's head block leaves a
    short last block a row; each group's bits equal the ``heads=1`` launch
    on b and c expanded, and the plain version holds it."""
    R, heads, Q, hd, N = 40, 112, 128, 64, 64
    lay = ssd_chunk.layout(dtype, R, heads)
    assert heads % lay["head_block"], lay
    x, a, b, c = _ssd_heads_inputs(cuda, R, heads, Q, hd, N, dtype)
    y = ops.ssd_chunk_intra(x, a, b, c, heads=heads)
    bx, cx = (t.repeat_interleave(heads, 0) for t in (b, c))
    torch.cuda.synchronize()
    assert_ssd_close(y, x, a, bx, cx)
    assert torch.equal(y, ops.ssd_chunk_intra(x, a, bx, cx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_single_head(cuda, dtype):
    """One group (the JAX layout), and a sequence of one head (the model's
    layout): both held to the plain version."""
    x = torch.randn(1, 128, 64, generator=cuda, device="cuda").to(dtype)
    b, c = (torch.randn(1, 128, 128, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    a = mamba_decays(cuda, 1, 128, 1)
    y = ops.ssd_chunk_intra(x, a, b, c)
    torch.cuda.synchronize()
    assert_ssd_close(y, x, a, b, c)
    xs = torch.randn(2, 256, 1, 64, generator=cuda, device="cuda").to(dtype)
    bs, cs = (torch.randn(2, 256, 128, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    as_ = seq_decays(cuda, 2, 256, 1)
    ys = ops.ssd_chunk_intra_seq(xs, as_, bs, cs, 128)
    torch.cuda.synchronize()
    assert_ssd_seq_close(ys, xs, as_, bs, cs, 128)


def seq_decays(gen, B, S, nh):
    """:func:`mamba_decays` in the model's (B, S, nh) layout."""
    A = torch.linspace(1.0, 16.0, nh, device="cuda")
    u = torch.rand(B, S, nh, generator=gen, device="cuda")
    return -A * torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))


def assert_ssd_seq_close(y, x, a, b, c, chunk):
    """:func:`assert_ssd_close` for the model's layout."""
    plain = ref.ssd_chunk_intra_seq_ref(x, a, b, c, chunk)
    assert y.dtype == torch.float32 and y.shape == plain.shape
    terms = ref.ssd_chunk_intra_seq_ref(x.abs(), a, b.abs(), c.abs(), chunk)
    B, S, nh = a.shape
    cs_max = float(a.float().reshape(B, S // chunk, chunk, nh).sum(dim=2).abs().max())
    allowed = (1e-5 + 1e-6 * cs_max) * terms
    assert bool(((y - plain).abs() <= allowed).all()), float(((y - plain).abs() / terms.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_chunk_kernel_reads_the_model_layout(cuda, dtype, offset):
    """The model's layout read in place: x (B, S, nh, hd), the decays (B,
    S, nh), b and c column slices of the conv's output (offset 1: off a
    16-byte boundary, the copy route); one launch, held to the plain
    version and equal to the JAX layout's launch on permuted copies."""
    B, S, nh, hd, N, Q = 2, 384, 8, 64, 128, 128
    xbc = torch.randn(B, S, offset + nh * hd + 2 * N, generator=cuda, device="cuda").to(dtype)
    x = xbc[..., offset:offset + nh * hd].reshape(B, S, nh, hd).contiguous()
    b, c = xbc[..., offset + nh * hd:offset + nh * hd + N], xbc[..., offset + nh * hd + N:]
    a = seq_decays(cuda, B, S, nh)
    before, copies = ops.ssd_chunk_intra.launches, ssd_chunk.copy_route_launches()
    y = ops.ssd_chunk_intra_seq(x, a, b, c, Q)
    assert ops.ssd_chunk_intra.launches == before + 1
    assert ssd_chunk.copy_route_launches() == copies + offset  # TMA where the slices are aligned
    torch.cuda.synchronize()
    assert_ssd_seq_close(y, x, a, b, c, Q)
    nc = S // Q
    xg = x.reshape(B, nc, Q, nh, hd).permute(0, 1, 3, 2, 4).reshape(B * nc * nh, Q, hd)
    ag = a.reshape(B, nc, Q, nh).permute(0, 1, 3, 2).reshape(B * nc * nh, 1, Q)
    yg = ops.ssd_chunk_intra(xg, ag, b.reshape(B * nc, Q, N), c.reshape(B * nc, Q, N), heads=nh)
    assert torch.equal(y, yg.reshape(B, nc, nh, Q, hd).permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd))


@pytest.mark.cuda
def test_ssd_chunk_kernels_run_wgmma_on_tma_tiles(cuda):
    """Both routes' kernels (bf16 and f32) issue HGMMA (wgmma) and UTMALDG
    (TMA tile loads) in their SASS."""
    from repro_torch.kernels import build

    ssd_chunk.library()
    sass = sass_by_function(build.library_path(ssd_chunk.SOURCE))
    kernels = {n: body for n, body in sass.items() if "ssd_chunk_kernel" in n}
    assert len(kernels) == 2, sorted(sass)
    for name, body in kernels.items():
        assert "HGMMA" in body and "UTMALDG" in body, name


@pytest.mark.cuda
def test_ssd_chunk_layout_reports_the_launch(cuda):
    """mamba2-1.3b's serve prefill (32 rows of 64 heads) fills the card in
    one wave of units, on either route; the bf16 route (the served one)
    spills nothing, the f32 route (64 bytes with CUDA 12.8's ptxas) no more
    than 128 bytes."""
    for dtype in (torch.bfloat16, torch.float32):
        lay = ssd_chunk.layout(dtype, 32, 64)
        assert lay["threads"] == 384 and lay["rows"] == 128, lay
        assert lay["units"] <= 2 * lay["blocks"] and 64 % lay["head_block"] == 0, lay
    assert ssd_chunk.layout(torch.bfloat16, 32, 64)["local_bytes"] == 0
    assert ssd_chunk.layout(torch.float32, 32, 64)["local_bytes"] <= 128


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_what_it_cannot_run(cuda):
    for Q, hd in ((12, 64), (256, 64), (128, 130)):
        x = torch.zeros(2, Q, hd, device="cuda")
        bc = torch.zeros(2, Q, 16, device="cuda")
        with pytest.raises(ValueError):
            ops.ssd_chunk_intra(x, torch.zeros(2, 1, Q, device="cuda"), bc, bc)


# --- B3 over whole trees: one launch per upload, the threshold selected in
# the kernel (one thread-block cluster per row) ---

MASK_KINDS = ["gal", "shared", "per_client", "none"]


def _compress_tree(gen, shapes, dtype, mask_kind, stacked, special=True):
    """A tree of deltas and residuals of ``shapes`` and the count mask of
    ``mask_kind``: GAL-style (L, 1, 1), one shared mask of a client's leaf
    shape, or one per client of the leaf's full shape. With ``special``
    the first leaf holds a handful of distinct values (ties at every
    threshold; no residual) and, stacked, an all-zero first row."""
    d = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-2).to(dtype) for k, s in shapes.items()}
    r = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3).to(dtype) for k, s in shapes.items()}
    if special:
        first = next(iter(shapes))
        d[first] = (torch.round(d[first].float() * 300) / 300).to(dtype)
        r[first].zero_()
        if stacked:
            d[first][0] = 0.0  # an all-zero row: threshold and scale 0
    client = (lambda s: s[1:]) if stacked else (lambda s: s)
    if mask_kind == "none":
        mk = None
    elif mask_kind == "gal":
        mk = {k: (torch.rand((client(s)[0], 1, 1), generator=gen, device="cuda") < 0.75).float()
              for k, s in shapes.items()}
    elif mask_kind == "shared":
        mk = {k: (torch.rand(client(s), generator=gen, device="cuda") < 0.5).float() for k, s in shapes.items()}
    else:
        mk = {k: (torch.rand(s, generator=gen, device="cuda") < 0.5).float() for k, s in shapes.items()}
    return d, r, mk


def _assert_compress_tree(d, r, mk, y, res, kw, stacked):
    torch.cuda.synchronize()
    for key in d:
        want_y, want_r = plain_fake_compress(d[key], None if r is None else r[key], None if mk is None else mk[key],
                                             stacked=stacked, **kw)
        assert y[key].dtype == d[key].dtype and y[key].shape == d[key].shape
        assert torch.equal(y[key], want_y), key
        assert torch.equal(res[key], want_r), key


@pytest.mark.cuda
@pytest.mark.parametrize("mode", COMPRESS_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("stacked", [False, True])
def test_fake_compress_tree_one_launch_matches_plain(cuda, mode, dtype, mask_kind, stacked):
    """qwen2-0.5b's 8 LoRA leaves, one client or 4 stacked, plus a ragged
    leaf (rows not a multiple of 4 values: the element-by-element path), in
    every mode with each mask kind: one launch, y and the residual bit for
    bit equal to the plain version (its sort), ties and an all-zero row
    included."""
    qmax, ratio, use_thresh = mode
    if mask_kind == "per_client" and not stacked:
        mask_kind = "shared"  # one client: a mask of the leaf's shape is the shared one
    lead = (K,) if stacked else ()
    shapes = {f"{t}_{ab}": lead + s for t, (sa, sb) in LORA_LEAVES.items() for ab, s in (("a", sa), ("b", sb))}
    shapes["z_ragged"] = lead + (24, 7, 131)
    d, r, mk = _compress_tree(cuda, shapes, dtype, mask_kind, stacked)
    kw = dict(qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh)
    for res_tree in (r, None):
        before = ops.fake_compress.launches
        y, res = ops.fake_compress(d, res_tree, mk, stacked=stacked, **kw)
        assert ops.fake_compress.launches == before + 1
        _assert_compress_tree(d, res_tree, mk, y, res, kw, stacked)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [m for m in COMPRESS_MODES if m[2]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["gal", "per_client"])
def test_fake_compress_rows_beyond_shared_memory_match_plain(cuda, mode, dtype, mask_kind):
    """Rows whose cluster slice exceeds the kernel's shared memory (above
    196,608 f32 or 393,216 bf16 values) re-form x from device memory on
    every pass of the select; beside them a row that fits, in one launch."""
    qmax, ratio, use_thresh = mode
    long = 200_000 if dtype == torch.float32 else 400_000
    shapes = {"a_long": (2, 8, long // 8), "b_fits": (2, 8, 1000)}
    d, r, mk = _compress_tree(cuda, shapes, dtype, mask_kind, True)
    kw = dict(qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh)
    y, res = ops.fake_compress(d, r, mk, stacked=True, **kw)
    _assert_compress_tree(d, r, mk, y, res, kw, True)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1e-9, 1.0, 0.5])
def test_fake_compress_tree_k_extremes_match_plain(cuda, ratio):
    """k = 1 (keep the largest |x|), k = m (keep every value) and an
    all-equal row: the select's edge ranks, against the plain version."""
    shapes = {"w": (3, 24, 8, 128)}
    d, r, mk = _compress_tree(cuda, shapes, torch.float32, "per_client", True, special=False)
    d["w"][1] = -2.5e-3
    r["w"][1] = 0.0
    kw = dict(qmax=127, topk_ratio=ratio, use_thresh=True)
    y, res = ops.fake_compress(d, r, mk, stacked=True, **kw)
    _assert_compress_tree(d, r, mk, y, res, kw, True)


# --- serving: B7 on the per-slot LoRA delta, B8 on prefill attention ---

SERVE_LINEAR_CASES = [  # slots, rows per slot, K, N: decode (one row a slot) and prefill
    (8, 1, 896, 896), (8, 1, 896, 128), (4, 128, 896, 896), (2, 1024, 896, 128), (3, 5, 64, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("slots,per_slot,K,N", SERVE_LINEAR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_row_linear_takes_b7_and_matches_plain(cuda, slots, per_slot, K, N, dtype):
    """``layers.linear`` with per-slot adapters (a (B, K, r), b (B, r, N))
    launches the multi-adapter kernel once: SGMV where a slot has 16 rows
    or more, BGMV for one row a slot. f32 agrees with the plain branch's
    einsum pair, bf16 with the kernel's plain twin (the plain branch rounds
    x @ a to bf16, the kernel keeps it in f32)."""
    from repro_torch.models.layers import linear

    r = 8
    x = torch.randn(slots, per_slot, K, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn(K, N, generator=cuda, device="cuda") / math.sqrt(K)).to(dtype)
    a = torch.randn(slots, K, r, generator=cuda, device="cuda") / r
    b = torch.randn(slots, r, N, generator=cuda, device="cuda") * 0.05
    assert (sparse_lora.resident_stages(K, N, r, dtype, adapters=slots, rows=slots * per_slot) > 0) == \
        (per_slot >= 16)
    before = _b7_launches()
    y = linear(x, {"w": w}, {"a": a, "b": b}, 2.0)
    _b7_counted(before, slots * per_slot, K, N, r, slots, dtype)
    base = x @ w
    if dtype == torch.float32:
        plain = base + 2.0 * torch.bmm(torch.bmm(x, a), b)
        torch.cuda.synchronize()
        assert_lora_close(y - base, plain - base)
    idx = torch.arange(slots, device="cuda").repeat_interleave(per_slot)
    twin = ref.batched_sparse_lora_matmul_ref(x.reshape(-1, K), idx, a, b, torch.ones(slots, N, device="cuda"), 2.0)
    delta = ops.batched_sparse_lora_apply(x, idx.int().reshape(slots, per_slot), a, b,
                                          torch.ones(slots, N, device="cuda"), 2.0)
    torch.cuda.synchronize()
    assert_lora_close(delta.reshape(-1, N), twin)
    assert torch.equal(y, base + delta)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(4, 128), (2, 1024), (1, 77)])
def test_prefill_attention_takes_b8_and_matches_blockwise(cuda, B, S):
    """Prefill's prompt attention on the card is one flash-attention launch
    (bf16, qwen2-0.5b's heads, its 8192 window) and agrees with the plain
    ``blockwise_attention`` the CPU path runs. Up to 512 tokens that takes
    its unblocked path, which rounds p to v's dtype before p·v (as the JAX
    package's ``full_attention`` does) where the kernel keeps p in f32: an
    output then moves by up to 2^-8 of Σ p·|v| ≤ max |v| beyond the kernel
    tolerance."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import prompt_attention

    cfg = ARCHS["qwen2-0.5b"]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn(B, S, H, D, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KVH, D, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    before = ops.flash_attention.launches
    out = prompt_attention(q, k, v, cfg)
    assert ops.flash_attention.launches == before + 1
    plain = attn.blockwise_attention(q, k, v, causal=True, window=cfg.attention_window)
    torch.cuda.synchronize()
    if S > 512:  # the blocked path keeps p in f32, as the kernel does
        assert_attention_close(out, plain, v)
        return
    o, p = out.float(), plain.float()
    _, e = torch.frexp(torch.maximum(o.abs(), p.abs()))
    allowed = (1e-5 + 2.0 ** -8) * v.float().abs().max() + torch.ldexp(torch.ones_like(o), e - 8)
    assert bool(((o - p).abs() <= allowed).all()), float((o - p).abs().max())


@pytest.mark.cuda
def test_short_serve_run_launches_b7_and_b8(cuda):
    """A few multi-adapter requests through ServeEngine on the card: prefill
    launches B8 once a layer per group and B7 on every LoRA projection of
    prefill and decode; every request completes with its budget."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduced(head_dim=64), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(cuda, "cuda")
    adapters = [model.init_lora(cuda, "cuda") for _ in range(3)]
    for ad in adapters:
        for ab in ad["layers"].values():
            ab["b"].normal_(0.0, 0.05, generator=cuda)
    eng = ServeEngine(model, params, adapters[0], adapters=adapters[1:], cache_len=96, num_slots=4, max_new_cap=8)
    prompts = torch.randint(0, cfg.vocab_size, (5, 40), generator=cuda, device="cuda").cpu().numpy()
    fa0, b70 = ops.flash_attention.launches, sum(_b7_launches())
    for i in range(5):
        eng.submit(Request(tokens=prompts[i] if i < 3 else prompts[i][:20], adapter_id=i % 3,
                           sampling=SamplingParams(max_new_tokens=4 + i, temperature=0.8 if i == 1 else 0.0)))
    comps = eng.drain()
    assert sorted(c.steps for c in comps) == [4, 5, 6, 7, 8]
    fa, b7 = ops.flash_attention.launches - fa0, sum(_b7_launches()) - b70
    assert fa == cfg.num_layers * eng.stats["prefill_calls"] > 0
    assert b7 == 4 * cfg.num_layers * (eng.stats["prefill_calls"] + eng.stats["decode_steps"]) > 0


# --- the Mamba2 family: B9 on the SSM prefill scan, B7 at its widths ---

SSD_HEADS_CASES = [(128, 64, 128, 64), (128, 64, 128, 4), (64, 32, 16, 8), (72, 20, 33, 3), (24, 128, 5, 2),
                   (128, 64, 64, 112)]  # the last: zamba2-7b's chunk, head_dim, state and heads


@pytest.mark.cuda
@pytest.mark.parametrize("Q,hd,N,heads", SSD_HEADS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_shared_bc_matches_plain(cuda, Q, hd, N, heads, dtype):
    """``heads > 1``: group g reads row g // heads of b and c. The result is
    held to the plain version, and equals the ``heads=1`` launch on b and c
    expanded to every group bit for bit (each group does the same work on
    the same values)."""
    G = 3 * heads
    x = torch.randn(G, Q, hd, generator=cuda, device="cuda").to(dtype)
    b, c = (torch.randn(G // heads, Q, N, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    a = mamba_decays(cuda, G, Q, heads)
    before = ops.ssd_chunk_intra.launches
    y = ops.ssd_chunk_intra(x, a, b, c, heads=heads)
    assert ops.ssd_chunk_intra.launches == before + 1
    torch.cuda.synchronize()
    bx, cx = (t.repeat_interleave(heads, 0) for t in (b, c))
    assert_ssd_close(y, x, a, bx, cx)
    assert_ssd_close(ref.ssd_chunk_intra_ref(x, a, b, c, heads), x, a, bx, cx)
    assert torch.equal(y, ops.ssd_chunk_intra(x, a, bx, cx))
    with pytest.raises(ValueError):
        ops.ssd_chunk_intra(x, a, b[:1], c[:1], heads=heads)


def _ssm_world(gen, S):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    cfg = dataclasses.replace(ARCHS["mamba2-1.3b"].reduced(), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(gen, "cuda")
    lora = model.init_lora(gen, "cuda")
    for ab in lora["layers"].values():
        ab["b"].normal_(0.0, 0.05, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device="cuda")
    return cfg, model, params, lora, tokens


def assert_logits_close(got, want):
    """bf16 logits of two paths that round each layer's bf16 outputs apart
    (B9's tensor-core sums against the plain einsums; GEMMs of other
    shapes): within 0.05 of the row's largest |logit| (chip_smoke.py phase
    5d's oracle tolerance)."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(dim=-1, keepdim=True)
    assert bool(((g - w).abs() <= 0.05 * scale).all()), float(((g - w).abs() / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [96, 200])
def test_ssm_prefill_takes_b9_and_matches_forward(cuda, S):
    """SSM prefill on the card launches B9 once a layer (every chunk of the
    group in that launch, heads sharing b and c) and its last logits agree
    with the plain training forward's; three decode steps after it agree
    with the forward over the prompt and the tokens so far."""
    cfg, model, params, lora, tokens = _ssm_world(cuda, S)
    before = ops.ssd_chunk_intra.launches
    with torch.no_grad():
        logits, cache, pos = model.prefill(params, lora, {"tokens": tokens}, 16)
        assert ops.ssd_chunk_intra.launches == before + cfg.num_layers
        full, _ = model.forward(params, lora, {"tokens": tokens})
        assert ops.ssd_chunk_intra.launches == before + cfg.num_layers  # training forward: plain
        assert_logits_close(logits[:, 0], full[:, -1])
        seq = tokens
        for _ in range(3):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            seq = torch.cat([seq, tok], 1)
            logits, cache = model.decode_step(params, lora, tok, cache, pos)
            full, _ = model.forward(params, lora, {"tokens": seq})
            assert_logits_close(logits[:, 0], full[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("slots,per_slot", [(8, 1), (4, 128), (1, 1024)])
@pytest.mark.parametrize("K,N", [(2048, 8512), (4096, 2048)], ids=["in_proj", "out_proj"])
def test_per_row_linear_at_ssm_widths(cuda, slots, per_slot, K, N):
    """``layers.linear`` with per-slot adapters at mamba2-1.3b's in_proj and
    out_proj widths (bf16, rank 8), decode and prefill shapes: one B7
    launch, within the kernel tolerance of its plain twin."""
    from repro_torch.models.layers import linear

    r = 8
    x = torch.randn(slots, per_slot, K, generator=cuda, device="cuda").bfloat16()
    w = (torch.randn(K, N, generator=cuda, device="cuda") / math.sqrt(K)).bfloat16()
    a = torch.randn(slots, K, r, generator=cuda, device="cuda") / r
    b = torch.randn(slots, r, N, generator=cuda, device="cuda") * 0.05
    before = _b7_launches()
    y = linear(x, {"w": w}, {"a": a, "b": b}, 2.0)
    _b7_counted(before, slots * per_slot, K, N, r, slots, torch.bfloat16)
    idx = torch.arange(slots, device="cuda").repeat_interleave(per_slot)
    ones = torch.ones(slots, N, device="cuda")
    twin = ref.batched_sparse_lora_matmul_ref(x.reshape(-1, K), idx, a, b, ones, 2.0)
    delta = ops.batched_sparse_lora_apply(x, idx.int().reshape(slots, per_slot), a, b, ones, 2.0)
    torch.cuda.synchronize()
    assert_lora_close(delta.reshape(-1, N), twin)
    assert torch.equal(y, x @ w + delta)


# --- the async engine: one client's local round, the edge tier, and
# published global versions that later merges leave alone ---


def _async_world():
    from repro_torch.config import FibecFedConfig, ModelConfig
    from repro_torch.data import dirichlet_partition, make_keyword_task
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn

    cfg = ModelConfig(name="async-lm", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                      d_ff=64, vocab_size=240, dtype="float32", lora_rank=4)
    task = make_keyword_task(n_samples=48, seq_len=12, vocab_size=240, seed=0)
    parts = dirichlet_partition(task.data["label"], 4, 1.0, seed=0)
    data = [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]
    fl = FibecFedConfig(num_devices=4, devices_per_round=2, batch_size=4, fim_warmup_epochs=1,
                        gal_fraction=0.5, sparse_ratio=0.5)
    model = build_model(cfg)
    return cfg, model, make_loss_fn(model), fl, data


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_client_train_fn_matches_plain_one_launch_a_valid_step(cuda, optimizer):
    """The async engine's local round on the card, fused (B1/B2) against
    the same round with the plain optimizer: bit for bit, one launch per
    valid step and none for the padded ones."""
    import numpy as np

    from repro_torch.core import engine as eng
    from repro_torch.core.fibecfed import to_device
    from repro_torch.data.pipeline import gather_batch, make_batches
    from repro_torch.lora import gal_mask_tree
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg, model, loss_fn, _, data = _async_world()
    params = model.init_params(cuda, "cuda")
    lora = model.init_lora(cuda, "cuda")
    for ab in lora["layers"].values():
        ab["b"].normal_(0.0, 0.05, generator=cuda)
    pulled = tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=cuda, device="cuda"), lora)
    gal = gal_mask_tree(cfg, lora, np.array([True, False]))
    keep = tree_map(lambda x: (torch.rand(x.shape, generator=cuda, device="cuda") < 0.5).float(), lora)
    batches = make_batches(len(data[0]["tokens"]), 4)
    batch_of = lambda j: to_device(gather_batch(data[0], batches[j]), "cuda")  # noqa: E731
    batch_idx = np.array([2, 0, 1, 0, 0, 0, 0, 0], np.int32)
    step_valid = np.array([1, 1, 1, 0, 0, 0, 0, 0], np.float32)
    counter = ops.masked_adamw_update if optimizer == "adamw" else ops.masked_sgd_update
    outs = []
    for fused in (True, False):
        opt_init, opt_update = make_optimizer(optimizer, fused=fused)
        train = eng.build_client_train_fn(loss_fn, opt_update)
        before = counter.launches
        new_lora, new_opt, losses = train(params, pulled, lora, opt_init(lora), keep, gal, batch_of, batch_idx,
                                          step_valid, 0.01)
        torch.cuda.synchronize()
        assert counter.launches - before == (3 if fused else 0)
        outs.append((new_lora, new_opt, losses))
    (fl, fo, fls), (pl, po, pls) = outs
    assert fls.shape == (8,) and bool((fls[3:] == 0).all()) and bool((fls[:3] > 0).all())
    assert torch.equal(fls, pls)
    for a, b in zip(tree_leaves(fl) + tree_leaves(fo), tree_leaves(pl) + tree_leaves(po)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [False, True])
def test_one_edge_is_the_flat_merge_bit_for_bit(cuda, dtype, delta):
    import numpy as np

    from repro_torch.core import engine as eng
    from repro_torch.federated.hierarchy import build_edge_summary_fn, edge_reduce
    from repro_torch.utils.tree import tree_leaves, tree_map

    shapes = {"a": (24, 896, 8), "b": (24, 8, 896)}
    rand = lambda s: torch.randn(s, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    g = {k: rand(s) for k, s in shapes.items()}
    mask = {k: (torch.arange(24, device="cuda") % 3 == 0).float().view(24, 1, 1) for k in shapes}
    payloads = [{k: rand(s) for k, s in shapes.items()} for _ in range(4)]
    w = np.array([0.1, 0.2, 0.3, 0.4]) * (0.8 if delta else 1.0)
    merge = eng.gal_delta_merge if delta else eng.gal_weighted_merge
    flat = merge(g, mask, tree_map(lambda *xs: torch.stack(xs), *payloads),
                 torch.as_tensor(w, dtype=torch.float32, device="cuda"))
    stacked, ones = edge_reduce(build_edge_summary_fn(), payloads, w, [5, 1, 7, 0], 8, 1)
    edge = merge(g, mask, stacked, ones)
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(flat), tree_leaves(edge)):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_pulled_globals_survive_later_merges_on_the_card(cuda):
    """A straggler run on the card (fused AdamW, int8 uploads, delta
    merges): every global version a client pulled, and every payload,
    holds its bits after all later merges."""
    from repro_torch.federated import AsyncAggConfig, CompressionConfig, make_runner
    from repro_torch.utils.tree import tree_clone, tree_leaves

    _, model, loss_fn, fl, data = _async_world()
    runner = make_runner("fibecfed", model, loss_fn, fl, data, optimizer="adamw", fused_optimizer=True,
                         engine="async", scenario="straggler", seed=0, device="cuda",
                         async_cfg=AsyncAggConfig(buffer_size=1, merge_mode="delta",
                                                  compression=CompressionConfig(mode="int8")))
    runner.init_phase()
    pulled, made = [], []
    callbacks = runner._async_callbacks

    def recording(lr, sched):
        plan, train = callbacks(lr, sched)

        def train_rec(ci, t, version):
            pulled.append((runner._global.front, tree_clone(runner._global.front)))
            u = train(ci, t, version)
            made.append((u.delta, tree_clone(u.delta)))
            return u

        return plan, train_rec

    runner._async_callbacks = recording
    stats = [runner.run_round(t) for t in range(6)]
    torch.cuda.synchronize()
    assert max(h["staleness_mean"] for h in stats) > 0.0 and runner._global.version == 6
    for live, snap in pulled + made:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(live), tree_leaves(snap)))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["loop", "vectorized", "async"])
def test_run_snapshot_restores_onto_the_card(cuda, tmp_path, engine):
    """A snapshot of a run whose state lives on the card (fused AdamW, B1)
    restores into a fresh runner on the card, every tensor there, and the
    resumed rounds equal the uninterrupted ones bit for bit (the async
    engine's accounting identical, its LoRA within 5e-5)."""
    from repro_torch.checkpoint import restore_runner, save_run_checkpoint
    from repro_torch.federated import AsyncAggConfig, make_runner
    from repro_torch.utils.tree import tree_leaves

    _, model, loss_fn, fl, data = _async_world()
    kw = dict(scenario="dropout", async_cfg=AsyncAggConfig(buffer_size=2, concurrency=3)) if engine == "async" else {}

    def build():
        return make_runner("fibecfed", model, loss_fn, fl, data, optimizer="adamw", fused_optimizer=True,
                           engine=engine, seed=0, device="cuda", **kw)

    runner = build()
    runner.init_phase()
    for t in range(2):
        runner.run_round(t)
    snap = save_run_checkpoint(str(tmp_path), runner, 2)
    want = [runner.run_round(t) for t in range(2, 4)]
    fresh = build()
    restore_runner(fresh, snap)
    state = [fresh.global_lora, *(c.lora for c in fresh.clients)]
    assert all(x.device.type == "cuda" for tree in state for x in tree_leaves(tree))
    before = ops.masked_adamw_update.launches
    got = [fresh.run_round(t) for t in range(2, 4)]
    torch.cuda.synchronize()
    assert ops.masked_adamw_update.launches > before
    assert fresh.comm_bytes_per_round == runner.comm_bytes_per_round
    pairs = list(zip(tree_leaves(fresh.global_lora), tree_leaves(runner.global_lora)))
    if engine == "async":
        for h, w in zip(got, want):
            for k in ("virtual_time", "staleness_mean", "merged_clients", "dropped_clients", "buffer_size"):
                assert h[k] == w[k], k
        assert all(torch.allclose(a, b, atol=5e-5, rtol=1e-4) for a, b in pairs)
    else:
        assert [h["loss"] for h in got] == [h["loss"] for h in want]
        assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.cuda
def test_out_of_core_spill_and_fetch_round_trip_on_the_card(cuda, tmp_path):
    """One hot slot: every client's state (f32 LoRA and moments, int32 step,
    f32 masks and FIM, bf16 and f32 extras) spills to its npz and comes back
    onto the card bit for bit."""
    import numpy as np

    from repro_torch.core.fibecfed import ClientState
    from repro_torch.federated import OutOfCoreStore
    from repro_torch.utils.tree import tree_leaves

    def tree(ci):
        g = torch.Generator(device="cuda").manual_seed(ci)
        rand = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
        return dict(_lora={"a": rand(24, 896, 8), "b": rand(24, 8, 128)},
                    opt_state={"m": {"a": rand(24, 896, 8)}, "t": torch.tensor(ci, dtype=torch.int32, device="cuda")},
                    fim={"a": rand(24, 896, 8).abs()}, neuron_mask={"b": (rand(24, 8, 128) > 0).float()},
                    ef_residual={"a": rand(24, 896, 8).to(torch.bfloat16)})

    def make_state(ci):
        return ClientState(data={"x": np.zeros((2, 2), np.float32)}, n=2, batches=[np.array([0])],
                           order=np.array([0]), **tree(ci))

    store = OutOfCoreStore(str(tmp_path), hot_slots=1)
    store.bind(client_data=[{"x": np.zeros((2, 2), np.float32)}] * 3, make_state=make_state,
               make_shell=lambda ci: ClientState(data={}, n=2, batches=[], order=np.array([0]), opt_state=None),
               device=torch.device("cuda"))
    for ci in range(3):
        store.get(ci)  # made on first touch; the previous client spills
    assert sorted(store._meta) == [0, 1]
    for ci in range(3):
        got, want = store.get(ci), tree(ci)
        for field, value in want.items():
            for a, b in zip(tree_leaves(getattr(got, field)), tree_leaves(value)):
                assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b), field


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_sharded_one_rank_nccl_matches_vectorized(cuda, tmp_path, compressed):
    """The sharded engine on a 1-rank NCCL group (its collectives on the
    card): init and 2 rounds equal the vectorized engine's bit for bit
    (losses, comm bytes, the global LoRA and the stacked client state),
    through the same kernels: fused AdamW (B1 a step), or SGD (B2 a step)
    with top-k int8 uploads and per-client ranks (B3 an upload)."""
    import torch.distributed as dist

    from repro_torch.federated import CompressionConfig, make_runner
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.utils.tree import tree_leaves

    _, model, loss_fn, fl, data = _async_world()
    kw = dict(optimizer="adamw")
    if compressed:
        kw = dict(optimizer="sgd", compression=CompressionConfig(mode="topk", topk_ratio=0.25, topk_values="int8"),
                  client_ranks=[4, 2, 1, 4])

    def run(engine, **extra):
        r = make_runner("fibecfed", model, loss_fn, fl, data, fused_optimizer=True, engine=engine, seed=0,
                        device="cuda", **kw, **extra)
        r.init_phase()
        counts = {name: getattr(ops, name).launches for name in ("masked_adamw_update", "masked_sgd_update",
                                                                  "fake_compress")}
        hist = [r.run_round(t) for t in range(2)]
        counts = {name: getattr(ops, name).launches - n for name, n in counts.items()}
        return r, hist, {k: tree_leaves(v) for k, v in r.population_state().items()}, counts

    rv, hv, pv, cv = run("vectorized")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rs, hs, ps, cs = run("sharded", mesh=make_client_mesh())
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert rs.engine == "sharded" and hs == hv and cs == cv
    steps = sum(int(h["padded_steps"]) for h in hv)
    assert cs == ({"masked_adamw_update": 0, "masked_sgd_update": steps, "fake_compress": 2} if compressed
                  else {"masked_adamw_update": steps, "masked_sgd_update": 0, "fake_compress": 0})
    assert rs.comm_bytes_per_round == rv.comm_bytes_per_round
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rs.global_lora), tree_leaves(rv.global_lora)))
    assert pv.keys() == ps.keys()
    for name in pv:
        assert all(a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(ps[name], pv[name])), name
