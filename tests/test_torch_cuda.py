"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA device and skip without one; the kernels have no
CPU mode. The file imports neither JAX nor the JAX package, so that it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

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
def test_kernel_refuses_bf16_moments(cuda):
    p, g, m, v, mask = _inputs(cuda, (8, 8), torch.float32)
    st = {"m": {"w": m.bfloat16()}, "v": {"w": v.bfloat16()}, "t": torch.tensor(0, device="cuda")}
    with pytest.raises(TypeError, match="dtype"):
        ops.masked_adamw_update({"w": g}, st, {"w": p}, 0.01, {"w": mask})
