"""The port's flat-npz checkpoint layer against the JAX package's.

The twin of ``tests/test_ckpt.py``: its four classes (tree round trips, the
``ckpt_<step>.npz`` convention, atomic writes, corruption safety) as
parametrised cases over ``repro_torch.checkpoint``, whose ``load_tree``
returns CPU tensors. Besides: a bfloat16 tree round-trips with ``ml_dtypes``
out of reach (the card's machine has none), and a tree written by either
side's ``save_tree`` reads back through the other's ``load_tree`` with
bf16, int32 and bool leaves and an empty subtree.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax.numpy as jnp
import ml_dtypes
import numpy as np

import repro.checkpoint as jckpt
from repro_torch.checkpoint import (
    CorruptCheckpointError,
    clean_stale_tmp,
    latest_checkpoint,
    load_checkpoint,
    load_tree,
    save_checkpoint,
    save_tree,
)
from torch_jax_refs import release_jax_programs  # noqa: F401


def _nested_tree():
    return {
        "lora": {"layer_0": {"A": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                             "B": torch.ones((4, 2), dtype=torch.bfloat16)}},
        "opt": {"m": {"w": np.zeros((2, 2), dtype=np.float16)}, "t": np.int32(7)},
        "mask": np.array([True, False, True]),
        "count": np.int64(123),
    }


def _as_numpy(x):
    """A leaf as numpy; bf16 tensors as their bits (uint16) with a tag."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().dtype.name, x.numpy()
    a = np.asarray(x)
    return a.dtype.name, a


def _assert_trees_equal(got, want):
    """``got`` (load_tree's CPU tensors) equals ``want`` in dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    (gd, ga), (wd, wa) = _as_numpy(got), _as_numpy(want)
    assert gd == wd and ga.shape == wa.shape
    np.testing.assert_array_equal(ga, wa)


# -- TestTreeRoundTrip --------------------------------------------------------


def _nested_dtypes_and_shapes(tmp_path):
    tree = _nested_tree()
    _assert_trees_equal(load_tree(save_tree(str(tmp_path / "state.npz"), tree)), tree)


def _tensors_round_trip_as_cpu_tensors(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    out = load_tree(save_tree(str(tmp_path / "t.npz"), tree))
    assert out["a"].dtype == torch.float32 and torch.equal(out["a"], tree["a"])
    # storage of its own: writing the loaded tensor leaves the tree alone
    out["a"].add_(1)
    assert torch.equal(tree["a"], torch.arange(6, dtype=torch.float32).reshape(2, 3))


def _empty_tree(tmp_path):
    assert load_tree(save_tree(str(tmp_path / "empty.npz"), {})) == {}


def _scalar_zero_dim(tmp_path):
    out = load_tree(save_tree(str(tmp_path / "s.npz"), {"t": np.int32(5), "x": np.float32(1.5), "n": 3}))
    assert out["t"].shape == () and out["t"].dtype == torch.int32 and int(out["t"]) == 5
    assert float(out["x"]) == 1.5 and out["n"].dtype == torch.int64


def _creates_missing_directory(tmp_path):
    assert os.path.exists(save_tree(str(tmp_path / "deep" / "er" / "x.npz"), {"a": np.ones(2)}))


def _overwrite_is_atomic_replace(tmp_path):
    path = str(tmp_path / "x.npz")
    save_tree(path, {"a": np.zeros(3, np.float32)})
    save_tree(path, {"a": np.ones(5, np.float64)})
    out = load_tree(path)
    assert out["a"].shape == (5,) and out["a"].dtype == torch.float64


# -- TestCheckpointConvention -------------------------------------------------


def _save_load_round_trip(tmp_path):
    tree = _nested_tree()
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert path.endswith("ckpt_3.npz")
    _assert_trees_equal(load_checkpoint(path), tree)


def _latest_checkpoint_numeric_ordering(tmp_path):
    # step 10 > step 9 numerically even though "ckpt_10" < "ckpt_9" as strings
    for step in (9, 10, 2):
        save_checkpoint(str(tmp_path), step, {"s": np.int32(step)}, keep=10)
    latest = latest_checkpoint(str(tmp_path))
    assert latest.endswith("ckpt_10.npz") and int(load_checkpoint(latest)["s"]) == 10


def _latest_checkpoint_missing_dir(tmp_path):
    assert latest_checkpoint(str(tmp_path / "nope")) is None


def _latest_checkpoint_ignores_foreign_files(tmp_path):
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / "ckpt_bad.npz").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 1, {"a": np.ones(1)})
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_1.npz")


def _keep_gc_prunes_oldest(tmp_path):
    for step in range(6):
        save_checkpoint(str(tmp_path), step, {"s": np.int32(step)}, keep=2)
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz")) == ["ckpt_4.npz", "ckpt_5.npz"]


def _keep_gc_does_not_touch_foreign_npz(tmp_path):
    save_tree(str(tmp_path / "client_0.npz"), {"a": np.ones(1)})
    for step in range(4):
        save_checkpoint(str(tmp_path), step, {"s": np.int32(step)}, keep=1)
    assert (tmp_path / "client_0.npz").exists()


# -- TestAtomicity ------------------------------------------------------------


def _boom(f, **arrays):
    raise OSError("disk full")


def _no_tmp_leak_on_success(tmp_path, monkeypatch):
    save_tree(str(tmp_path / "x.npz"), _nested_tree())
    save_checkpoint(str(tmp_path), 1, _nested_tree())
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def _no_tmp_leak_on_write_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(np, "savez", _boom)
    with pytest.raises(OSError):
        save_tree(str(tmp_path / "x.npz"), {"a": np.ones(2)})
    assert os.listdir(tmp_path) == []


def _failed_overwrite_preserves_previous_file(tmp_path, monkeypatch):
    path = str(tmp_path / "x.npz")
    save_tree(path, {"a": torch.full((3,), 7.0)})
    monkeypatch.setattr(np, "savez", _boom)
    with pytest.raises(OSError):
        save_tree(path, {"a": torch.zeros(3)})
    monkeypatch.undo()
    assert torch.equal(load_tree(path)["a"], torch.full((3,), 7.0))


def _clean_stale_tmp(tmp_path, monkeypatch):
    # a SIGKILLed writer: stranded tmp files next to a good checkpoint
    save_checkpoint(str(tmp_path), 1, {"a": np.ones(2)})
    (tmp_path / "abc123.tmp").write_bytes(b"partial")
    (tmp_path / "def456.tmp").write_bytes(b"partial")
    assert clean_stale_tmp(str(tmp_path)) == 2
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_1.npz")


def _clean_stale_tmp_missing_dir(tmp_path, monkeypatch):
    assert clean_stale_tmp(str(tmp_path / "nope")) == 0


# -- TestCorruptionSafety -----------------------------------------------------


def _truncated_npz_fails_loudly(tmp_path):
    path = save_tree(str(tmp_path / "state.npz"), _nested_tree())
    blob = (tmp_path / "state.npz").read_bytes()
    (tmp_path / "state.npz").write_bytes(blob[: len(blob) // 2])
    with pytest.raises(CorruptCheckpointError):
        load_tree(path)


def _truncated_to_empty_fails_loudly(tmp_path):
    path = save_tree(str(tmp_path / "state.npz"), _nested_tree())
    (tmp_path / "state.npz").write_bytes(b"")
    with pytest.raises(CorruptCheckpointError):
        load_tree(path)


def _garbage_bytes_fail_loudly(tmp_path):
    (tmp_path / "state.npz").write_bytes(b"\x00" * 256)
    with pytest.raises(CorruptCheckpointError):
        load_tree(str(tmp_path / "state.npz"))


def _missing_file_is_not_corruption(tmp_path):
    # missing and corrupt are different failures: callers probe for absent
    # spill files, but must never swallow a partial write
    with pytest.raises(FileNotFoundError):
        load_tree(str(tmp_path / "never_written.npz"))


def _save_checkpoint_sweeps_stale_tmp(tmp_path):
    (tmp_path / "dead123.tmp").write_bytes(b"partial")
    path = save_checkpoint(str(tmp_path), 2, {"a": np.ones(2, np.float32)})
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert torch.equal(load_tree(path)["a"], torch.ones(2))


def _cases(*fns):
    return [pytest.param(fn, id=fn.__name__.lstrip("_")) for fn in fns]


@pytest.mark.parametrize("case", _cases(
    _nested_dtypes_and_shapes, _tensors_round_trip_as_cpu_tensors, _empty_tree, _scalar_zero_dim,
    _creates_missing_directory, _overwrite_is_atomic_replace))
def test_tree_round_trip(tmp_path, case):
    case(tmp_path)


@pytest.mark.parametrize("case", _cases(
    _save_load_round_trip, _latest_checkpoint_numeric_ordering, _latest_checkpoint_missing_dir,
    _latest_checkpoint_ignores_foreign_files, _keep_gc_prunes_oldest, _keep_gc_does_not_touch_foreign_npz))
def test_checkpoint_convention(tmp_path, case):
    case(tmp_path)


@pytest.mark.parametrize("case", _cases(
    _no_tmp_leak_on_success, _no_tmp_leak_on_write_failure, _failed_overwrite_preserves_previous_file,
    _clean_stale_tmp, _clean_stale_tmp_missing_dir))
def test_atomicity(tmp_path, monkeypatch, case):
    case(tmp_path, monkeypatch)


@pytest.mark.parametrize("case", _cases(
    _truncated_npz_fails_loudly, _truncated_to_empty_fails_loudly, _garbage_bytes_fail_loudly,
    _missing_file_is_not_corruption, _save_checkpoint_sweeps_stale_tmp))
def test_corruption_safety(tmp_path, case):
    case(tmp_path)


# -- bfloat16 without ml_dtypes, and across frameworks ------------------------


def test_bf16_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    """The card's machine has no ``ml_dtypes``: a bf16 tree (a tensor on
    the host, and the bits of one as numpy's ``V2``) round-trips with the
    module out of reach, bit for bit (a NaN and a subnormal included)."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # any import of it raises
    with pytest.raises(ImportError):
        __import__("ml_dtypes")
    bits = torch.tensor([0x3FC0, 0x7FC1, 0x0001, 0x8000, 0xC040, 0x4049], dtype=torch.int32).to(torch.int16)
    tree = {"w": bits.view(torch.bfloat16).reshape(2, 3), "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    out = load_tree(save_tree(str(tmp_path / "bf16.npz"), tree))
    _assert_trees_equal(out, tree)
    assert out["w"].dtype == torch.bfloat16


def _mixed_leaves(xp):
    """bf16, int32 and bool leaves and an empty subtree, as numpy (``xp`` =
    "jax": ml_dtypes bf16) or tensors ("torch")."""
    vals = np.asarray([[1.5, -2.25, 3.0], [0.0, 1e-3, -7.5]], np.float32)
    if xp == "jax":
        return {"lora": {"a": np.asarray(jnp.asarray(vals, jnp.bfloat16)), "t": np.int32(4)},
                "mask": np.array([True, False]), "opt": {}}
    return {"lora": {"a": torch.from_numpy(vals).to(torch.bfloat16), "t": torch.tensor(4, dtype=torch.int32)},
            "mask": torch.tensor([True, False]), "opt": {}}


def test_jax_tree_reads_in_the_port(tmp_path):
    path = jckpt.save_tree(str(tmp_path / "j.npz"), _mixed_leaves("jax"))
    out = load_tree(path)
    _assert_trees_equal(out, {k: v for k, v in _mixed_leaves("torch").items() if k != "opt"})
    assert "opt" not in out  # an empty subtree leaves no key, on both sides
    assert jckpt.load_tree(path).keys() == out.keys()


def test_port_tree_reads_in_jax(tmp_path):
    path = save_tree(str(tmp_path / "t.npz"), _mixed_leaves("torch"))
    out, want = jckpt.load_tree(path), _mixed_leaves("jax")
    assert set(out) == {"lora", "mask"}
    assert out["lora"]["a"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out["lora"]["a"].view(np.uint16), want["lora"]["a"].view(np.uint16))
    assert out["lora"]["t"].dtype == np.int32 and int(out["lora"]["t"]) == 4
    assert out["mask"].dtype == np.bool_ and out["mask"].tolist() == [True, False]
