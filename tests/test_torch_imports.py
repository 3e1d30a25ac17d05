"""The port stands alone, and runs on the card unless told otherwise.

``src/repro_torch``, its scripts and examples (``examples/torch_*.py``),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (and the spawned ranks of
``tests/test_torch_sharded.py`` and ``tests/test_torch_launch_mesh.py``)
import neither JAX nor the JAX package (``repro``), not
even its modules that need no JAX (the checkpoint layer, the client store and
the service among them), nor ``ml_dtypes``: they run where only PyTorch is. A
runner built without ``device=`` refuses to start when there is no CUDA
device, rather than falling back to the CPU; every engine and option of the
JAX runner is ported, and malformed options are rejected.
"""
import dataclasses
import os
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|from\s+repro(\.|\s)(?!_torch)"
    r"|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.MULTILINE,
)


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "scripts").glob("torch_*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "tests" / "test_torch_cuda.py", ROOT / "tests" / "torch_sharded_rank.py",
               ROOT / "tests" / "torch_launch_rank.py", ROOT / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    for sub in ("obs", "serve", "launch", "checkpoint"):  # the later slices' packages are covered
        assert any(f.parent.name == sub for f in files), sub
    for mod in (("models", "encdec.py"), ("federated", "store.py"), ("federated", "service.py"),
                ("launch", "mesh.py"), ("launch", "steps.py"), ("launch", "dryrun.py"), ("models", "sharding_ctx.py")):
        assert ROOT.joinpath("src", "repro_torch", *mod) in files, mod
    assert sum(f.parent.name == "examples" for f in files) == 4  # the four torch_*.py examples
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in FORBIDDEN.finditer(f.read_text())
    ]
    assert offenders == []


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import grad",
                "from repro.core import fibecfed", "import repro", "from repro import x",
                "import ml_dtypes", "from ml_dtypes import bfloat16", "from repro.checkpoint import save_tree"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import fibecfed", "import jaxlib_like"):
        assert not FORBIDDEN.search(ok), ok


def _world():
    from repro_torch.config import FibecFedConfig, ModelConfig
    from repro_torch.data import dirichlet_partition, make_keyword_task
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn

    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=1, d_ff=32, vocab_size=240, dtype="float32", lora_rank=2)
    task = make_keyword_task(n_samples=12, seq_len=6, vocab_size=240, seed=0)
    parts = dirichlet_partition(task.data["label"], 2, 1.0, seed=0)
    data = [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=2, devices_per_round=2, batch_size=4, fim_warmup_epochs=1)
    return model, make_loss_fn(model), fl, data


def test_runner_without_device_needs_cuda(monkeypatch):
    from repro_torch.federated import make_runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, loss_fn, fl, data = _world()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner("fibecfed", model, loss_fn, fl, data)
    runner = make_runner("fibecfed", model, loss_fn, fl, data, device="cpu")
    assert runner.device.type == "cpu"


@pytest.mark.parametrize(
    "kw",
    [{"engine": "sharded"}, {"engine": "async"}, {"store": "out_of_core"}, {"hierarchy": 2},
     {"scenario": "straggler"}, {"mesh": object()}],
)
def test_unported_engines_and_options_raise(kw, tmp_path):
    """Every engine and option of the JAX runner is ported now (the name is
    the one this test had while some were not).
    ``engine="sharded"`` needs a process group the caller made, and without
    one raises ``RuntimeError`` naming ``init_process_group``; ``mesh=`` on
    another engine (the default) raises ``ValueError``. ``engine="async"``
    builds, an out-of-core store binds on every engine but the sharded one,
    and the async options on a synchronous engine raise ``ValueError``, as
    in the JAX package."""
    from repro_torch.federated import OutOfCoreStore, make_runner

    model, loss_fn, fl, data = _world()
    if kw == {"engine": "async"}:
        runner = make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", **kw)
        assert runner.engine == "async" and runner._global.version == 0
    elif "store" in kw:
        for engine in ("loop", "vectorized", "async"):
            store = OutOfCoreStore(str(tmp_path / engine), hot_slots=1)
            runner = make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", engine=engine, store=store)
            assert runner.store is store and runner._oocore and len(runner.clients) == 2
            assert os.path.isdir(store.directory) and store._hot == {}  # states are made on first touch
    elif "hierarchy" in kw or "scenario" in kw:
        with pytest.raises(ValueError, match="engine='async'"):
            make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", **kw)
    elif "mesh" in kw:
        with pytest.raises(ValueError, match="engine='sharded'"):
            make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", **kw)
    else:
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", **kw)


@pytest.mark.parametrize("field", ["gal_fraction", "sparse_ratio"])
def test_lossless_criteria_raise(field):
    """The lossless criteria, once refused with NotImplementedError, raise
    nothing now: with the field left to them the runner initializes, every
    client's criterion ran and its fraction lies in (0, 1], and the GAL
    layers and neuron masks follow the fractions where the field is None."""
    from repro_torch.core.gal import gal_layer_count
    from repro_torch.federated import make_runner

    model, loss_fn, fl, data = _world()
    fl = dataclasses.replace(fl, lanczos_iters=4, **{field: None})
    runner = make_runner("fibecfed", model, loss_fn, fl, data, device="cpu")
    runner.init_phase()
    fractions = [c.lossless_fraction for c in runner.clients]
    assert all(c.lossless is not None and 0.0 < c.lossless_fraction <= 1.0 for c in runner.clients)
    if field == "gal_fraction":
        n_star = gal_layer_count(fractions, [c.n for c in runner.clients], model.cfg.num_layers, fl.mu_global_local)
        assert int(runner.gal_layers.sum()) == n_star
    else:
        for c in runner.clients:
            for ab in c.neuron_mask["layers"].values():
                d_out = ab["b"].shape[-1]
                assert bool((ab["b"][:, 0].sum(-1) >= max(1, round(c.lossless_fraction * d_out))).all())


@pytest.mark.parametrize(
    "kw,error",
    [({"compression": object()}, TypeError), ({"client_ranks": [1]}, ValueError),
     ({"client_ranks": [0, 2]}, ValueError), ({"engine": "turbo"}, ValueError)],
)
def test_bad_options_rejected(kw, error):
    from repro_torch.federated import make_runner

    model, loss_fn, fl, data = _world()
    with pytest.raises(error):
        make_runner("fibecfed", model, loss_fn, fl, data, device="cpu", **kw)


def test_port_runs_end_to_end_on_cpu():
    """A whole init + round + evaluation on its own seeded torch init, on
    the default (vectorized) engine."""
    from repro_torch.federated import make_runner, run_experiment

    model, loss_fn, fl, data = _world()
    runner = make_runner("fibecfed", model, loss_fn, fl, data, optimizer="adamw",
                         fused_optimizer=True, device="cpu", seed=3)
    assert runner.engine == "vectorized"
    out = run_experiment(runner, data[0], rounds=2, eval_every=1)
    assert len(out["history"]) == 2 and np.isfinite(out["history"][-1]["loss"])
    assert 0.0 <= out["final_accuracy"] <= 1.0
    assert out["total_comm_bytes"] == 2 * out["total_upload_bytes"] > 0
