"""The port's loop engine reproduces the JAX package's loop engine.

Same world as ``tests/test_engine_equivalence.py`` (tiny-lm, 50 samples over
4 clients with ragged final batches, seed 7, 2 rounds). The port starts from
the JAX runner's params and initial LoRA (handed over as numpy through
``repro_torch.convert``), runs on the CPU, and must make the same curriculum
and GAL decisions, the same per-round losses, the same comm-byte integers
and the same global LoRA, for fibecfed/adamw and fedavg_lora/sgd, with the
fused optimizer off and on.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np

from repro.config import FibecFedConfig, ModelConfig
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated import make_runner
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.convert import to_numpy
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)
ROUNDS = 2

# fedavg_lora/sgd amplifies float rounding: a 1e-7 relative change of the
# frozen weights moves the JAX loop engine's own round-2 global LoRA by
# 7e-5, and the JAX loop and vectorized engines differ by 1.1e-4 there
# (ROADMAP.md §C). Its round-2 LoRA is held to atol 5e-4; every other
# comparison uses the slice tolerances (atol 5e-5, rtol 1e-4).
LORA_TOL = {("fibecfed", "adamw"): 5e-5, ("fedavg_lora", "sgd"): 5e-4}


def torch_config(cfg):
    """The same architecture as the port's config dataclass."""
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [
        {k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts
    ]
    t_model = t_build_model(torch_config(CFG))
    return model, make_loss_fn(model), t_model, t_make_loss_fn(t_model), client_data


def _snapshot(leaves):
    return [np.array(x, dtype=np.float32) for x in leaves]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("baseline,optimizer", [("fibecfed", "adamw"), ("fedavg_lora", "sgd")])
def test_port_loop_matches_jax_loop(world, baseline, optimizer, fused):
    model, loss_fn, t_model, t_loss_fn, client_data = world
    ref = make_runner(
        baseline, model, loss_fn, FL, client_data,
        optimizer=optimizer, fused_optimizer=fused, engine="loop", seed=7,
    )
    port = t_make_runner(
        baseline, t_model, t_loss_fn, tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
        client_data, optimizer=optimizer, fused_optimizer=fused, engine="loop", seed=7,
        device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params),
        init_lora=jax.tree.map(np.asarray, ref._init_lora),
    )
    ref.init_phase()
    port.init_phase()

    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(cr.order, cp.order)
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)

    for t in range(ROUNDS):
        hr, hp = ref.run_round(t), port.run_round(t)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        assert hp["selected_batches"] == hr["selected_batches"]
        atol = 5e-5 if t == 0 else LORA_TOL[(baseline, optimizer)]
        gr = _snapshot(jax.tree.leaves(ref.global_lora))
        gp = tree_leaves(to_numpy(port.global_lora))
        assert len(gr) == len(gp)
        for a, b in zip(gr, gp):
            np.testing.assert_allclose(b, a, atol=atol, rtol=1e-4)
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.comm_upload_bytes_per_round == ref.comm_upload_bytes_per_round
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)


def test_port_evaluate_matches_jax(world):
    """Server-model accuracy after training agrees with the JAX runner's."""
    model, loss_fn, t_model, t_loss_fn, client_data = world
    ref = make_runner("fibecfed", model, loss_fn, FL, client_data,
                      optimizer="adamw", engine="loop", seed=7)
    port = t_make_runner(
        "fibecfed", t_model, t_loss_fn, tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
        client_data, optimizer="adamw", seed=7, device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params),
        init_lora=jax.tree.map(np.asarray, ref._init_lora),
    )
    for r in (ref, port):
        r.init_phase()
        r.run_round(0)
    test = make_keyword_task(n_samples=40, seq_len=12, vocab_size=256, seed=3).data
    assert port.evaluate(test, batch_size=16) == ref.evaluate(test, batch_size=16)
