"""The port's FedPrompt (federated soft-prompt tuning) reproduces the JAX
package's ``repro.federated.prompt_tuning.FedPrompt``.

The port starts from the JAX runner's params and prompt (its ``jax.random``
draws, handed over as numpy), runs on the CPU and must give the same
per-round losses (rel 1e-4 / abs 1e-5), the same prompt after each round
(atol 5e-5 / rtol 1e-4: the slice tolerances), the same comm-byte integers
and the same ``evaluate`` accuracy, on the tiny dense world and on the
reduced qwen3-0.6b.
"""
import dataclasses

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np
import torch

from repro.config import FibecFedConfig, ModelConfig
from repro.configs import ARCHS
from repro.data import dirichlet_partition, make_keyword_task
from repro.federated.prompt_tuning import FedPrompt
from repro.models import build_model

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.federated import FedPrompt as TFedPrompt
from repro_torch.models import build_model as t_build_model
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

TINY = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
WORLDS = {"tiny-lm": TINY, "qwen3-0.6b": ARCHS["qwen3-0.6b"].reduced()}
FL = FibecFedConfig(num_devices=4, devices_per_round=2, rounds=2, batch_size=4, learning_rate=5e-2)
N_PROMPT = 6


def torch_config(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _clients(cfg, n=40, seed=0):
    task = make_keyword_task(n_samples=n, seq_len=12, vocab_size=cfg.vocab_size, seed=seed)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    return [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fedprompt_matches_jax(world):
    cfg = WORLDS[world]
    clients = _clients(cfg)
    ref = FedPrompt(build_model(cfg), FL, clients, n_prompt=N_PROMPT, seed=3)
    port = TFedPrompt(
        t_build_model(torch_config(cfg)), tconfig.FibecFedConfig(**dataclasses.asdict(FL)), clients,
        n_prompt=N_PROMPT, seed=3, device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params), init_prompt=np.asarray(ref.prompt),
    )
    assert all(not bool(x.any()) for x in tree_leaves(port.lora))
    start = np.asarray(ref.prompt)
    for t in range(2):
        hr, hp = ref.run_round(t), port.run_round(t)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        np.testing.assert_allclose(port.prompt.numpy(), np.asarray(ref.prompt), atol=5e-5, rtol=1e-4)
    assert np.abs(np.asarray(ref.prompt) - start).max() > 100 * 5e-5  # the rounds moved the prompt
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round == [2 * 2 * N_PROMPT * cfg.d_model * 4] * 2
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round)
    test = make_keyword_task(n_samples=24, seq_len=12, vocab_size=cfg.vocab_size, seed=5).data
    assert port.evaluate(test, batch_size=10) == ref.evaluate(test, batch_size=10)


def test_fedprompt_draws_its_own_start_and_refuses_other_families():
    """Without numpy arrays to start from, params and prompt come from
    generators seeded from ``seed`` (the same seed, the same run); the
    prompt is (n_prompt, d_model) f32 at scale 0.02, the LoRA zeros. A
    model that is no decoder (dense, moe or vlm) is refused, as the JAX
    package's assertion refuses it."""
    cfg = T_ARCHS["qwen3-0.6b"].reduced()
    fl = tconfig.FibecFedConfig(**dataclasses.asdict(FL))
    clients = _clients(cfg)
    runs = [TFedPrompt(t_build_model(cfg), fl, clients, n_prompt=N_PROMPT, seed=s, device="cpu") for s in (1, 1, 2)]
    assert runs[0].prompt.shape == (N_PROMPT, cfg.d_model) and runs[0].prompt.dtype == torch.float32
    assert 0.01 < float(runs[0].prompt.std()) < 0.03
    assert torch.equal(runs[0].prompt, runs[1].prompt) and not torch.equal(runs[0].prompt, runs[2].prompt)
    losses = [r.run_round(0)["loss"] for r in runs[:2]]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(ValueError, match="prompt tuning needs a decoder"):
        TFedPrompt(t_build_model(T_ARCHS["mamba2-1.3b"].reduced()), fl, clients, device="cpu")
