"""How far two engines' compressed AdamW rounds part at the top-k threshold
(ROADMAP.md, C11), on the CPU.

The 5-client world of ``tests/test_torch_sharded.py`` (tiny-lm, 53 samples,
cohort 3, seed 11, 2 rounds; fused AdamW, top-k 0.25 int8 with error
feedback, ranks [2, 1, 1, 2, 2]) on: the JAX package's loop and vectorized
engines, the port's loop and vectorized engines (from the JAX runner's
params and initial LoRA), and the port's sharded engine on 2 spawned gloo
ranks (``tests/torch_sharded_rank.py``). Prints, for each pair, the share
of the global LoRA's entries outside atol 5e-5 / rtol 1e-4 and the largest
difference: C3's allowance is 2% and 2e-2.

    PYTHONPATH=src python scripts/compressed_tie_fractions.py
"""
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import repro_torch.config as tconfig  # noqa: E402
import torch_sharded_rank as ranks  # noqa: E402
from repro.config import FibecFedConfig, ModelConfig  # noqa: E402
from repro.data import dirichlet_partition, make_keyword_task  # noqa: E402
from repro.federated import CompressionConfig, make_runner  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.train import make_loss_fn  # noqa: E402
from repro_torch.convert import to_numpy  # noqa: E402
from repro_torch.federated import CompressionConfig as TCompressionConfig  # noqa: E402
from repro_torch.federated import make_runner as t_make_runner  # noqa: E402
from repro_torch.models import build_model as t_build_model  # noqa: E402
from repro_torch.train import make_loss_fn as t_make_loss_fn  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CFG = ModelConfig(name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                  vocab_size=256, head_dim=16, rope="full", norm="rmsnorm", mlp="swiglu", dtype="float32",
                  lora_rank=2, max_seq_len=64)
FL5 = FibecFedConfig(num_devices=5, devices_per_round=3, rounds=4, batch_size=4, learning_rate=5e-3,
                     fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5)
RUN = dict(optimizer="adamw", fused=True, seed=11, rounds=2,
           compression=dict(mode="topk", topk_ratio=0.25, topk_values="int8"), client_ranks=[2, 1, 1, 2, 2])


def apart(a, b):
    diffs = [np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)) for x, y in zip(a, b)]
    bad = np.concatenate([(d > 5e-5 + 1e-4 * np.abs(np.asarray(y, np.float32))).ravel() for d, y in zip(diffs, b)])
    return dict(fraction=float(bad.mean()), entries=int(bad.sum()), of=int(bad.size),
                max_diff=float(max(d.max() for d in diffs)))


def main() -> int:
    torch.set_num_threads(1)
    model = build_model(CFG)
    task = make_keyword_task(n_samples=53, seq_len=12, vocab_size=256, seed=3)
    parts = dirichlet_partition(task.data["label"], FL5.num_devices, 1.0, seed=3)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    leaves = {}
    for engine in ("loop", "vectorized"):
        r = make_runner("fibecfed", model, make_loss_fn(model), FL5, client_data, optimizer="adamw",
                        fused_optimizer=True, engine=engine, seed=11, compression=CompressionConfig(**RUN["compression"]),
                        client_ranks=RUN["client_ranks"])
        r.init_phase()
        for t in range(RUN["rounds"]):
            r.run_round(t)
        leaves["jax", engine] = [np.asarray(x) for x in jax.tree.leaves(r.global_lora)]
    init_params, init_lora = jax.tree.map(np.asarray, r.params), jax.tree.map(np.asarray, r._init_lora)
    t_cfg = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    t_model = t_build_model(tconfig.ModelConfig(**t_cfg))
    for engine in ("loop", "vectorized"):
        r = t_make_runner("fibecfed", t_model, t_make_loss_fn(t_model), tconfig.FibecFedConfig(**dataclasses.asdict(FL5)),
                          client_data, optimizer="adamw", fused_optimizer=True, engine=engine, seed=11, device="cpu",
                          compression=TCompressionConfig(**RUN["compression"]), client_ranks=RUN["client_ranks"],
                          init_params=init_params, init_lora=init_lora)
        r.init_phase()
        for t in range(RUN["rounds"]):
            r.run_round(t)
        leaves["port", engine] = tree_leaves(to_numpy(r.global_lora))
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(cfg=t_cfg, fl=dataclasses.asdict(FL5), client_data=client_data, init_params=init_params,
                    init_lora=init_lora, runs=[dict(RUN, name="sharded")], out=tmp, store=f"{tmp}/store")
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=ranks.main, args=(rank, 2, spec)) for rank in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
            if p.exitcode != 0:
                raise RuntimeError(f"a rank failed: {p.exitcode}")
        _, arrays = ranks.load(tmp, "sharded", 0)
        leaves["port", "sharded2"] = [v for k, v in arrays.items() if k.startswith("global/")]
    out = {
        "jax loop vs jax vectorized": apart(leaves["jax", "vectorized"], leaves["jax", "loop"]),
        "port loop vs port vectorized": apart(leaves["port", "vectorized"], leaves["port", "loop"]),
        "port loop vs port sharded (2 ranks)": apart(leaves["port", "sharded2"], leaves["port", "loop"]),
        "port vectorized vs port sharded (2 ranks)": apart(leaves["port", "sharded2"], leaves["port", "vectorized"]),
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
