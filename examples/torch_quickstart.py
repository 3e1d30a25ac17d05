"""Quickstart of the PyTorch port: FibecFed fine-tuning on a tiny decoder
LM, end to end (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs the full Algorithm 1 (Fisher difficulty scoring, GAL selection,
sparse neuron masks, curriculum FedAvg rounds) on 8 simulated non-IID
devices, and prints the accuracy trajectory against a plain FedAvg+LoRA
baseline. It runs on the card unless ``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.config import FibecFedConfig, ModelConfig
from repro_torch.data import dirichlet_partition, make_keyword_task
from repro_torch.federated import make_runner, run_experiment
from repro_torch.models import build_model
from repro_torch.train import make_loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--device", default=None, help="cpu runs on the CPU; default: the card")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="quickstart-lm", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        dtype="float32", lora_rank=4, max_seq_len=64,
    )
    model = build_model(cfg)
    task = make_keyword_task(n_samples=400, seq_len=24, vocab_size=512, seed=0)
    test = make_keyword_task(n_samples=128, seq_len=24, vocab_size=512, seed=1)
    parts = dirichlet_partition(task.data["label"], 8, alpha=1.0, seed=0)
    clients = [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]
    test_data = {k: v for k, v in test.data.items() if k != "label"}

    fl = FibecFedConfig(
        num_devices=8, devices_per_round=4, rounds=args.rounds, batch_size=8,
        learning_rate=3e-3, gal_fraction=0.75, sparse_ratio=0.5,
        fim_warmup_epochs=1,
    )
    loss_fn = make_loss_fn(model)
    for method in ("fibecfed", "fedavg_lora"):
        runner = make_runner(method, model, loss_fn, fl, clients, optimizer="adamw", device=args.device)
        res = run_experiment(runner, test_data, eval_every=5)
        print(f"\n=== {method} ===")
        if method == "fibecfed":
            print(f"GAL layers: {np.flatnonzero(runner.gal_layers).tolist()} "
                  f"of {cfg.num_layers}")
        for h in res["history"]:
            if "accuracy" in h:
                print(f"  round {h['round']:3d} loss={h['loss']:.3f} "
                      f"acc={h['accuracy']:.3f} comm={h['comm_bytes']:.0f}B")
        print(f"  final acc {res['final_accuracy']:.3f}  "
              f"total comm {res['total_comm_bytes'] / 1e6:.2f} MB  "
              f"wall {res['wall_s']:.0f}s")


if __name__ == "__main__":
    main()
