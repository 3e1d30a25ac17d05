"""Curriculum-strategy ablation (paper App. G.7 / Fig. 7c) on the PyTorch
port (the twin of ``examples/curriculum_ablation.py``).

  PYTHONPATH=src python examples/torch_curriculum_ablation.py --rounds 12 [--device cpu]

Compares linear / exp / none curricula and prints the per-round selected
batch counts and the final accuracy. It runs on the card unless
``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.config import FibecFedConfig, ModelConfig
from repro_torch.core.curriculum import CurriculumSchedule, num_selected_batches
from repro_torch.data import dirichlet_partition, make_keyword_task
from repro_torch.federated import make_runner, run_experiment
from repro_torch.models import build_model
from repro_torch.train import make_loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default=None, help="cpu runs on the CPU; default: the card")
    args = ap.parse_args(argv)

    # schedule shapes, no training needed
    print("selected batches out of 10 per round (β=0.6, α=0.8):")
    for strat in ("linear", "sqrt", "exp"):
        sch = CurriculumSchedule(strategy=strat, beta=0.6, alpha=0.8,
                                 total_rounds=args.rounds)
        counts = [num_selected_batches(sch, t, 10) for t in range(args.rounds)]
        print(f"  {strat:7s} {counts}")

    cfg = ModelConfig(
        name="abl-lm", family="dense", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
        lora_rank=4, max_seq_len=64,
    )
    model = build_model(cfg)
    task = make_keyword_task(n_samples=320, seq_len=24, vocab_size=512, seed=0)
    test = make_keyword_task(n_samples=96, seq_len=24, vocab_size=512, seed=1)
    parts = dirichlet_partition(task.data["label"], 6, 1.0, seed=0)
    clients = [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]
    test_data = {k: v for k, v in test.data.items() if k != "label"}
    loss_fn = make_loss_fn(model)

    for strat in ("linear", "exp", "none"):
        fl = FibecFedConfig(
            num_devices=6, devices_per_round=3, rounds=args.rounds, batch_size=8,
            learning_rate=5e-3, curriculum=strat, gal_fraction=0.75,
            sparse_ratio=0.5, fim_warmup_epochs=1,
        )
        runner = make_runner("fibecfed", model, loss_fn, fl, clients,
                             optimizer="adamw", device=args.device)
        res = run_experiment(runner, test_data, eval_every=args.rounds)
        print(f"curriculum={strat:7s} final_acc={res['final_accuracy']:.3f} "
              f"tune={res['wall_s']:.0f}s init={res['init_s']:.0f}s")


if __name__ == "__main__":
    main()
