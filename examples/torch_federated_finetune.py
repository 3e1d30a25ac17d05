"""End-to-end training example of the PyTorch port (the twin of
``examples/federated_finetune.py``): train a decoder with the FibecFed
distributed train step, with checkpointing and metrics.

  PYTHONPATH=src python examples/torch_federated_finetune.py --steps 300 [--device cpu]

This is the code path of ``repro_torch.launch.train`` and the dry run
(``launch/steps.py``): client-split batch, GAL-masked global LoRA plus
client-local LoRA, the masked AdamW kernel (B1) twice a step. Here it runs
without a mesh (one rank: a (1, 1) mesh) with 4 client groups, on the card
unless ``--device cpu`` is given; ``--big`` takes a ~100M-parameter model.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import ModelConfig
from repro_torch.core.fibecfed import resolve_device
from repro_torch.data import make_keyword_task
from repro_torch.launch.steps import build_train_step, make_train_state
from repro_torch.lora import gal_mask_tree, lora_num_logical_layers
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves, tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None, help="cpu runs on the CPU; default: the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.big:  # ~100M params
        cfg = ModelConfig(
            name="ft-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
            head_dim=64, dtype="float32", lora_rank=8, max_seq_len=1024,
        )
    else:
        cfg = ModelConfig(
            name="ft-small", family="dense", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=2048,
            head_dim=32, dtype="float32", lora_rank=8, max_seq_len=256,
        )
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params on {device}")

    state = make_train_state(model, gen, args.groups, device)
    # GAL: the first 75% of layers (torch_quickstart.py shows the full selection)
    L = lora_num_logical_layers(cfg)
    gal = np.zeros(L, bool)
    gal[: int(round(0.75 * L))] = True
    state["gal_mask"] = gal_mask_tree(cfg, state["gal_lora"], gal)
    state["local_mask"] = tree_map(torch.ones_like, state["local_mask"])

    task = make_keyword_task(
        n_samples=args.groups * args.batch * 8, seq_len=args.seq,
        vocab_size=cfg.vocab_size, seed=0,
    )
    tokens = torch.as_tensor(task.data["tokens"], device=device)
    step = build_train_step(model, args.groups, learning_rate=1e-3)

    B = args.groups * args.batch
    t0 = time.time()
    for i in range(args.steps):
        idx = np.random.default_rng(i).choice(len(tokens), B, replace=False)
        batch = {"tokens": tokens[torch.as_tensor(idx, device=device)]}
        state, metrics = step(params, state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    save_checkpoint(args.ckpt_dir, args.steps, {"gal_lora": state["gal_lora"]})
    print(f"saved GAL LoRA checkpoint to {args.ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
