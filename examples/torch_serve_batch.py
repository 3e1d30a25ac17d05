"""Batched serving on the PyTorch port (the twin of
``examples/serve_batch.py``): prefill and decode with KV / SSM-state caches.

  PYTHONPATH=src python examples/torch_serve_batch.py --arch mamba2-1.3b [--device cpu]
  PYTHONPATH=src python examples/torch_serve_batch.py --arch qwen2-0.5b --continuous

Loads a REDUCED variant of any assigned architecture, builds the
ServeEngine and generates continuations for a batch of prompts: the
attention-free SSM decode (constant-size state) and the ring-buffer
sliding-window decode among them. ``--continuous`` drives the request API
instead (submit / drain through a small slot pool), printing per-request
completions and time to first token. It runs on the card unless
``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, ASSIGNED
from repro_torch.core.fibecfed import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Request, SamplingParams, ServeEngine, make_prompt_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ASSIGNED)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="drive the submit/step/drain request API")
    ap.add_argument("--num-slots", type=int, default=2)
    ap.add_argument("--device", default=None, help="cpu runs on the CPU; default: the card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    if cfg.family == "encoder":
        raise SystemExit("encoder-only architectures have no decode path")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, device)
    lora = model.init_lora(gen, device)

    batch = make_prompt_batch(cfg, 0, args.batch, args.prompt_len)
    engine = ServeEngine(
        model, params, lora,
        cache_len=args.prompt_len + args.new_tokens,
        num_slots=args.num_slots,
        max_new_cap=args.new_tokens,
        device=device,
    )

    if args.continuous:
        tokens = np.asarray(batch["tokens"])
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        sp = SamplingParams(max_new_tokens=args.new_tokens, temperature=args.temperature)
        t0 = time.time()
        for i in range(args.batch):
            engine.submit(Request(
                tokens=tokens[i], sampling=sp,
                extras={k: v[i] for k, v in extras.items()} or None,
            ))
        comps = engine.drain()
        dt = time.time() - t0
        total = sum(c.steps for c in comps)
        print(f"arch={args.arch} family={cfg.family} "
              f"slots={args.num_slots} requests={args.batch}")
        print(f"generated {total} tokens in {dt:.1f}s ({total / dt:.1f} tok/s)")
        for c in sorted(comps, key=lambda c: c.request_id):
            print(f"  req {c.request_id}: ttft={c.ttft_s:.2f}s "
                  f"{c.finish_reason}: {np.asarray(c.tokens).tolist()}")
        return comps

    t0 = time.time()
    res = engine.generate(batch, max_new_tokens=args.new_tokens, temperature=args.temperature)
    dt = time.time() - t0
    print(f"arch={args.arch} family={cfg.family} batch={args.batch}")
    print(f"generated {res.steps} steps in {dt:.1f}s "
          f"({args.batch * res.steps / dt:.1f} tok/s)")
    for i, row in enumerate(res.tokens):
        print(f"  seq {i}: {np.asarray(row).tolist()}")
    return res


if __name__ == "__main__":
    main()
