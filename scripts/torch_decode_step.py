"""A serving decode step of the PyTorch port on the card, for comparing two
trees of the port on one card.

For qwen2-0.5b and mamba2-1.3b (the configs of chip_smoke.py's serving
phases 5d and f; full width and depth, bf16, seeded init, four seeded
adapters with b drawn at 0.01): serves 8 requests (prompts of 128 tokens,
budgets of 32, the adapters in turn) on 8 slots, then times, on the
engine's last decode state:

- ``decode_step_ms``: one ``decode_step`` of the 8 slots, CUDA events
  around 20 steps (the wall time of a step where the host holds it), the
  median of 5 such blocks (``decode_step_blocks_ms``);
- ``kernel_ms`` and ``busy_share``: the kernels' device time of one step
  under ``torch.profiler``, and its share of ``decode_step_ms``;
- ``b7_host_us``: the host time of one ``ops.batched_sparse_lora_apply``
  call at the decode shape of the first LoRA target (8 rows, 8 adapters),
  over 2000 calls without a sync;
- ``serve_tokens_per_s``: the tokens the 8 requests emitted over the
  host-clock time of their ``drain``, prefill included.

``--src`` picks the tree whose ``src/`` is imported (this one by default),
so that two trees can be timed in turns in one process list:

    python3 scripts/torch_decode_step.py [--src DIR]

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
tree and each config's numbers.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CONFIGS = ("qwen2-0.5b", "mamba2-1.3b")
SLOTS, PROMPT, BUDGET, CACHE, B_SCALE = 8, 128, 32, 256, 0.01


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3


def time_config(name):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.lora import gather_adapter_slots
    from repro_torch.models import build_model
    from repro_torch.serve import Request, SamplingParams, ServeEngine
    from repro_torch.utils.tree import tree_clone

    cfg = ARCHS[name]
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = model.init_params(gen, "cuda")
    adapters = []
    for _ in range(4):
        lora = model.init_lora(gen, "cuda")
        for ab in lora["layers"].values():
            ab["b"].normal_(0.0, B_SCALE, generator=gen)
        adapters.append(lora)
    rng = np.random.default_rng(19)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32),
                    sampling=SamplingParams(max_new_tokens=BUDGET, seed=100 + i), adapter_id=i % 4)
            for i in range(SLOTS)]
    eng = ServeEngine(model, params, adapters[0], adapters=adapters[1:], cache_len=CACHE, num_slots=SLOTS,
                      max_new_cap=BUDGET)
    for r in reqs:  # a first drain builds the kernels and warms the allocator
        eng.submit(r)
    eng.drain()
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    st = eng._state
    lora_t = gather_adapter_slots(cfg, eng._stacked, st["aidx"])
    cache = tree_clone(st["cache"])  # decode writes its cache in place
    with torch.no_grad():
        step = lambda: model.decode_step(eng.params, lora_t, st["token"], cache, st["pos"])  # noqa: E731
        blocks = [cuda_ms(step, iters=20) for _ in range(5)]
        step_ms = float(np.median(blocks))
        k_ms = kernel_ms(step)
    ab = next(iter(lora_t["layers"].values()))
    a, b = ab["a"][0].contiguous(), ab["b"][0].contiguous()
    x = torch.randn(SLOTS, a.shape[1], generator=gen, device="cuda").bfloat16()
    idx = torch.arange(SLOTS, dtype=torch.int32, device="cuda")
    mask = torch.ones(a.shape[0], b.shape[-1], device="cuda")
    call = lambda: ops.batched_sparse_lora_apply(x, idx, a, b, mask, 2.0)  # noqa: E731
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        call()
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return dict(decode_step_ms=step_ms, decode_step_blocks_ms=blocks, kernel_ms=k_ms, busy_share=k_ms / step_ms,
                b7_host_us=host_us, b7_shape=[SLOTS, a.shape[1], b.shape[-1], a.shape[-1]],
                serve_tokens_per_s=sum(c.steps for c in comps) / drain_s)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=Path(__file__).resolve().parents[1])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve() / "src"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = dict(card=card, tree=str(args.src))
    for name in CONFIGS:
        out[name] = time_config(name)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
