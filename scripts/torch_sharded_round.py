"""What the sharded engine costs over the vectorized one at one rank, on the card.

Builds ``chip_smoke.py``'s phase 5 world (full-width qwen2-0.5b, bf16, seeded
init, the keyword task over 8 clients, cohort 4, batch 4; FibecFed with the
fused AdamW), a vectorized runner and a sharded runner on a 1-rank NCCL
process group, initializes both, and then:

- runs their rounds in turns (round t of one engine, then round t of the
  other, which goes first swapped each round; host clock around
  synchronized work): the same cohorts and steps on both;
- runs one more sharded round with its parts timed (each part between two
  synchronizations): the exchange plan, the rows' trip to their training
  rank and back, the FedAvg's all-reduce, the losses' gather, and the rest
  (the vectorized body);
- profiles one more round of each engine (``torch.profiler``): kernels
  launched, device time, and the NCCL kernels' share.

Prints the card's name and power limit and one JSON line.

    python3 scripts/torch_sharded_round.py [--rounds 6]
"""
import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import data as data_mod  # noqa: E402
from repro_torch.config import FibecFedConfig  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.federated import make_runner  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_parts(parts):
    """Wrap the sharded round's collective steps so that each adds its
    synchronized seconds to ``parts``; returns the undo."""
    saved = {}

    def wrap(owner, name, part):
        fn = getattr(owner, name)
        saved[owner, name] = fn

        def wrapped(*args, **kw):
            out, secs = synced(lambda: fn(*args, **kw))
            parts[part] += secs
            return out

        setattr(owner, name, wrapped)

    wrap(eng._RowExchange, "__init__", "plan")
    wrap(eng._RowExchange, "fetch", "rows_to_trainer")
    wrap(eng._RowExchange, "give_back", "rows_to_owner")
    wrap(eng, "_all_reduce_sum", "fedavg_all_reduce")
    wrap(eng, "all_gather_rows", "losses_gather")
    return lambda: [setattr(owner, name, fn) for (owner, name), fn in saved.items()]


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    return dict(kernels=int(sum(e.count for e in events)), device_ms=total, nccl_ms=nccl)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ARCHS["qwen2-0.5b"]
    model = build_model(cfg)
    loss_fn = make_loss_fn(model)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=args.rounds + 2, batch_size=4)
    task = data_mod.make_keyword_task(n_samples=256, seq_len=64, vocab_size=cfg.vocab_size, seed=0)
    parts_idx = data_mod.dirichlet_partition(task.data["label"], fl.num_devices, fl.dirichlet_alpha, seed=0)
    clients = [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts_idx]

    tmp = tempfile.TemporaryDirectory(prefix="sharded_round_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp.name, "store"), 1), rank=0, world_size=1)
    try:
        runners, init_s = {}, {}
        for engine in ("vectorized", "sharded"):
            kw = {"mesh": make_client_mesh()} if engine == "sharded" else {}
            runners[engine] = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                                          fused_optimizer=True, engine=engine, seed=0, **kw)
            _, init_s[engine] = synced(runners[engine].init_phase)
        rounds = {"vectorized": [], "sharded": []}
        stats = {"vectorized": [], "sharded": []}
        for t in range(args.rounds):
            order = ("vectorized", "sharded") if t % 2 == 0 else ("sharded", "vectorized")
            for engine in order:
                st, secs = synced(lambda: runners[engine].run_round(t))
                rounds[engine].append(secs)
                stats[engine].append(st)
        if stats["vectorized"] != stats["sharded"]:
            raise AssertionError("the engines' rounds differ")
        t = args.rounds
        parts = collections.defaultdict(float)
        undo = timed_parts(parts)
        try:
            _, sharded_s = synced(lambda: runners["sharded"].run_round(t))
        finally:
            undo()
        _, vec_s = synced(lambda: runners["vectorized"].run_round(t))
        parts = dict(parts, rest=sharded_s - sum(parts.values()))
        prof = {engine: profiled(lambda e=engine: runners[e].run_round(t + 1)) for engine in ("vectorized", "sharded")}
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    out = dict(
        device=smi, init_s=init_s, round_s=rounds, padded_steps=[s["padded_steps"] for s in stats["vectorized"]],
        median_extra_s=statistics.median(b - a for a, b in zip(rounds["vectorized"], rounds["sharded"])),
        instrumented=dict(round=t, sharded_s=sharded_s, vectorized_s=vec_s, parts_s=parts), profile=prof,
    )
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
