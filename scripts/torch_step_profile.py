"""Where a training step of the PyTorch port spends its time, on the card.

Builds full-width qwen2-0.5b in the port, with a seeded torch init and
the main path's batch (4 sequences of 64 tokens), then times (host clock around synchronized work, median of several calls):

- the loop engine's training step: ``torch.func.grad_and_value`` of the
  label-token loss plus the fused masked AdamW update (kernel B1);
- the vectorized engine's step over a cohort of 4 clients: per-client
  gradients under ``torch.func.vmap`` plus one stacked B1 update;
- the forward alone, without autograd;
- per-sample Fisher scoring of one batch (``torch.func.vmap(grad)``), the
  init phase's unit of work;

and prints ``torch.profiler`` tables of one loop step, by host and by
device time, with the kernel time and kernel and aten-call counts of one
loop step and of one cohort step.

    python3 scripts/torch_step_profile.py
"""
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import engine, fisher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402


def wall(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


ARCH, BATCH, SEQ, SEED, COHORT = "qwen2-0.5b", 4, 64, 0, 4  # chip_smoke.py's main path


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ARCHS[ARCH]
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init_params(gen, dev)
    lora = model.init_lora(gen, dev)
    loss_fn = make_loss_fn(model)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device=dev),
        "label_token": torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen, device=dev),
    }
    mask = tree_map(lambda x: (torch.rand(x.shape, generator=gen, device=dev) < 0.5).float(), lora)
    opt_init, opt_update = make_optimizer("adamw", fused=True)
    state = {"lora": lora, "opt": opt_init(lora)}

    def step():
        grads, loss = torch.func.grad_and_value(lambda lo: loss_fn(params, lo, batch))(state["lora"])
        state["lora"], state["opt"] = opt_update(grads, state["opt"], state["lora"], 4e-4, mask)
        return loss

    stack = lambda x: x[None].expand(COHORT, *x.shape).clone()  # noqa: E731
    cohort = {"lora": tree_map(stack, lora), "opt": tree_map(stack, opt_init(lora)),
              "mask": tree_map(stack, mask), "batch": tree_map(stack, batch),
              "sv": torch.ones(COHORT, BATCH, device=dev), "active": torch.ones(COHORT, device=dev)}
    client_step = engine.make_client_step(loss_fn, opt_update)

    def cohort_step():
        c = cohort
        loss, c["lora"], c["opt"] = client_step(params, c["lora"], c["opt"], c["mask"], c["batch"], c["sv"],
                                                4e-4, c["active"])
        return loss

    def forward():
        with torch.no_grad():
            return model.forward(params, state["lora"], batch)

    def fisher_scores():
        return fisher.per_sample_fisher_scores(loss_fn, params, state["lora"], batch)

    for fn in (step, cohort_step, forward, fisher_scores):
        fn()  # warm-up
    times = {
        "train_step_s": wall(step, 5),
        "cohort_step_s": wall(cohort_step, 5),
        "forward_s": wall(forward, 5),
        "fisher_scores_s": wall(fisher_scores, 3),
    }
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels only: an aten op's row repeats the device time of its kernels
    device_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    print(events.table(sort_by="self_cpu_time_total", row_limit=20))
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    times["profiled_step_kernel_us"] = device_us
    times["profiled_step_kernels"] = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    times["profiled_step_aten_calls"] = sum(e.count for e in events if e.key.startswith("aten::"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cohort_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    times["profiled_cohort_step_kernel_us"] = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    times["profiled_cohort_step_kernels"] = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    times["profiled_cohort_step_aten_calls"] = sum(e.count for e in events if e.key.startswith("aten::"))
    print(json.dumps({"arch": ARCH, "batch": BATCH, "seq": SEQ, "cohort": COHORT,
                      "device": torch.cuda.get_device_name(0), **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
