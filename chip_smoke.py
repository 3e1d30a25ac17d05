#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one card.

Run from the repository root with ``python3 chip_smoke.py``. It needs a CUDA
device and exits non-zero without one, or if any phase fails:

1. device: the card's name and power limit;
2. build: compile the hand-written CUDA kernels from ``src/repro_torch``;
3. kernels against their plain PyTorch versions, on the card, at every LoRA
   leaf shape of full qwen2-0.5b, and their times over the whole LoRA tree;
4. the slice at full width: FibecFed (adamw, fused kernels, loop engine) for
   2 rounds and FedAvg+LoRA (sgd, fused) for 1 round on qwen2-0.5b (24
   layers, d 896, vocab 151936, bf16, seeded torch init), with the kernels'
   launch counts read around this phase only;
5. the same FibecFed round unfused, which must agree with the fused one
   (loss rel 1e-6, global LoRA atol 1e-6: the same arithmetic in the same
   order);
6. one JSON line listing the kernels; last, the ok line.

Float32 matmuls run in full f32 (TF32 off for matmuls and cuDNN alike).
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
LEAF_SHAPES = {"a": (24, 896, 8), "b_q_o": (24, 8, 896), "b_k_v": (24, 8, 128)}
KERNELS = {
    "masked_adamw_update": dict(
        replaces="src/repro/kernels/masked_update.py:75",
        bytes_per_elem=32,  # p, g, m, v, mask read; p, m, v written (f32)
        flops_per_elem=14,
    ),
    "masked_sgd_update": dict(
        replaces="src/repro/kernels/masked_update.py:55",
        bytes_per_elem=12,  # p, g read; p written (f32, no momentum, no mask)
        flops_per_elem=2,
    ),
}
SOURCE = "src/repro_torch/kernels/csrc/masked_update.cu"


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
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


def check_update(out, plain, old, frozen, what):
    """Frozen entries keep their bits; live ones agree with the plain version
    within 1e-6 relative (f32) or one ulp (bf16). Returns the max abs error."""
    if not torch.equal(out[frozen], old[frozen]):
        raise AssertionError(f"{what}: frozen entries changed")
    live = ~frozen
    if not bool(live.any()):
        return 0.0
    o, p = out[live].float(), plain[live].float()
    err = (o - p).abs()
    ulp = torch.finfo(out.dtype).eps if out.dtype == torch.bfloat16 else 1e-6
    bound = ulp * torch.maximum(p.abs(), torch.full_like(p, p.abs().max().item() * 1e-3))
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond tolerance")
    return err.max().item()


def phase_kernels(ops, ref, gen):
    """Phase 3: each kernel against its plain version at the main-path shapes."""
    errs = {name: 0.0 for name in KERNELS}
    lr = 1e-3
    for shape_name, shape in LEAF_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            p, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
            m = torch.randn(shape, generator=gen, device="cuda") * 0.1
            v = torch.rand(shape, generator=gen, device="cuda") * 0.1
            half = (torch.rand(shape, generator=gen, device="cuda") < 0.5).float()
            for mask in (None, half):
                for active in (0.0, 1.0):
                    frozen = torch.zeros(shape, dtype=torch.bool, device="cuda") if mask is None else mask == 0
                    frozen = frozen | (active == 0.0)
                    what = f"{shape_name} {dtype} mask={mask is not None} active={active}"
                    # B1: AdamW
                    t = torch.tensor(4, dtype=torch.int32, device="cuda")
                    st = {"m": {"w": m}, "v": {"w": v}, "t": t}
                    mk = None if mask is None else {"w": mask}
                    new_p, new_st = ops.masked_adamw_update({"w": g}, st, {"w": p}, lr, mk, active)
                    _, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
                    lr_t = torch.tensor(lr, dtype=torch.float32, device="cuda")
                    pp, pm, pv = ref.masked_adamw_update_ref(p, g, m, v, mask, lr_t, mhat, vhat, active=active)
                    for out, plain, old, n in ((new_p["w"], pp, p, "p"), (new_st["m"]["w"], pm, m, "m"),
                                               (new_st["v"]["w"], pv, v, "v")):
                        e = check_update(out, plain, old, frozen, f"adamw {n} {what}")
                        errs["masked_adamw_update"] = max(errs["masked_adamw_update"], e)
                    # B2: SGD, with and without momentum
                    for momentum in (0.0, 0.9):
                        st = {"mu": {"w": m}} if momentum else {}
                        new_p, new_st = ops.masked_sgd_update({"w": g}, st, {"w": p}, lr, mk, active,
                                                              momentum=momentum)
                        pp, pmu = ref.masked_sgd_update_ref(p, g, m if momentum else None, mask, lr_t,
                                                            momentum=momentum, active=active)
                        e = check_update(new_p["w"], pp, p, frozen, f"sgd({momentum}) p {what}")
                        if momentum:
                            e = max(e, check_update(new_st["mu"]["w"], pmu, m, frozen, f"sgd mu {what}"))
                        errs["masked_sgd_update"] = max(errs["masked_sgd_update"], e)
    torch.cuda.synchronize()
    log("kernel vs plain: all leaf shapes, f32/bf16, mask on/off, active 0/1, momentum 0/0.9 agree;",
        "max abs err", errs)
    return errs


def lora_tree(gen, kind):
    """A full-width qwen2-0.5b LoRA-shaped tree of random f32 leaves."""
    shapes = {"wq": ("a", "b_q_o"), "wk": ("a", "b_k_v"), "wv": ("a", "b_k_v"), "wo": ("a", "b_q_o")}
    out = {}
    for t, (sa, sb) in shapes.items():
        out[t] = {"a": kind(LEAF_SHAPES[sa]), "b": kind(LEAF_SHAPES[sb])}
    return {"layers": out}


def phase_timing(ops, ref, gen, tree_leaves, tree_map):
    """Kernel, plain-version and library times of one optimizer step over
    the whole LoRA tree, in the main path's configuration."""
    randn = lambda s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    params, grads = lora_tree(gen, randn), lora_tree(gen, randn)
    n = sum(x.numel() for x in tree_leaves(params))
    lr = 4e-4
    # B1 as fibecfed runs it: f32, every leaf masked (a: ones, b: neuron mask)
    mask = tree_map(lambda x: (torch.rand(x.shape, generator=gen, device="cuda") < 0.5).float(), params)
    for ab in mask["layers"].values():
        ab["a"].fill_(1.0)
    st = {"m": tree_map(lambda x: x * 0.01, grads), "v": tree_map(lambda x: x * x * 1e-3, grads),
          "t": torch.tensor(3, dtype=torch.int32, device="cuda")}

    def plain_adamw():
        t, mhat, vhat = ops.adam_step_scales(st["t"], None, 0.9, 0.999)
        lr_t = torch.tensor(lr, dtype=torch.float32, device="cuda")
        return tree_map(lambda p, g, m, v, mk: ref.masked_adamw_update_ref(p, g, m, v, mk, lr_t, mhat, vhat),
                        params, grads, st["m"], st["v"], mask)

    def plain_sgd():
        lr_t = torch.tensor(lr, dtype=torch.float32, device="cuda")
        return tree_map(lambda p, g: ref.masked_sgd_update_ref(p, g, None, None, lr_t), params, grads)

    p_list, g_list = tree_leaves(params), tree_leaves(grads)
    times = {
        "masked_adamw_update": dict(
            ms=cuda_ms(lambda: ops.masked_adamw_update(grads, st, params, lr, mask)),
            plain_ms=cuda_ms(plain_adamw),
            # no single PyTorch call computes a masked AdamW step
            library_ms=None,
        ),
        "masked_sgd_update": dict(
            ms=cuda_ms(lambda: ops.masked_sgd_update(grads, {}, params, lr)),
            plain_ms=cuda_ms(plain_sgd),
            library_ms=cuda_ms(lambda: torch._foreach_add(p_list, g_list, alpha=-lr)),
        ),
    }
    for name, spec in KERNELS.items():
        bytes_s = n * spec["bytes_per_elem"] / HBM_BYTES_PER_S
        flops_s = n * spec["flops_per_elem"] / F32_FLOPS_PER_S
        times[name]["bound_ms"] = max(bytes_s, flops_s) * 1e3
        times[name]["bound_by"] = "bytes" if bytes_s >= flops_s else "operations"
    log(f"one optimizer step over the LoRA tree ({n} elements, 8 leaves):", json.dumps(times))
    return times


def keyword_world(vocab_size, data_mod, fl):
    task = data_mod.make_keyword_task(n_samples=256, seq_len=64, vocab_size=vocab_size, seed=0)
    parts = data_mod.dirichlet_partition(task.data["label"], fl.num_devices, fl.dirichlet_alpha, seed=0)
    return [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]


def expected_comm_bytes(cfg, gal_layers, k):
    """Pull + push of the GAL layers' f32 LoRA values, per round."""
    hd, r, d = cfg.resolved_head_dim, cfg.lora_rank, cfg.d_model
    per_layer = sum(d_in * r + r * d_out for d_in, d_out in (
        (d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd), (d, cfg.num_kv_heads * hd),
        (cfg.num_heads * hd, d)))
    return 2 * int(np.sum(gal_layers)) * per_layer * 4 * k


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import data as data_mod
    from repro_torch.config import FibecFedConfig
    from repro_torch.configs import ARCHS
    from repro_torch.federated import make_runner
    from repro_torch.kernels import build, masked_update, ops, ref
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.utils.tree import tree_clone, tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device:", kind, "|", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)

    # --- 2. build ---
    t0 = time.perf_counter()
    _, report = build.compile_cuda(masked_update.SOURCE)
    masked_update.library()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    log("\n".join(line for line in report.splitlines() if "Used" in line))

    # --- 3. kernels against their plain versions ---
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(ops, ref, gen)
    times = phase_timing(ops, ref, gen, tree_leaves, tree_map)

    # --- 4. the slice at full width ---
    cfg = ARCHS["qwen2-0.5b"]
    model = build_model(cfg)
    loss_fn = make_loss_fn(model)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=2, batch_size=4)
    clients = keyword_world(cfg.vocab_size, data_mod, fl)
    log("clients' samples:", [len(c["tokens"]) for c in clients])
    ops.masked_adamw_update.launches = 0
    ops.masked_sgd_update.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runner = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                         fused_optimizer=True, engine="loop", seed=0)
    _, init_s = timed(runner.init_phase)
    log(f"fibecfed init_phase: {init_s:.2f} s; gal layers {np.flatnonzero(runner.gal_layers).tolist()}")
    fib_steps, fib_hist = 0, []
    for t in range(fl.rounds):
        stats, secs = timed(lambda: runner.run_round(t))
        fib_hist.append(stats)
        fib_steps += int(runner.last_round_info["client_steps"].sum())
        log(f"fibecfed round {t}: {secs:.2f} s, {json.dumps(stats)}")
        if not math.isfinite(stats["loss"]):
            raise AssertionError(f"round {t} loss is not finite")
        want = expected_comm_bytes(cfg, runner.gal_layers, fl.devices_per_round)
        if runner.comm_bytes_per_round[t] != want or not isinstance(runner.comm_bytes_per_round[t], int):
            raise AssertionError(f"comm bytes {runner.comm_bytes_per_round[t]} != {want}")
        if t == 0:
            round0 = (stats["loss"], tree_clone(runner.global_lora))
    fused_decisions = ([c.order.copy() for c in runner.clients], runner.gal_layers.copy())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"fibecfed peak device memory: {peak_gib:.2f} GiB")
    del runner

    fed = make_runner("fedavg_lora", model, loss_fn, fl, clients, optimizer="sgd",
                      fused_optimizer=True, engine="loop", seed=0)
    _, fed_init_s = timed(fed.init_phase)
    stats, secs = timed(lambda: fed.run_round(0))
    log(f"fedavg_lora init_phase: {fed_init_s:.2f} s; round 0: {secs:.2f} s, {json.dumps(stats)}")
    if not math.isfinite(stats["loss"]):
        raise AssertionError("fedavg_lora loss is not finite")
    if fed.comm_bytes_per_round[0] != expected_comm_bytes(cfg, np.ones(cfg.num_layers), fl.devices_per_round):
        raise AssertionError(f"fedavg_lora comm bytes {fed.comm_bytes_per_round[0]}")
    fed_steps = int(fed.last_round_info["client_steps"].sum())
    del fed
    launches = {
        "masked_adamw_update": ops.masked_adamw_update.launches,
        "masked_sgd_update": ops.masked_sgd_update.launches,
    }
    n_leaves = 8
    log("launches on the main path:", launches, "steps:", {"fibecfed": fib_steps, "fedavg_lora": fed_steps})
    if launches["masked_adamw_update"] != n_leaves * fib_steps or fib_steps == 0:
        raise AssertionError("the fibecfed run did not go through the AdamW kernel once per leaf and step")
    if launches["masked_sgd_update"] != n_leaves * fed_steps or fed_steps == 0:
        raise AssertionError("the fedavg_lora run did not go through the SGD kernel once per leaf and step")

    # --- 5. fused against unfused, in situ ---
    plain = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                        fused_optimizer=False, engine="loop", seed=0)
    plain.init_phase()
    for a, b in zip(fused_decisions[0], [c.order for c in plain.clients]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fused_decisions[1], plain.gal_layers)
    stats = plain.run_round(0)
    rel = abs(stats["loss"] - round0[0]) / abs(round0[0])
    lora_err = max((a - b).abs().max().item()
                   for a, b in zip(tree_leaves(plain.global_lora), tree_leaves(round0[1])))
    log(f"fused vs unfused round 0: loss {round0[0]} vs {stats['loss']} (rel {rel:.3g}); "
        f"global LoRA max abs diff {lora_err:.3g}")
    # the unfused update does the kernel's arithmetic in the same order, so
    # the two runs agree to float noise or a kernel is at fault
    if rel > 1e-6 or lora_err > 1e-6:
        raise AssertionError("fused and unfused runs disagree")
    del plain

    # --- 6. kernel list, card, ok ---
    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=spec["replaces"],
             launches=launches[name], max_abs_err=errs[name], **times[name])
        for name, spec in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
