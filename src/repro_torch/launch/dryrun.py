"""Multi-pod dry run: evaluate every (arch x input shape x mesh) step with
no device and no allocation (port of ``repro.launch.dryrun``).

For each combination this builds the real distributed step (the FibecFed
train step, prefill, or a one-token decode), places its inputs on the
production mesh by :mod:`repro_torch.launch.shardings`, and runs it once
under ``FakeTensorMode`` over a ``fake`` process group of 256 ranks (512
with ``--multi-pod``) in this process, as rank 0: every operation and
every collective of rank 0's program runs on shapes alone.
:class:`~repro_torch.launch.prof_stats.StepCounter` counts its flops,
written bytes and collective bytes, and the record carries the roofline
terms on the card the port runs on (``H100_SXM``). A failure here (a
placement that does not tile, an operation DTensor cannot shard) is a bug.

This is a static analysis: nothing runs on a card, and no number it gives
is a measured time. It is not a fallback for a missing device; the
launchers run on the card or fail.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]

The ``fake`` group is process-wide: run the dry run in a process of its
own (the tests start one).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch import analysis as ana
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.prof_stats import count_step
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step, make_train_state
from repro_torch.models import build_model, sharding_ctx
from repro_torch.utils.tree import tree_bytes


def _fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``world`` ranks (its
    collectives move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def _shapes_only():
    """``FakeTensorMode``, with DTensor's strided-shard offsets (index
    arithmetic on ``arange`` of a dim's size) computed on real tensors: a
    fake tensor has no values to list."""
    from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.local_shard_size_and_offset

    def offsets(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = offsets
    try:
        with FakeTensorMode():
            yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _materialize(specs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fake zeros of each ``input_specs`` entry (meta tensors) on the CPU."""
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


def dryrun_one(
    arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
    debug_mesh: bool = False, reduced: bool = False, overrides: Dict[str, Any] = None,
    layout: str = "tp",
) -> Dict[str, Any]:
    """layout: "tp" (default: tensor parallel on the model axis) or
    "dp_only" (replicate the base model, every mesh axis an FL-client
    axis). ``debug_mesh`` takes a (2, 2) mesh of 4 ranks; ``reduced`` the
    reduced configuration at no more than 512 tokens and 8 sequences
    (wiring tests only, not the production dry run)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    model = build_model(cfg)
    if debug_mesh:
        _fake_group(4)
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    else:
        _fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sizes = shd.mesh_shape(mesh)
    chips = mesh.size()
    dp = dp_axes(mesh) if layout == "tp" else tuple(sizes)
    n_groups = 1
    for a in dp:
        n_groups *= sizes[a]
    if layout == "dp_only":
        n_groups = min(n_groups, shape.global_batch)
        # the client axis must tile the batch exactly; fold axes until it fits
        while shape.global_batch % n_groups:
            n_groups //= 2
    if reduced:
        # a train batch keeps a row for each client group (8 rows do not
        # split into a production mesh's 16 or 32 groups)
        rows = max(8, n_groups) if shape.kind == "train" else 8
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 512), global_batch=min(shape.global_batch, rows)
        )
    sharding_ctx.set_mesh_axes(dp, enabled=True)
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": dict(sizes),
        "chips": chips,
        "multi_pod": multi_pod,
    }
    if not model.supports(shape):
        record["status"] = "skipped"
        record["reason"] = (
            "encoder-only: no decode"
            if cfg.family == "encoder"
            else "long-context decode requires sub-quadratic attention"
        )
        return record

    t0 = time.perf_counter()
    try:
        with _shapes_only():
            gen = torch.Generator()
            params = model.init_params(gen, "cpu")
            n_params = tree_bytes(params) // 2  # the JAX package's count: bytes over bf16's 2
            if layout == "dp_only":
                params_sh = shd.replicated(mesh, params)
            else:
                params_sh = shd.base_param_shardings(mesh, params, moe_token_parallel=cfg.moe_token_parallel)
            params = shd.distribute(params, mesh, params_sh)
            batch = _materialize(model.input_specs(shape))
            if shape.kind == "train":
                state = make_train_state(model, gen, n_groups, "cpu")
                if layout == "dp_only":
                    gal_sh = shd.replicated(mesh, state["gal_lora"])
                    local_sh = shd.shardings_for(mesh, state["local_lora"],
                                                 lambda p, l: shd.batch_spec(p, l, dp, n_groups))
                else:
                    gal_sh = shd.lora_shardings(mesh, state["gal_lora"])
                    local_sh = shd.lora_shardings(mesh, state["local_lora"], client_axes=dp)
                state_sh = {
                    "gal_lora": gal_sh, "gal_m": gal_sh, "gal_v": gal_sh, "gal_mask": gal_sh,
                    "local_lora": local_sh, "local_m": local_sh, "local_v": local_sh, "local_mask": local_sh,
                    "step": shd.replicated(mesh, state["step"]),
                }
                state = {k: shd.distribute(v, mesh, state_sh[k]) for k, v in state.items()}
                batch = shd.distribute(batch, mesh, shd.batch_shardings(mesh, batch, dp))
                step, args = build_train_step(model, n_groups), (params, state, batch)
            elif shape.kind == "prefill":
                lora = model.init_lora(gen, "cpu")
                lora = shd.distribute(lora, mesh, shd.lora_shardings(mesh, lora))
                batch = shd.distribute(batch, mesh, shd.batch_shardings(mesh, batch, dp))
                step, args = build_prefill_step(model, cache_len=shape.seq_len), (params, lora, batch)
            else:  # decode
                lora = model.init_lora(gen, "cpu")
                lora = shd.distribute(lora, mesh, shd.lora_shardings(mesh, lora))
                cache_len = (
                    min(shape.seq_len, cfg.attention_window or shape.seq_len)
                    if shape.seq_len > 65536
                    else shape.seq_len
                )
                cache = model.init_cache(shape.global_batch, cache_len, "cpu")
                cache = shd.distribute(cache, mesh, shd.cache_shardings(mesh, cache, dp, cfg))
                token = shd.distribute({"token": batch["token"]}, mesh,
                                       shd.batch_shardings(mesh, {"token": batch["token"]}, dp))["token"]
                # one token at the cache's last position: attention over all of it
                position = torch.tensor(cache_len - 1, dtype=torch.int32)
                step, args = build_decode_step(model), (params, lora, token, cache, position)
            t_setup = time.perf_counter() - t0
            _, counter = count_step(step, *args)
            t_step = time.perf_counter() - t0 - t_setup
    finally:
        sharding_ctx.disable()

    summary = ana.summarize_step(counter, chips=chips)
    frac = ana.active_param_fraction(cfg)
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch
    mf = (6.0 if shape.kind == "train" else 2.0) * n_params * frac * tokens
    flops_global = summary["hlo_flops"] * chips
    record.update(
        status="ok",
        setup_s=round(t_setup, 2),
        step_s=round(t_step, 2),
        ops=counter.ops,
        n_params=n_params,
        active_fraction=frac,
        model_flops=mf,
        useful_fraction=(mf / flops_global) if flops_global else None,
        **summary,
    )
    if verbose:
        r = summary["roofline"]
        print(
            f"{arch:28s} {shape_name:12s} chips={chips:3d} "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
            f"(setup {t_setup:.0f}s step {t_step:.0f}s)"
        )
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument(
        "--set", action="append", default=[],
        help="ModelConfig override, e.g. --set remat=true --set seq_parallel=true",
    )
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp_only"])
    args = ap.parse_args(argv)

    overrides: Dict[str, Any] = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v

    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for arch, shape, mp in combos:
        tag = f"{arch}_{shape}_{'pod2' if mp else 'pod1'}".replace("/", "-")
        if args.tag:
            tag += f"_{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"skip cached {tag}")
            continue
        try:
            rec = dryrun_one(arch, shape, multi_pod=mp, overrides=overrides or None, layout=args.layout)
        except Exception as e:
            traceback.print_exc()
            rec = {
                "arch": arch, "shape": shape, "multi_pod": mp,
                "status": "failed", "error": f"{type(e).__name__}: {e}",
            }
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    print(f"done; {failures} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
