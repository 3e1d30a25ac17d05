"""Production training launcher: the FibecFed distributed train step (port
of ``repro.launch.train``).

By default it runs on the card at the full width of ``--arch``: on one
rank the step runs without a mesh (the one-rank program, a ``(1, 1)``
mesh), four client groups of a 16 x 128-token batch; under ``torchrun``
with the production world (256 ranks, 512 with ``--multi-pod``) it runs on
``make_production_mesh``, one client group per ``(pod, data)`` index, on
``--shape``'s batch. ``--dry-run`` evaluates the production step with no
device (``repro_torch.launch.dryrun``); ``--host-demo`` or ``--device cpu``
runs the reduced configuration at the JAX package's demo sizes (4 groups,
batch 16, 128 tokens) on the CPU. Without a card and without either of
those it exits with the port's no-device error.

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200
  python -m repro_torch.launch.train --arch qwen2-0.5b --host-demo --steps 3
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train --arch qwen2-0.5b
"""
import argparse
import os
import time

import numpy as np
import torch


def _init_group(device):
    """The default process group torchrun describes (``WORLD_SIZE`` > 1),
    NCCL on the card; None on one rank."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return dist


def init_run(cfg, device, n_groups: int, *, gal_fraction: float = 0.75, mesh=None):
    """``(model, params, state, generator)`` of a run: params drawn from seed 0, the
    train state with the GAL mask on the first ``gal_fraction`` of the
    logical layers and local masks of ones; on ``mesh`` placed by
    :mod:`repro_torch.launch.shardings`. The generator (on ``device``)
    draws the batches next."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import make_train_state
    from repro_torch.lora import gal_mask_tree, lora_num_logical_layers
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, device)
    state = make_train_state(model, gen, n_groups, device)
    L = lora_num_logical_layers(cfg)
    gal = np.zeros(L, bool)
    gal[: max(1, int(round(gal_fraction * L)))] = True
    state["gal_mask"] = gal_mask_tree(cfg, state["gal_lora"], gal)
    state["local_mask"] = tree_map(torch.ones_like, state["local_mask"])
    if mesh is not None:
        dp = dp_axes(mesh)
        params = shd.distribute(params, mesh, shd.base_param_shardings(
            mesh, params, moe_token_parallel=cfg.moe_token_parallel))
        gal_sh = shd.lora_shardings(mesh, state["gal_lora"])
        local_sh = shd.lora_shardings(mesh, state["local_lora"], client_axes=dp)
        state_sh = {"gal_lora": gal_sh, "gal_m": gal_sh, "gal_v": gal_sh,
                    "gal_mask": shd.lora_shardings(mesh, state["gal_mask"]),
                    "local_lora": local_sh, "local_m": local_sh, "local_v": local_sh, "local_mask": local_sh,
                    "step": shd.replicated(mesh, state["step"])}
        state = {k: shd.distribute(v, mesh, state_sh[k]) for k, v in state.items()}
    return model, params, state, gen


def random_batch(cfg, B: int, S: int, gen):
    """A train batch of ``cfg``'s inputs (``input_specs``) drawn from ``gen``
    on its device: tokens and labels uniform, float inputs (frame or patch
    embeddings) N(0, 1) in the model dtype."""
    from repro_torch.config import InputShape
    from repro_torch.models import build_model

    batch = {}
    for k, spec in build_model(cfg).input_specs(InputShape("train", S, B, "train")).items():
        if spec.dtype.is_floating_point:
            batch[k] = torch.randn(spec.shape, generator=gen, device=gen.device).to(spec.dtype)
        else:
            hi = cfg.num_classes if k == "labels" else cfg.vocab_size
            batch[k] = torch.randint(0, hi, spec.shape, generator=gen, device=gen.device)
    return batch


def train_loop(step, params, state, gen, cfg, B: int, S: int, steps: int, *, mesh=None, log=print):
    """``steps`` train steps on random batches of B sequences of S tokens
    (:func:`random_batch`) drawn from ``gen``; on ``mesh`` the batch is
    placed on its client axes. Returns the state and the losses (floats)."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import dp_axes

    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = random_batch(cfg, B, S, gen)
        if mesh is not None:
            batch = shd.distribute(batch, mesh, shd.batch_shardings(mesh, batch, dp_axes(mesh)))
        state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        if log is not None and (i % 10 == 0 or i == steps - 1):
            log(f"step {i:5d} loss={losses[-1]:.4f} ({(time.time() - t0) / (i + 1):.2f}s/step)")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp_only"])
    ap.add_argument("--dry-run", action="store_true",
                    help="evaluate the production step with no device (as repro_torch.launch.dryrun)")
    ap.add_argument("--host-demo", action="store_true",
                    help="run the REDUCED configuration on the CPU")
    ap.add_argument("--device", default=None, help="cpu runs the reduced configuration; default: the card")
    ap.add_argument("--gal-fraction", type=float, default=0.75)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import dryrun_one

        rec = dryrun_one(args.arch, args.shape, multi_pod=args.multi_pod, layout=args.layout)
        print(rec.get("roofline", rec))
        return rec

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.fibecfed import resolve_device
    from repro_torch.launch.mesh import make_production_mesh, num_client_groups
    from repro_torch.launch.steps import build_train_step
    from repro_torch.utils.tree import tree_map

    device = resolve_device("cpu" if args.host_demo else args.device)
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    dist = _init_group(device)
    if device.type == "cpu":
        cfg = cfg.reduced()
    if dist is None:
        n_groups, B, S = 4, 16, 128
        mesh = None
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=device.type)
        n_groups = num_client_groups(mesh)
        B, S = shape.global_batch, shape.seq_len

    model, params, state, gen = init_run(cfg, device, n_groups, gal_fraction=args.gal_fraction, mesh=mesh)
    step = build_train_step(model, n_groups, learning_rate=args.lr)
    state, _ = train_loop(step, params, state, gen, cfg, B, S, args.steps, mesh=mesh)
    if args.ckpt_dir:
        gal_lora = state["gal_lora"]
        if mesh is not None:
            gal_lora = tree_map(lambda x: x.full_tensor(), gal_lora)
        if mesh is None or dist.get_rank() == 0:
            save_checkpoint(args.ckpt_dir, args.steps, {"gal_lora": gal_lora})
            print(f"checkpoint -> {args.ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
