"""One rank of a DTensor train step on the CPU, for
``tests/test_torch_launch_mesh.py``.

The test spawns ``data * model`` processes (``torch.multiprocessing``,
start method "spawn") with :func:`main` as their target. Each joins a gloo
process group on a ``FileStore`` (no TCP port), builds a ``(data, model)``
mesh with ``make_host_mesh``, places the same numpy params, state and batch
on it by ``launch.shardings``, runs the train step ``steps`` times, and
gathers the final state; then it runs the prefill step and two decode steps
on ``serve_lora`` (each rank its client rows). Rank 0 writes the
losses, the full leaves and its rows' logits to ``<out>/mesh.npz``; each
rank writes the shapes of the SSD scans it ran (an SSM or hybrid model) to
``<out>/scans<rank>.npy``. A failure writes its traceback to ``<out>/rank<r>.err``
and exits non-zero. This module imports the port only, never JAX or the JAX
package.
"""
from __future__ import annotations

import os
import sys
import traceback

import numpy as np


def _run(rank: int, spec: dict) -> None:
    import torch

    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import dp_axes, make_host_mesh
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_items, tree_map, unflatten_dict

    model = build_model(spec["cfg"])
    scans = []  # the (B, S, heads, hd) of every SSD scan this rank runs
    if spec["cfg"].ssm is not None:
        from repro_torch.models import ssm

        chunked = ssm.ssd_chunked

        def recorded(x, *args, **kwargs):
            scans.append(tuple(x.shape))
            return chunked(x, *args, **kwargs)

        ssm.ssd_chunked = recorded
    mesh = make_host_mesh(spec["data"], spec["model"], device_type="cpu")
    dp = dp_axes(mesh)
    tensors = lambda flat: tree_map(torch.from_numpy, unflatten_dict(flat))  # noqa: E731
    params, state, batch = tensors(spec["params"]), tensors(spec["state"]), tensors(spec["batch"])
    params = shd.distribute(params, mesh, shd.base_param_shardings(mesh, params))
    gal_sh = shd.lora_shardings(mesh, state["gal_lora"])
    local_sh = shd.lora_shardings(mesh, state["local_lora"], client_axes=dp)
    state_sh = {"gal_lora": gal_sh, "gal_m": gal_sh, "gal_v": gal_sh,
                "gal_mask": shd.lora_shardings(mesh, state["gal_mask"]),
                "local_lora": local_sh, "local_m": local_sh, "local_v": local_sh, "local_mask": local_sh,
                "step": shd.replicated(mesh, state["step"])}
    state = {k: shd.distribute(v, mesh, state_sh[k]) for k, v in state.items()}
    batch = shd.distribute(batch, mesh, shd.batch_shardings(mesh, batch, dp))
    step = build_train_step(model, spec["n_groups"], learning_rate=spec["lr"])
    losses = []
    for _ in range(spec["steps"]):
        state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    full = {f"state/{k}": v.full_tensor().numpy() for k, v in tree_items(state)}
    placed = {k: str(v.placements) for k, v in tree_items(state)}
    # the prefill and decode steps on the no-mesh run's trained GAL LoRA:
    # each rank serves its client rows; rank 0 keeps its block's logits
    lora = tensors(spec["serve_lora"])
    lora = shd.distribute(lora, mesh, shd.lora_shardings(mesh, lora))
    logits, cache = build_prefill_step(model, spec["cache_len"])(params, lora, batch)
    served = [logits]
    token = shd.distribute({"t": torch.from_numpy(spec["decode_tokens"])}, mesh,
                           shd.batch_shardings(mesh, {"t": torch.from_numpy(spec["decode_tokens"])}, dp))["t"]
    rows = logits.shape[0]
    for j in range(2):
        logits, cache = build_decode_step(model)(params, lora, token, cache, spec["prompt_len"] + j)
        served.append(logits)
    served = [x.full_tensor() if hasattr(x, "full_tensor") else x for x in served]
    np.save(os.path.join(spec["out"], f"scans{rank}.npy"), np.asarray(scans, dtype=np.int64).reshape(-1, 4))
    if rank == 0:
        np.savez(os.path.join(spec["out"], "mesh.npz"), losses=np.asarray(losses),
                 placements=np.asarray(repr(placed)), served=torch.cat(served, 1).numpy(), rows=rows, **full)


def main(rank: int, world: int, spec: dict) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(spec["store"], world), rank=rank, world_size=world)
        try:
            _run(rank, spec)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(spec["out"], f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
