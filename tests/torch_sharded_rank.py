"""One rank of a multi-rank sharded run on the CPU, for
``tests/test_torch_sharded.py``.

The test spawns G processes (``torch.multiprocessing``, start method
"spawn") with :func:`main` as their target. Each joins a gloo process group
on a ``FileStore`` (no TCP port), builds the port's sharded runner over
``make_client_mesh(device_type="cpu")`` for every run of the spec, drives
it, and writes what it saw to ``<out>/<run>_r<rank>.npz``; a failure writes
its traceback to ``<out>/rank<rank>.err`` and exits non-zero. This module
imports the port only, never JAX or the JAX package.
"""
from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np


def _flat(prefix, tree):
    from repro_torch.convert import to_numpy
    from repro_torch.utils.tree import tree_items

    return {f"{prefix}/{k}": np.asarray(v) for k, v in tree_items(to_numpy(tree))}


def _drive(run, spec, mesh, rank):
    """One configuration: init (or restore), its rounds, and what the test reads."""
    import repro_torch.config as tconfig
    from repro_torch.checkpoint import restore_runner, save_run_checkpoint
    from repro_torch.federated import CompressionConfig, make_runner
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn

    model = build_model(tconfig.ModelConfig(**spec["cfg"]))
    comp = run.get("compression")
    runner = make_runner(
        run.get("baseline", "fibecfed"), model, make_loss_fn(model), tconfig.FibecFedConfig(**spec["fl"]),
        spec["client_data"], optimizer=run["optimizer"], fused_optimizer=run.get("fused", False),
        engine="sharded", mesh=mesh, seed=run["seed"], device="cpu",
        compression=None if comp is None else CompressionConfig(**comp), client_ranks=run.get("client_ranks"),
        init_params=spec["init_params"], init_lora=spec["init_lora"],
    )
    start = 0
    if run.get("resume_from"):
        extra = restore_runner(runner, run["resume_from"])
        start = run["resume_round"]
        assert extra == {}
    else:
        runner.init_phase()
    hist, chosen = [], []
    for t in range(start, run["rounds"]):
        hist.append(runner.run_round(t))
        chosen.append(runner.last_round_info["chosen"].tolist())
        if run.get("snapshot_after") == t + 1:
            save_run_checkpoint(run["snapshot_dir"], runner, t + 1)
    pop = runner.population_state()
    owned = list(runner._owned_clients())
    out = {**_flat("global", runner.global_lora), **_flat("pop_lora", pop["lora"])}
    if "residual" in pop:
        out.update(_flat("pop_residual", pop["residual"]))
    for ci in owned:  # the owner's views are its stack rows
        out.update(_flat(f"client{ci}", runner.clients[ci].lora))
    refused = []
    for ci in range(len(runner.clients)):
        if ci not in owned:
            try:
                runner.clients[ci].lora
            except LookupError as err:
                refused.append([ci, str(err)])
    meta = dict(
        hist=hist, chosen=chosen, comm=runner.comm_bytes_per_round, upload=runner.comm_upload_bytes_per_round,
        orders=[np.asarray(c.order).tolist() for c in runner.clients], gal_layers=runner.gal_layers.tolist(),
        c_stack=runner._C_stack, local_rows=int(runner._sample_valid.shape[0]), owned=owned, refused=refused,
        world=mesh.size(), rank=rank,
    )
    np.savez(os.path.join(spec["out"], f"{run['name']}_r{rank}.npz"), meta=np.asarray(json.dumps(meta)), **out)


def main(rank: int, world: int, spec: dict) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(spec["store"], world), rank=rank,
                                world_size=world)
        try:
            from repro_torch.launch.mesh import make_client_mesh

            mesh = make_client_mesh(device_type="cpu")
            for run in spec["runs"]:
                _drive(run, spec, mesh, rank)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(spec["out"], f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def load(out, name, rank):
    """(meta, arrays) that rank ``rank`` wrote for run ``name``."""
    with np.load(os.path.join(out, f"{name}_r{rank}.npz")) as data:
        arrays = {k: data[k] for k in data.files if k != "meta"}
        return json.loads(str(data["meta"])), arrays
