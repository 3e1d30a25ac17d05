"""The client mesh of the sharded round engine (port of the client-mesh part
of ``repro.launch.mesh``).

FibecFed maps one FL *client group* to each index of a mesh's ``"data"``
axis (and ``"pod"`` axis, where there is one). Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank a card: every rank runs the same runner and holds its
client group's block of the stacked client state. The engine never starts or
ends a process group itself; the launcher does (``torchrun``, or
``init_process_group`` with an address, a world size and a rank).

``make_production_mesh`` and ``make_host_mesh`` (the tensor-parallel
``(data, model)`` meshes of the JAX package's production train step and dry
run) are not here: they come with that launcher (ROADMAP.md, Queue A).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


def make_client_mesh(num_devices: Optional[int] = None, device_type: Optional[str] = None):
    """Data-only mesh for the sharded FL round engine: one ``"data"`` axis,
    one index per rank of the default process group, which the caller must
    have initialized. ``num_devices`` (default: the group's size) must be the
    group's size: in SPMD a rank outside the mesh would have nothing to do.
    ``device_type`` defaults to ``"cuda"``, which needs a card; a CPU mesh
    (gloo) must be asked for with ``device_type="cpu"``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_client_mesh needs a default process group: call "
            "torch.distributed.init_process_group(...) first (or launch with torchrun)"
        )
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"the client mesh spans the whole process group: need {world} devices, got {n}")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the client mesh; pass device_type='cpu' for a CPU mesh")
        device_type = "cuda"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel (client) axes of a mesh."""
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in DP_AXES)


def num_client_groups(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out
