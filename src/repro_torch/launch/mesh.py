"""Meshes over the ranks of the default process group (port of
``repro.launch.mesh``).

FibecFed maps one FL *client group* to each index of a mesh's ``"data"``
axis (and ``"pod"`` axis, where there is one). Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank a card: every rank runs the same runner and holds its
client group's block of the stacked client state. The engine never starts or
ends a process group itself; the launcher does (``torchrun``, or
``init_process_group`` with an address, a world size and a rank).

``make_production_mesh`` and ``make_host_mesh`` are the tensor-parallel
``(data, model)`` meshes of the production train step
(:mod:`repro_torch.launch.steps`) and the dry run
(:mod:`repro_torch.launch.dryrun`): an H100 pod slice of 256 cards is
``(data=16, model=16)``, two pods add a leading ``"pod"`` axis.

Every function here leaves the device type to the caller: it defaults to
``"cuda"`` and raises without a card; a CPU mesh (gloo, or the ``fake``
group of the dry run) must be asked for with ``device_type="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


def _group_size(what: str) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs a default process group: call "
            "torch.distributed.init_process_group(...) first (or launch with torchrun)"
        )
    return dist.get_world_size()


def _device_type(device_type: Optional[str], what: str) -> str:
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for the {what}; pass device_type='cpu' for a CPU mesh")
    return "cuda"


def _mesh(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")``, over the whole default process group, whose size
    must be the mesh's (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _group_size("make_production_mesh")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, the process group has {world}")
    return _mesh(_device_type(device_type, "production mesh"), shape, names)


def make_host_mesh(data: int = 2, model: int = 2, device_type: Optional[str] = None):
    """A small ``("data", "model")`` mesh over whatever ranks exist, shrunk
    as the JAX package's is: ``data`` drops to fit ``world // model``, and a
    mesh that still does not fit falls back to ``(1, 1)``. A mesh smaller
    than the group takes its first ranks; every rank builds it."""
    n = _group_size("make_host_mesh")
    data = min(data, max(1, n // model))
    shape = (data, model) if data * model <= n else (1, 1)
    return _mesh(_device_type(device_type, "host mesh"), shape, ("data", "model"))


def make_client_mesh(num_devices: Optional[int] = None, device_type: Optional[str] = None):
    """Data-only mesh for the sharded FL round engine: one ``"data"`` axis,
    one index per rank of the default process group, which the caller must
    have initialized. ``num_devices`` (default: the group's size) must be the
    group's size: in SPMD a rank outside the mesh would have nothing to do.
    ``device_type`` defaults to ``"cuda"``, which needs a card; a CPU mesh
    (gloo) must be asked for with ``device_type="cpu"``."""
    world = _group_size("make_client_mesh")
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"the client mesh spans the whole process group: need {world} devices, got {n}")
    return _mesh(_device_type(device_type, "client mesh"), (n,), ("data",))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel (client) axes of a mesh."""
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in DP_AXES)


def num_client_groups(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out
