"""Meshes over ``torch.distributed`` ranks (port of ``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
axes; collectives run on its per-axis groups (``mesh.get_group("pod")``).
Parameters are replicated on every rank, so every mesh here is
data-parallel: the fleet mesh carries the ("pod", "data") axes over which
rollout lanes and training batches split.

These are functions: importing the module touches no process group.
:func:`init_fleet` starts one with the backend :func:`fleet_backend` picks
(NCCL where each rank has its own card, gloo on the CPU and where ranks
share a card); it never switches backend when initialisation fails. Every
mesh needs a process group up; ranks outside a prefix mesh
(``num_devices`` below the world) hold no coordinate in it.

The reference's ``HW`` table holds TPU v5e constants for its roofline
tool and is not carried over.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def fleet_backend(world_size: int, device=None) -> str:
    """``"nccl"`` when the ranks run on cards and each has its own
    (``world_size`` at most the cards this host sees), else ``"gloo"``
    (the CPU, or ranks sharing a card)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_fleet(rank: int, world_size: int, init_method: str, *,
               device=None, backend: Optional[str] = None) -> str:
    """Start this process's group: ``init_method`` such as
    ``"tcp://localhost:<port>"``, and the backend :func:`fleet_backend`
    picks unless ``backend`` is given. With NCCL the rank takes card
    ``rank % device_count``. Returns the backend; an initialisation that
    fails raises."""
    backend = backend or fleet_backend(world_size, device)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs a process group: call "
                           "repro_torch.launch.mesh.init_fleet (or "
                           "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def _mesh(shape: Sequence[int], axes: Tuple[str, ...]):
    """A DeviceMesh over ranks 0 .. prod(shape) - 1, row-major. Its
    device type follows the backend: "cuda" over NCCL, "cpu" over gloo
    (which stages card tensors through host memory)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The production layout: (16, 16) ("data", "model") over 256 ranks,
    or (2, 16, 16) ("pod", "data", "model") over 512. Raises a
    ``ValueError`` naming the ranks it needs when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"the production mesh {shape} {axes} needs {need} "
                         f"ranks; this world has {world}")
    return _mesh(shape, axes)


def make_mesh_for(num_devices: Optional[int] = None, model_axis: int = None):
    """Small ("data", "model") mesh over the first ``num_devices`` ranks
    (default all), the model axis 2 where the count is even."""
    n = num_devices or _world()
    m = model_axis or (2 if n % 2 == 0 and n > 1 else 1)
    return _mesh((n // m, m), ("data", "model"))


def make_fleet_mesh(num_devices: Optional[int] = None, *, pods: int = 1):
    """Scene-axis mesh for fleet rollouts, closed-loop evaluation and the
    data-parallel train step: ("pod", "data") over the first
    ``num_devices`` ranks (default all), ``pods`` of them on the leading
    axis. Raises when the ranks do not split into ``pods``."""
    n = num_devices or _world()
    if n % max(pods, 1) != 0:
        raise ValueError(f"{n} devices do not split into {pods} pods")
    if n > _world():
        raise ValueError(f"{n} devices asked for; this world has "
                         f"{dist.get_world_size()}")
    return _mesh((pods, n // pods), ("pod", "data"))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, or the mapping itself (the
    sharding resolver reads only the sizes, as the reference's reads
    ``mesh.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def rank0_tempdir(prefix: str) -> str:
    """A fresh temporary directory, rank 0's on every rank when a process
    group is up (one directory for every rank's checkpoints)."""
    import tempfile
    if not (dist.is_available() and dist.is_initialized()):
        return tempfile.mkdtemp(prefix=prefix)
    box = [tempfile.mkdtemp(prefix=prefix) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
