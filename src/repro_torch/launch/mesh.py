"""Meshes: ``DeviceMesh`` es over the current ``torch.distributed`` world.

The port of ``repro/launch/mesh.py``.  Functions, not module constants:
a mesh needs the process group, which the caller makes.

Single pod: (16, 16) = 256 ranks over ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks over ("pod", "data", "model"); "pod" is
pure data parallelism across pods.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..checkpoint.manager import _resolve_device
from ..parallel.actctx import one_rank_group

__all__ = ["make_production_mesh", "make_host_mesh", "dp_axes", "TP_AXIS"]

TP_AXIS = "model"


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), over a world of exactly that many ranks; any other world
    (or none) raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(f"make_production_mesh{shape} needs a world of "
                           f"{need} ranks; this process's is {have}")
    return _mesh(device_type, shape, names)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the ranks this world has, cut to fit as the
    reference cuts it to the devices there are.  Without a process group
    it makes a world of one rank (NCCL on the card, gloo on the CPU):
    (1, 1).  ``device`` defaults to the card and raises without one."""
    dev = _resolve_device(device)
    if not dist.is_initialized():
        one_rank_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":         # this rank's card, before the mesh's groups
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    n = dist.get_world_size()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return _mesh(dev.type, (data, model), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (everything except the TP axis)."""
    return tuple(a for a in mesh.mesh_dim_names if a != TP_AXIS)
