"""The device mesh of the sharded renders (counterpart of
``raytracer_tpu/parallel/sharding.py`` ``make_mesh``), over
``torch.distributed``: one process per device, and a mesh of named axes
over the ranks of the default process group.

JAX lays devices out in a mesh and ``shard_map`` runs one body on each;
here every rank runs the body itself, and :class:`Mesh` gives it its
coordinates, its device and the collectives along an axis. Rank r of a
(rows, spp) mesh sits at (r // spp, r % spp), row-major, as JAX reshapes
its device list.

The collectives run on the tensor's device under NCCL. Gloo has no
all-gather for CUDA tensors, so under gloo they copy to the host and back
(several ranks sharing one card must use gloo: NCCL refuses two ranks on
one GPU). The mesh reads the backend once, when it is made.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axes, its device, the backend."""

    device_mesh: DeviceMesh
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (as ``jax.sharding.Mesh``)."""
        return {name: self.device_mesh.size(i)
                for i, name in enumerate(self.axis_names)}

    def size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``; 0 for an axis the mesh
        does not have."""
        if axis not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def _group(self, axis: str | None):
        return None if axis is None else self.device_mesh.get_group(axis)

    def _on_host(self, tensor: torch.Tensor) -> bool:
        return self.backend == "gloo" and tensor.device.type != "cpu"

    def all_reduce(self, axis: str | None, tensor: torch.Tensor):
        """Sum ``tensor`` over ``axis`` (every rank when None), in place;
        returns it. Nothing moves along an axis the mesh does not have;
        an axis of size 1 still runs the collective."""
        if axis is not None and axis not in self.axis_names:
            return tensor
        work = tensor.cpu() if self._on_host(tensor) else tensor
        dist.all_reduce(work, group=self._group(axis))
        if work is not tensor:
            tensor.copy_(work)
        return tensor

    def all_gather(self, axis: str, tensor: torch.Tensor) -> list:
        """Every rank's ``tensor`` along ``axis``, in coordinate order, on
        ``tensor``'s device (equal shapes on every rank); ``[tensor]``
        for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return [tensor]
        work = (tensor.cpu() if self._on_host(tensor) else tensor).contiguous()
        out = [torch.empty_like(work) for _ in range(self.size(axis))]
        dist.all_gather(out, work, group=self._group(axis))
        return [t.to(tensor.device) for t in out]


def rank_device(device=None) -> torch.device:
    """``device`` as given, else this rank's card: ``cuda:(LOCAL_RANK or
    rank) % device_count``. Raises where CUDA is asked for and absent."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to shard over gloo "
            "on the host"
        )
    if device is None or device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_mesh(axis_sizes: Sequence[int],
              axis_names: Sequence[str] = ("rows", "spp"), *,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` of shape ``axis_sizes`` over the
    initialised default process group, whose world size must be the
    product of the sizes. ``device`` defaults to this rank's card (see
    :func:`rank_device`); the host only when asked for (``'cpu'``, gloo)."""
    axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for the "
                         f"{len(axis_names)} axes {axis_names}")
    if "rows" not in axis_names or not set(axis_names) <= {"rows", "spp"}:
        raise ValueError(f"the mesh's axes are 'rows' and optionally "
                         f"'spp', got {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    n = math.prod(axis_sizes)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {axis_sizes} needs {n} devices, the process group has "
            f"{world}"
        )
    device = rank_device(device)
    backend = dist.get_backend()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        # before the mesh is made, so it keeps this rank's card
        torch.cuda.init()
        torch.cuda.set_device(device)
    return Mesh(init_device_mesh(device.type, axis_sizes,
                                 mesh_dim_names=axis_names),
                device, backend)
