"""Meshes for the placement rules.

Everything in ``dist.sharding`` reads only ``mesh.axis_names`` and
``mesh.shape`` (a name -> size mapping), so a mesh here is that and, when
it is made from devices, the devices in row-major order over its axes.
``abstract_mesh`` makes one without devices (the production meshes of the
spec tests); ``make_mesh`` one over this process's devices, for a trainer
that runs without a process group; ``device_mesh`` one backed by a
``torch.distributed.device_mesh.DeviceMesh`` over ranks of the initialized
process group (NCCL on the cards, ``gloo`` on the CPU, ``fake`` for the dry
run), on which ``dist.sharding.place`` makes DTensors.  The JAX package's
shims for two generations of ``jax.sharding.AbstractMesh``
(``supports_new_abstract_mesh``, ``install_abstract_mesh_compat``) bridge
a JAX API and have no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class AbstractMesh:
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclass(frozen=True)
class Mesh(AbstractMesh):
    devices: tuple[torch.device, ...] = ()


@dataclass(frozen=True)
class DistMesh(AbstractMesh):
    """A mesh whose axes are the dimensions of ``device_mesh`` (a
    ``DeviceMesh`` with the same extents and names), one rank a position."""
    device_mesh: object = field(default=None, compare=False)

    @property
    def device(self) -> torch.device:
        """This rank's device: its card, or the CPU."""
        kind = self.device_mesh.device_type
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...]) -> AbstractMesh:
    """A mesh of these extents with no devices."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{axis_sizes} sizes for axes {axis_names}")
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """The visible cards, or the one CPU device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the visible cards),
    which must number exactly its size."""
    devices = tuple(local_devices() if devices is None else devices)
    if len(devices) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"got {len(devices)}")
    return Mesh(tuple(shape), tuple(axes), devices)


def device_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...],
                device_type: str, ranks=None) -> DistMesh:
    """A ``DeviceMesh`` of these extents and names over ``ranks`` (default:
    every rank of the initialized process group, in order), which must
    number exactly its size and include this rank."""
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialized process group")
    n = math.prod(axis_sizes)
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) != n:
        raise ValueError(f"a {tuple(axis_sizes)} mesh needs {n} ranks, got "
                         f"{len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(axis_sizes))
    dm = DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))
    return DistMesh(tuple(axis_sizes), tuple(axis_names), dm)
