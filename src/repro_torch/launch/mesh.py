"""Production mesh construction.

Defined as functions (never module-level constants), so importing this
module never touches device or process-group state.  The production meshes
are abstract by default: their placement rules are pure functions of the
extents.  With ``fake_group=True`` they are ``DeviceMesh``es over the ranks
of a ``fake`` process group of ``FAKE_WORLD`` ranks, on which the dry run
places fake tensors: one world of 512 ranks serves both meshes, the single
one (256) over its first 256 ranks, so ``--mesh both`` runs in one process
without tearing the group down.  ``make_host_mesh`` is a ``DeviceMesh`` over
the ranks of the initialized process group (NCCL on the cards, ``gloo`` on
the CPU), and without a process group the mesh of this process's one
device.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..dist import compat

#: ranks of the fake process group the dry run's meshes live on
FAKE_WORLD = 512


def _production_shape(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False,
                         fake_group: bool = False):
    """16x16 = 256 chips per pod; multi-pod adds the 2-pod axis (512).
    Abstract, or with ``fake_group`` a ``DistMesh`` on the CPU over ranks
    of a ``fake`` process group (started here when none is)."""
    shape, axes = _production_shape(multi_pod)
    if not fake_group:
        return compat.abstract_mesh(shape, axes)
    init_fake_group()
    return compat.device_mesh(shape, axes, "cpu",
                              ranks=range(math.prod(shape)))


def init_fake_group(world: int = FAKE_WORLD) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    its collectives return at once and move nothing.  Raises when another
    process group is initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() != "fake"
                or dist.get_world_size() != world):
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is initialized; the dry run "
                f"needs a fake one of {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None):
    """Arbitrary mesh for tests / elastic re-meshing."""
    return compat.make_mesh(shape, axes, devices)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over every rank of the initialized process
    group, a ``DistMesh`` with one device a rank; without a process group
    the visible cards, or the CPU when the trainer runs there
    (``device_type="cpu"``)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass "
                           "device_type='cpu' for the CPU")
    if dist.is_initialized():
        n = dist.get_world_size()
        _check_model_axis(model, n)
        return compat.device_mesh((n // model, model), ("data", "model"),
                                  device_type)
    devices = compat.local_devices(device_type)
    n = len(devices)
    _check_model_axis(model, n)
    return compat.make_mesh((n // model, model), ("data", "model"), devices)


def _check_model_axis(model: int, n: int) -> None:
    if model < 1 or n % model:
        raise ValueError(
            f"model axis {model} does not divide the {n} available "
            f"device(s); pass --model-axis dividing the device count")
