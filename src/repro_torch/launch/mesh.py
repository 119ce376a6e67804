"""Production mesh construction.

Defined as functions (never module-level constants), so importing this
module never touches device state.  The production meshes are abstract:
their placement rules are pure functions of the extents, and this port
places tensors on one card only (``dist.ctx.constrain``).
"""
from __future__ import annotations

from ..dist import compat


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; multi-pod adds the 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.abstract_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None):
    """Arbitrary mesh for tests / elastic re-meshing."""
    return compat.make_mesh(shape, axes, devices)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """Whatever devices exist locally: the visible cards, or the CPU when
    the trainer runs there (``device_type="cpu"``)."""
    devices = compat.local_devices(device_type)
    n = len(devices)
    if not n:
        raise RuntimeError("no CUDA device is present; pass "
                           "device_type='cpu' for the CPU")
    if model < 1 or n % model:
        raise ValueError(
            f"model axis {model} does not divide the {n} available "
            f"device(s); pass --model-axis dividing the device count")
    return compat.make_mesh((n // model, model), ("data", "model"), devices)
