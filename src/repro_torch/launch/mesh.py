"""The model mesh: named axes over a grid of devices (port of
``repro/launch/mesh.py``).

The reference lays its serving and training steps out on a
``jax.sharding.Mesh`` — ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods — and lets one controller
drive every chip.  The port keeps the client mesh's design
(``sharding/clients.py``): one process, no process group, and explicit
placement.  A :class:`DeviceMesh` is a grid of ``torch.device``\\ s with
named axes; coordinates are visited in row-major order, and devices may
repeat (every shard on one card, one shard per card on a node with
several, or ``cpu`` in the tests).  Its :attr:`DeviceMesh.shape` is the
mapping ``jax.sharding.Mesh.shape`` is, so the sharding rules
(``sharding/specs.py``) read both alike.

Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.device import default_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named axes of the given sizes; ``devices`` holds the device of
    each coordinate in row-major order."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{math.prod(self.sizes)} coordinates")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> list[tuple[int, ...]]:
        """Every coordinate, in row-major order."""
        return list(itertools.product(*(range(s) for s in self.sizes)))

    def index(self, coord) -> int:
        """The row-major position of ``coord`` (its device's index)."""
        i = 0
        for c, s in zip(coord, self.sizes, strict=True):
            i = i * s + c
        return i

    def device(self, coord) -> torch.device:
        return self.devices[self.index(coord)]


def _build(shape, axes, devices) -> DeviceMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = math.prod(shape)
    return DeviceMesh(axes, shape,
                      tuple(devices[i % len(devices)] for i in range(n)))


def make_mesh(shape, axes=("data", "model"), devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices``, coordinate i (row-major) on
    device i mod their number.  ``devices=None`` takes the visible CUDA
    devices and raises without one (it never picks the CPU on its own):
    every coordinate on one card, or one per card on a node with as
    many."""
    if devices is None:
        default_device()  # raises without a CUDA device
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return _build(shape, axes, devices)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   devices=("cpu",)) -> DeviceMesh:
    """A small mesh for tests: every coordinate on the CPU unless
    ``devices`` says otherwise."""
    return _build(shape, axes, devices)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """The reference's production shapes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod``.  In the reference these are a TPU v5e pod's 256 or
    512 chips; here the same shapes are laid over whatever ``devices``
    are given (cycled, as :func:`make_mesh` does; ``"meta"`` is enough),
    so that the sharding rules and each coordinate's bytes
    (``sharding.params.per_device_bytes``) can be computed for them.  It
    does not stand for a machine of that many cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
