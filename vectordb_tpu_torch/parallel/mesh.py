"""Device meshes: a named grid of torch devices.

Port of ``vectordb_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over ``jax.devices()``; one process then places
rows on it and runs every shard's scan. The port keeps that contract with
a small ``Mesh`` of ``torch.device``s: ``devices`` is a numpy object
array shaped like the mesh (``devices.flat`` is the shard order),
``axis_names`` names its axes and ``shape`` maps each name to its size,
so ``mesh.shape[row_axis]`` reads as in JAX.

A mesh may repeat a device: ``make_mesh(8, devices=["cpu"] * 8)`` is the
counterpart of the JAX tests' 8-device virtual CPU mesh, and
``make_mesh(4, devices=["cuda:0"] * 4)`` runs four shards on one card.
Every shard layout, merge and certificate is the same as on distinct
cards; only the peer copies differ.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..distance import prepare_device


class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh's fields)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError("axis_names must match mesh shape rank")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis: the
        device of each position of that axis (a row shard's home)."""
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[pos]):
            index[pos] = i
            out.append(self.devices[tuple(index)])
        return out

    def cell_device(self, row_axis: str, s: int,
                    batch_axis: Optional[str] = None, b: int = 0):
        """The device of row shard ``s`` and batch block ``b`` (index 0
        of every other axis)."""
        index = [0] * self.devices.ndim
        index[self.axis_names.index(row_axis)] = s
        if batch_axis is not None:
            index[self.axis_names.index(batch_axis)] = b
        return self.devices[tuple(index)]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: a tensor's device always carries
    its index, and shards compare their tensors' devices to the mesh's."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("shard",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` devices of ``devices``.

    With one axis name the mesh is 1-D over all requested devices; pass
    ``shape`` for multi-axis meshes (e.g. shape=(4, 2),
    axis_names=("rows", "batch")). ``devices`` (the port's own) is the
    pool to draw from, default every visible CUDA device; it may repeat a
    device. A CUDA device without a card raises (``prepare_device``).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    pool = [_indexed(prepare_device(d)) for d in devices]
    if n_devices is not None:
        if n_devices > len(pool):
            raise ValueError(
                f"requested {n_devices} devices, only {len(pool)} present")
        pool = pool[:n_devices]
    if shape is None:
        shape = (len(pool),)
    if int(np.prod(shape)) != len(pool):
        raise ValueError(f"mesh shape {shape} != device count {len(pool)}")
    if len(shape) != len(axis_names):
        raise ValueError("axis_names must match mesh shape rank")
    grid = np.empty(len(pool), dtype=object)
    grid[:] = pool
    return Mesh(grid.reshape(shape), tuple(axis_names))


__all__ = ["Mesh", "make_mesh"]
