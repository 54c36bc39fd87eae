"""Device meshes for the sharded engine — the counterpart of
``repro.launch.mesh``.

A ``Mesh`` is a numpy object array of ``torch.device`` shaped by named axes,
as ``jax.sharding.Mesh`` is an array of jax devices. The sharded engine
(``core/distributed.py``) is single-controller, as the reference's
``shard_map`` is: one process drives every rank of the model axis. Positions
may share a device: ``make_test_mesh`` puts every position on the one
device it is given (the tests' CPU; one card), the way the reference's tests
put 8 virtual host devices in one process. ``make_production_mesh`` puts the
visible cards on the model axis.

Functions, not module-level constants, so importing touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` with its index filled in ("cuda" -> "cuda:<current>"), so
    that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on 'cuda' needs a CUDA device; this machine has none")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class Mesh:
    """Named axes over an array of devices.

    ``devices`` is an object array of ``torch.device`` whose shape is the
    axes' sizes; ``shape`` maps each axis to its size, as
    ``jax.sharding.Mesh.shape`` does.
    """

    devices: np.ndarray  # object [*sizes] of torch.device
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        ranks the sharded engine computes on (the other axes replicate, and
        their results are identical)."""
        a = self.axis_names.index(axis)
        index = tuple(slice(None) if i == a else 0 for i in range(len(self.axis_names)))
        return list(self.devices[index])


def _mesh(devices: List[torch.device], shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axes))


def make_test_mesh(
    shape: Tuple[int, ...] = (2, 4),
    axes: Tuple[str, ...] = ("data", "model"),
    device: DeviceLike = "cuda",
) -> Mesh:
    """Every position of a ``shape`` mesh on the one ``device``."""
    dev = canonical_device(device)
    return _mesh([dev] * int(np.prod(shape)), tuple(shape), axes)


def make_production_mesh() -> Mesh:
    """The visible cards on the model axis: a (1, n) ("data", "model") mesh.
    Raises without a card; it never builds a CPU mesh."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh needs CUDA devices; this machine has none")
    n = torch.cuda.device_count()
    return _mesh([torch.device("cuda", i) for i in range(n)], (1, n), ("data", "model"))
