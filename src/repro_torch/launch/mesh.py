"""Device meshes for the population search: axis names over an explicit
list of ``torch.device``s.

Counterpart of ``make_mesh`` / ``make_pop_mesh`` / ``make_pop_model_mesh``
of ``src/repro/launch/mesh.py``.  The search runs in ONE process over
several devices, as the JAX package runs it single-controller over
``jax.devices()``; a mesh here is only the axis names and an object
array of devices that says which device holds which block of rows.  No
process group is involved.

The device list defaults to every visible CUDA device.  A list may name
one device several times (``["cpu"] * 4``, or ``["cuda:0"] * 3`` on a
one-card host): the shards then run side by side on that device, the
counterpart of the JAX tests' forced host device count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike, visible_devices


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and an object array of devices, one axis each."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _check_devices(needed: int, what: str, n_dev: int) -> None:
    """Fail loud before anything is placed when a mesh wants more
    devices than the list holds."""
    if needed > n_dev:
        raise ValueError(
            f"{what} requests {needed} device(s) but only {n_dev} are "
            f"visible: lower the shard count or pass a longer device list "
            f"(a device may be named more than once, e.g. ['cpu'] * N "
            f"for CPU testing)")


def make_mesh(shape, axes, devices: Optional[Sequence[DeviceLike]] = None
              ) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) devices (tests use
    small shapes like (2, 4))."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    devs = visible_devices(devices)
    needed = int(np.prod(shape))
    _check_devices(needed, f"a mesh of shape {shape}", len(devs))
    arr = np.empty(needed, dtype=object)
    arr[:] = devs[:needed]
    return Mesh(axes, arr.reshape(shape))


def make_pop_mesh(n_shards: Optional[int] = None,
                  devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D mesh ``("pop",)`` over the first ``n_shards`` devices (default:
    all of them); ``distributed.population`` places the population's
    row blocks on it."""
    devs = visible_devices(devices)
    n = n_shards or len(devs)
    _check_devices(n, f"REPRO_POP_SHARDS={n_shards}" if n_shards
                   else "make_pop_mesh()", len(devs))
    return make_mesh((n,), ("pop",), devs)


def make_pop_model_mesh(pop_shards: int, model_shards: int,
                        devices: Optional[Sequence[DeviceLike]] = None
                        ) -> Mesh:
    """2-D mesh ``("pop", "model")`` over pop_shards * model_shards
    devices: pop-shard i owns row i of the grid, and the wide bucket
    forwards split its rows over that row's devices."""
    devs = visible_devices(devices)
    _check_devices(pop_shards * model_shards,
                   f"REPRO_POP_SHARDS={pop_shards} x "
                   f"REPRO_MODEL_SHARDS={model_shards}", len(devs))
    return make_mesh((pop_shards, model_shards), ("pop", "model"), devs)
