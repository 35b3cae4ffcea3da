"""Device meshes: axis names over an explicit list of ``torch.device``s
(the population search), or over the ranks of a process group (training
over several cards).

Counterpart of ``src/repro/launch/mesh.py``.  The search runs in ONE
process over several devices, as the JAX package runs it
single-controller over ``jax.devices()``: ``make_mesh`` /
``make_pop_mesh`` / ``make_pop_model_mesh`` give the axis names and an
object array of devices that says which device holds which block of
rows, with no process group.  Training runs one process per card
(``torch.distributed``): ``make_process_mesh`` and
``make_production_mesh`` (JAX ``:9``) lay the ranks of the initialised
process group out row-major over the axes, as ``jax.make_mesh`` lays out
devices, and give each rank one subgroup per axis of size > 1 (the
ranks that differ from it on that axis alone) and its device.

The device list defaults to every visible CUDA device.  A list may name
one device several times (``["cpu"] * 4``, or ``["cuda:0"] * 3`` on a
one-card host): the shards then run side by side on that device, the
counterpart of the JAX tests' forced host device count.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, visible_devices


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


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(Mesh):
    """A mesh over the ranks of a process group: ``devices`` holds rank
    numbers, row-major; ``rank`` is this process, ``device`` its card (or
    the CPU), ``groups`` the process group of this rank's line along each
    axis of size > 1 (an axis of size 1 has none: nothing crosses it)."""
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        where = np.argwhere(self.devices == self.rank)[0]
        return dict(zip(self.axis_names, (int(c) for c in where)))


def process_device(device: DeviceLike = "cuda") -> torch.device:
    """The device of this process: the CPU for ``"cpu"``, the meta
    device for ``"meta"`` (the dry run), else card ``LOCAL_RANK`` (0
    without it); raises when CUDA or that card is missing."""
    if torch.device(device).type in ("cpu", "meta"):
        return torch.device(torch.device(device).type)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} but only {torch.cuda.device_count()} "
            f"CUDA device(s) are visible")
    return torch.device("cuda", local)


def make_process_mesh(shape, axes, device: DeviceLike = "cuda"
                      ) -> ProcessMesh:
    """A mesh of ``shape`` over the initialised process group (a world of
    one process without one).  Raises before anything is placed when the
    world size is not prod(shape).  Every rank must call it, in the same
    order as the others: it creates the per-axis subgroups."""
    import torch.distributed as dist
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    needed = math.prod(shape)
    if needed != world:
        raise ValueError(
            f"a process mesh of shape {shape} needs {needed} process(es) "
            f"but the world has {world}: launch one process per card with "
            f"python -m torch.distributed.run --nproc-per-node {needed} "
            f"... --distributed")
    return _ranks_mesh(shape, axes, device)


def make_process_submesh(shape, axes, device: DeviceLike = "cuda"
                         ) -> Optional[ProcessMesh]:
    """A mesh of ``shape`` over ranks 0 .. prod(shape) - 1 of a world at
    least that large (a layout of fewer cards beside the world's); None
    on the ranks outside it, which must not enter its collectives.
    Every rank must call it, in the same order: it creates the
    subgroups."""
    import torch.distributed as dist
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) > world:
        raise ValueError(f"a process mesh of shape {shape} needs "
                         f"{math.prod(shape)} processes; the world has "
                         f"{world}")
    return _ranks_mesh(shape, axes, device)


def _ranks_mesh(shape, axes, device):
    """The mesh of ``shape`` over ranks 0 .. prod(shape) - 1, row-major,
    and this rank's subgroup along each axis of size > 1 (None for a
    rank outside it)."""
    import torch.distributed as dist
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    live = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if live else 0
    ranks = np.arange(math.prod(shape)).reshape(shape)
    groups = {}
    for i, ax in enumerate(axes):
        if shape[i] == 1:
            continue
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[ax] = g
    if rank >= ranks.size:
        return None
    return ProcessMesh(axes, ranks, rank=rank, device=process_device(device),
                       groups=groups)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> ProcessMesh:
    """The (16, 16) ("data", "model") process mesh, or (2, 16, 16) with
    "pod": 256 or 512 processes, one a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_process_mesh(shape, axes, device)
