"""EA population sharding policy: pick a shard count, build the
``("pop",)`` mesh, pad the populations to divisible row counts, and
place the stacked (P, ...) genome tensors as row blocks, one per shard
device.

Counterpart of ``src/repro/distributed/population.py``, with the same
policy table, padding and errors.  The JAX package places a population
as one array with a ``NamedSharding``; here a sharded population is a
``RowShards``: its contiguous row blocks, one tensor per shard on that
shard's device, in row order.  ``EGRL`` and ``ZooEGRL`` run the population
forward and the simulator per block on its device, and the sharded EA
step (``core.ea.evolve_sharded``) builds each shard's rows where they
live, so the real-row trajectory equals the single-device run.

Padded slots: a shard count that does not divide a sub-population pads
it up to the next multiple of the shard count (of pop * model on a 2-D
mesh).  They allocate the extra rows, give them ``-inf``
fitness and size every random draw by the REAL counts, so the real rows
do not depend on the shard count.

Shard-count policy (``REPRO_POP_SHARDS``, or the ``pop_shards``
argument of ``EGRL`` / ``ZooEGRL``):

- ``"auto"`` (default): every device of the list, capped at the larger
  sub-population.  On a one-card host this is 1: the single-device path.
- ``"1"`` / ``"0"`` / ``"off"``: the single-device path.
- an integer > 1: exactly that many shards, padding as needed; raises
  ``ValueError`` when it exceeds the device count.

``REPRO_MODEL_SHARDS`` (or ``model_shards``) adds the "model" axis of a
2-D ``("pop", "model")`` mesh.  Pop-shard i lives on row i of the grid
(its first device); what the extra axis buys is the wide layout
(``put_wide``): the big buckets' population forwards split each pop
block's rows over the devices of its row, a pure row split.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, visible_devices
from repro_torch.launch.mesh import Mesh, make_pop_mesh, make_pop_model_mesh
from repro_torch.utils.envpolicy import env_policy


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class RowShards:
    """A stacked (rows, ...) tensor held as contiguous row blocks, one
    tensor per shard, each on its own device (blocks may be empty)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)
        self.offsets = [0]
        for p in self.parts:
            self.offsets.append(self.offsets[-1] + p.shape[0])

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.rows,) + tuple(self.parts[0].shape[1:])

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    def block(self, i: int) -> torch.Tensor:
        return self.parts[i]

    def cat(self, device: DeviceLike) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.cat([p.to(device) for p in self.parts])

    def write(self, start: int, rows: torch.Tensor) -> None:
        """Overwrite rows [start, start + len(rows)) in the blocks that
        own them (each piece copied to its block's device)."""
        stop = start + rows.shape[0]
        for p, lo, hi in zip(self.parts, self.offsets, self.offsets[1:]):
            a, b = max(lo, start), min(hi, stop)
            if a < b:
                p[a - lo:b - lo] = rows[a - start:b - start].to(p.device)


@dataclasses.dataclass(frozen=True)
class PopSharding:
    """Resolved placement for the stacked population tensors."""
    mesh: Optional[Mesh]    # None => single-device path
    n_shards: int
    # padded global row counts (None => no padding, rows == real sizes)
    n_g_pad: Optional[int] = None
    n_b_pad: Optional[int] = None
    model_shards: int = 1

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def devices(self) -> List[torch.device]:
        """Pop-shard i's device: the first device of the grid's row i."""
        assert self.mesh is not None
        grid = self.mesh.devices.reshape(self.n_shards, -1)
        return [grid[i, 0] for i in range(self.n_shards)]

    @property
    def wide_devices(self) -> List[List[torch.device]]:
        """Per pop shard, the devices its rows split over in the wide
        layout (its grid row; itself alone on a 1-D mesh)."""
        assert self.mesh is not None
        grid = self.mesh.devices.reshape(self.n_shards, -1)
        return [list(grid[i]) for i in range(self.n_shards)]

    def put(self, x) -> Union[torch.Tensor, RowShards]:
        """Split a stacked (P, ...) tensor into the pop shards' row
        blocks, each a fresh tensor on its device (no-op unsharded)."""
        if not self.active:
            return x
        if isinstance(x, RowShards):
            if (x.devices == self.devices and len({p.shape[0] for p in
                                                   x.parts}) == 1):
                return x
            x = x.cat(self.devices[0])
        return RowShards(_split(x, self.devices))

    def put_wide(self, x: RowShards) -> List[RowShards]:
        """Per pop shard, its block split over the devices of its grid
        row (``wide_devices``): the wide layout of the big buckets'
        forwards."""
        return [RowShards(_split(p, devs))
                for p, devs in zip(x.parts, self.wide_devices)]

    def padded(self, n_g: int, n_b: int) -> Tuple[int, int]:
        """Row counts the population tensors must be allocated with."""
        return (self.n_g_pad if self.n_g_pad is not None else n_g,
                self.n_b_pad if self.n_b_pad is not None else n_b)


def _split(x: torch.Tensor, devices: Sequence[torch.device]
           ) -> List[torch.Tensor]:
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} devices")
    c = x.shape[0] // n
    return [x[i * c:(i + 1) * c].to(d, copy=True).contiguous()
            for i, d in enumerate(devices)]


def resolve_pop_sharding(n_g: int, n_b: int,
                         requested: Union[int, str, None] = None,
                         model_shards: Union[int, str, None] = None,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> PopSharding:
    """Resolve the shard count for an (n_g, n_b) population split over
    ``devices`` (default: every visible CUDA device).

    ``requested`` overrides ``REPRO_POP_SHARDS`` and ``model_shards``
    ``REPRO_MODEL_SHARDS``; see the module docstring for the accepted
    values.  Unknown values fail loud through ``utils.envpolicy``."""
    req = env_policy("REPRO_POP_SHARDS",
                     choices=("auto", "", "off", "0", "1"),
                     default="auto", override=requested, int_ok=True)
    m_req = env_policy("REPRO_MODEL_SHARDS",
                       choices=("auto", "", "off", "0", "1"),
                       default="off", override=model_shards, int_ok=True)
    if n_g + n_b == 0:                      # pure-PG mode: nothing to shard
        return PopSharding(None, 1)
    devs = visible_devices(devices)
    n_dev = len(devs)
    if m_req in ("auto", ""):
        m = 0                               # resolved after the pop axis
    elif m_req in ("off", "0", "1"):
        m = 1
    else:
        m = m_req                           # an integer >= 1
    if req in ("auto", ""):
        n = max(min(n_dev // max(m, 1), max(n_g, n_b, 1)), 1)
    elif req in ("off", "0", "1"):
        n = 1
    else:
        n = req                             # an integer >= 1
        if n > n_dev:
            raise ValueError(
                f"REPRO_POP_SHARDS={n} but only {n_dev} device(s) visible")
    if m == 0:                              # model auto: leftover devices
        m = max(n_dev // max(n, 1), 1)
        m = 1 if n <= 1 else m              # no pop mesh -> no model mesh
    if n * m > n_dev:
        raise ValueError(
            f"REPRO_POP_SHARDS={n} x REPRO_MODEL_SHARDS={m} needs "
            f"{n * m} device(s) but only {n_dev} visible")
    if n <= 1:
        return PopSharding(None, 1)
    # wide row splits divide rows by n*m, the EA step's by n: rounding to
    # n*m satisfies both
    mesh = (make_pop_model_mesh(n, m, devs) if m > 1
            else make_pop_mesh(n, devs))
    return PopSharding(mesh, n,
                       _round_up(n_g, n * m) if n_g else 0,
                       _round_up(n_b, n * m) if n_b else 0,
                       model_shards=m)
