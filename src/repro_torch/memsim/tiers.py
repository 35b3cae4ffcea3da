"""The TPU-adapted memory hierarchy standing in for NNP-I's DRAM/LLC/SRAM.

DESIGN.md §2: HBM <- DRAM, CMEM <- LLC, VMEM <- SRAM. Bandwidth figures are
v5e HBM (819 GB/s) plus v4-style CMEM and VMEM-register-file numbers; what
the placement problem cares about is the capacity/bandwidth *trade-off*
shape, which matches the paper's setting (small+fast vs large+slow).

Copy of ``src/repro/memsim/tiers.py``: the port keeps the reference's
tier table so that rewards compare across the two packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str
    capacity: float        # bytes
    bandwidth: float       # bytes / s


HBM = Tier("HBM", 16 * 2 ** 30, 819e9)
CMEM = Tier("CMEM", 128 * 2 ** 20, 2.8e12)
VMEM = Tier("VMEM", 48 * 2 ** 20, 22e12)

TIERS = (HBM, CMEM, VMEM)
N_TIERS = 3
HBM_IDX, CMEM_IDX, VMEM_IDX = 0, 1, 2

CAPACITIES = np.array([t.capacity for t in TIERS])
BANDWIDTHS = np.array([t.bandwidth for t in TIERS])

# compute model: v5e MXU peak with op-dependent utilization
PEAK_FLOPS = 197e12
OP_UTILIZATION_DEFAULT = 0.6
FIXED_OVERHEAD_S = 2e-6  # per-op launch overhead
