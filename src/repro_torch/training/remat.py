"""Consume an EGRL placement plan (``launch/optimize_placement.py``
output) as training-side knobs: the fraction of activations the plan
keeps in fast tiers maps onto the remat policy and layer blocking of the
arch config.

Copied from ``src/repro/training/remat.py``.  Activations resident in
fast tiers are cheap to save (less recompute); activations spilled to
HBM make recompute the right trade ("full" remat and sqrt-remat
blocking, ``scan_block``).
"""
from __future__ import annotations

import json
import math
from typing import Union

from repro_torch.configs.base import ModelConfig


def knobs_from_plan(plan: Union[str, dict]) -> dict:
    if isinstance(plan, str):
        with open(plan) as f:
            plan = json.load(f)
    frac = plan["derived"]["act_resident_frac"]
    remat = plan["derived"]["suggested_remat"]
    return {"remat": remat, "act_resident_frac": frac}


def apply_plan(cfg: ModelConfig, plan: Union[str, dict]) -> ModelConfig:
    """Return a config with the plan's remat policy (and sqrt-remat
    blocking when the plan spills most activations to HBM)."""
    k = knobs_from_plan(plan)
    kw = {"remat": k["remat"]}
    if k["remat"] == "full" and cfg.scan_block == 0:
        n = cfg.n_layers if cfg.moe is None else cfg.n_layers // cfg.moe.every
        for b in range(int(math.sqrt(n)), 1, -1):
            if n % b == 0:
                kw["scan_block"] = b
                break
    return cfg.replace(**kw)
