"""--arch string -> ModelConfig resolution.

Copied from ``src/repro/configs/registry.py``; every id has its config
and its model (``models/zoo.py``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeCfg,
                                      smoke_config, supports_shape)

ARCH_IDS = (
    "granite-3-8b",
    "llama3-405b",
    "qwen3-0.6b",
    "qwen2.5-14b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-30b-a3b",
    "chameleon-34b",
    "mamba2-780m",
    "zamba2-1.2b",
    "seamless-m4t-medium",
)

_MODULE = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
           for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULE[arch]).CONFIG


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape, supported, reason) for the 40 assigned cells."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = supports_shape(cfg, s)
            if ok or include_skipped:
                yield a, s.name, ok, why


__all__ = [
    "ARCH_IDS", "get_config", "get_shape", "all_cells", "smoke_config",
    "SHAPES",
]
