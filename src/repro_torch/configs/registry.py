"""--arch string -> ModelConfig resolution.

Copied from ``src/repro/configs/registry.py``.  The port carries the
configs of the three architectures it serves; the other ids raise
``NotImplementedError`` (ROADMAP.md lists them as still to port).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_config

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

PORTED = ("qwen3-0.6b", "mamba2-780m", "zamba2-1.2b")

_MODULE = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
           for a in PORTED}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    if arch not in _MODULE:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ported: {', '.join(PORTED)}); "
            f"see ROADMAP.md")
    return importlib.import_module(_MODULE[arch]).CONFIG


__all__ = ["ARCH_IDS", "PORTED", "get_config", "smoke_config"]
