"""Device resolution, the device lists of a search over several devices,
and the kernels' launch counters.

There is no silent fallback: a request for CUDA on a machine without it
raises, and only an explicit ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  ``"meta"`` is accepted where a caller names it
(the dry run, ``launch/dryrun.py``: shapes only, no data); it is never a
default.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]

_COUNT_LOCK = threading.Lock()


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when CUDA
    is asked for and not available.  ``"meta"`` only when named."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def normalize_device(device: DeviceLike) -> torch.device:
    """``torch.device`` with an explicit index for CUDA ("cuda" is the
    current card), so two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(devices: Optional[Sequence[DeviceLike]] = None
                    ) -> List[torch.device]:
    """``devices`` normalized, or by default every visible CUDA device
    (the CPU alone on a host without one)."""
    if devices is None:
        if torch.cuda.is_available():
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]
    return [normalize_device(d) for d in devices]


def same_type_devices(devices: Optional[Sequence[DeviceLike]],
                      primary: DeviceLike) -> List[torch.device]:
    """``devices`` normalized, by default every visible CUDA device for a
    search on a card and the CPU alone for one on the CPU; raises when
    one is not of ``primary``'s type: a CUDA search never moves a shard
    or a bucket to the CPU, nor a CPU one to a card."""
    dev = normalize_device(primary)
    if devices is None:
        devs = [dev] if dev.type == "cpu" else visible_devices()
    else:
        devs = visible_devices(devices)
    bad = [d for d in devs if d.type != dev.type]
    if bad:
        raise ValueError(f"devices {bad} are not of the search's device type "
                         f"({dev.type})")
    return devs


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to wrapper ``fn``'s launch counter ``attr``, under a lock:
    the placement service launches kernels from several threads, and
    ``+=`` on an attribute is not atomic across them."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _counters():
    """name -> (wrapper, attribute holding its count)."""
    # imported here: the kernel modules import this one
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gat_mp import ops as gat_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.memsim import batch, simulator
    flash = flash_ops.flash_attention
    return {"gat_mp": (gat_ops.gat_mp, "launches"),
            "gat_mp_bwd": (gat_ops.gat_mp_bwd, "launches"),
            "memsim": (simulator.evaluate_population, "launches"),
            "memsim_zoo": (batch.evaluate_population_zoo, "launches"),
            "flash_attention": (flash, "launches"),
            "flash_attention_tc": (flash, "tensor_core_launches"),
            "flash_attention_bwd": (flash_ops.flash_attention_bwd,
                                    "launches"),
            "flash_attention_bwd_tc": (flash_ops.flash_attention_bwd,
                                       "tensor_core_launches"),
            "ssd_scan": (ssd_ops.ssd_scan, "launches"),
            "ssd_scan_bwd": (ssd_ops.ssd_scan_bwd, "launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset.  A wrapper adds
    one where it launches its CUDA kernel and nowhere else, so a run on
    CPU tensors leaves every count at 0.  "flash_attention" counts both
    attention kernels, "flash_attention_tc" those of the tensor-core
    kernel among them, "flash_attention_bwd" the attention backward (the
    CUDA kernels of one call count as one), "flash_attention_bwd_tc"
    those on its tensor-core route; "ssd_scan" the SSD scan's forward,
    "ssd_scan_bwd" its backward (each call's CUDA kernels count as one);
    "memsim" the single-graph simulator entry, "memsim_zoo" its zoo entry
    (one launch per bucket)."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for fn, attr in _counters().values():
            setattr(fn, attr, 0)
