"""What one step costs on each rank: FLOPs, HBM bytes, the most bytes
its intermediates hold at once, and its collectives.

Counterpart of ``src/repro/distributed/hlo_cost.py`` ``analyze_cost``
and ``src/repro/distributed/hlo_analysis.py`` ``collective_summary``.
JAX reads both from a compiled program's HLO text.  Torch has no HLO,
so the port counts the step as it runs (``launch/dryrun.py`` runs it on
meta tensors over a fake process group): ``count_step`` is one context
manager around the call.

- **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode``: 2 M
  N K a product, as ``hlo_cost`` counts each ``dot``.  Every recompute
  and every microbatch runs, so each counts, as JAX's trip-aware count
  multiplies loop bodies by their trips.  A kernel wrapper on meta
  tensors runs its plain version (``meta_op``), whose products count:
  the counterpart of JAX's dry run on XLA:CPU, which counts the
  reference paths (``blocked_attention``, ``ssd_chunked``), not Pallas.
- **HBM bytes** are the bytes of every dispatched op's tensor inputs
  and outputs; a view moves none, and a kernel wrapper counts as one op
  (its inputs read once, its outputs written once), as a fused kernel
  does.
- **Peak temporary bytes** are the most bytes held at once by the
  storages the step made: each counted once however many views share
  it, from the op that made it until it dies (a weakref finalizer on
  the storage).  Inside a kernel wrapper only its outputs count.
- **Collectives** are the ``torch.distributed`` calls the step issues,
  each with its kind, group size and output bytes, and the bytes a
  device sends by JAX's ring formulas (``_per_device_bytes``).  The
  all-gathers, the reduce-scatters and the largest gather are also
  given apart, as ``chip_smoke.step_collectives`` counts FSDP's.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_STATE = threading.local()


def _active():
    """The ``StepCount`` being counted in this thread, or None."""
    return getattr(_STATE, "count", None)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


# copied from src/repro/distributed/hlo_analysis.py ``_per_device_bytes``:
# the ring algorithm's bytes a device sends, from the op's output bytes
def _per_device_bytes(kind: str, out_bytes: int, n: int) -> float:
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) / n
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    return float(out_bytes)  # collective-permute


def _returns(func) -> str:
    """"fresh" when the op's outputs are new tensors, "write" when one
    is an input written in place (``add_``, ``out=``), "view" when they
    alias an input unwritten."""
    alias = [r.alias_info for r in func._schema.returns]
    if not any(alias):
        return "fresh"
    return "write" if any(a is not None and a.is_write for a in alias) \
        else "view"


class _Mode(TorchDispatchMode):
    """Adds each op's bytes and tracks the storages it makes."""

    def __init__(self, count: "StepCount"):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.count
        if c.depth == 0:
            kind = _returns(func)
            if kind != "view":
                c.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
                c.n_ops += 1
            if kind == "fresh":
                c.track(out)
        return out


# torch.distributed calls counted, and the kind each is; each takes first
# the tensor (or list) whose bytes JAX's formulas read: the reduced or
# sent tensor, the gathered output, the scattered shard
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _coll_bytes(args, kwargs) -> int:
    return _nbytes(args[0] if args else next(iter(kwargs.values())))


class StepCount:
    """What ``count_step`` counted: read ``summary()`` after the block."""

    def __init__(self):
        self.hbm_bytes = 0
        self.n_ops = 0
        self.kernel_ops: Dict[str, int] = defaultdict(int)
        self.depth = 0            # > 0 inside a kernel wrapper's op
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self.collectives: List[dict] = []
        self._coll_depth = 0
        self.flops = 0

    # ------------------------------------------------------- storages
    def track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    # ----------------------------------------------------- collectives
    def _wrap(self, name, fn):
        kind = _COLLECTIVES[name]

        def counted(*args, **kwargs):
            outer = self._coll_depth == 0
            self._coll_depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._coll_depth -= 1
                if outer:
                    group = kwargs.get("group")
                    n = torch.distributed.get_world_size(group)
                    nb = _coll_bytes(args, kwargs)
                    self.collectives.append({
                        "kind": kind, "group": n, "bytes": nb,
                        "per_device_bytes": _per_device_bytes(kind, nb, n)})
        return counted

    def collective_summary(self) -> dict:
        """``hlo_analysis.collective_summary``'s keys, and the
        all-gathers, reduce-scatters and largest gather (bytes)."""
        by_kind = defaultdict(lambda: {"count": 0, "per_device_bytes": 0.0})
        for c in self.collectives:
            by_kind[c["kind"]]["count"] += 1
            by_kind[c["kind"]]["per_device_bytes"] += c["per_device_bytes"]
        gathers = [c["bytes"] for c in self.collectives
                   if c["kind"] == "all-gather"]
        return {"total_per_device_bytes": sum(
                    c["per_device_bytes"] for c in self.collectives),
                "by_kind": dict(by_kind), "n_ops": len(self.collectives),
                "all_gather": len(gathers),
                "reduce_scatter": sum(c["kind"] == "reduce-scatter"
                                      for c in self.collectives),
                "all_gather_max_bytes": max(gathers, default=0)}

    def summary(self) -> dict:
        return {"flops": float(self.flops), "hbm_bytes": float(self.hbm_bytes),
                "peak_temp_bytes": int(self.peak), "n_ops": self.n_ops,
                "kernel_ops": dict(self.kernel_ops),
                "collectives": self.collective_summary()}


@contextlib.contextmanager
def count_step():
    """Count what runs inside the block on this thread: yields a
    ``StepCount`` whose ``summary()`` holds the FLOPs, HBM bytes, peak
    temporary bytes and collectives once the block ends.  Blocks do not
    nest."""
    from torch.utils.flop_counter import FlopCounterMode
    import torch.distributed as dist
    if _active() is not None:
        raise RuntimeError("count_step blocks do not nest")
    c = StepCount()
    saved = {n: getattr(dist, n) for n in _COLLECTIVES if hasattr(dist, n)}
    _STATE.count = c
    try:
        for n, fn in saved.items():
            setattr(dist, n, c._wrap(n, fn))
        with FlopCounterMode(display=False) as flops, _Mode(c):
            yield c
        c.flops = flops.get_total_flops()
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
        _STATE.count = None


def meta_op(name: str, fn, *inputs):
    """``fn()`` as ONE op of a kernel wrapper on meta tensors: its
    products count as FLOPs, and its bytes are ``inputs`` read once and
    its outputs written once (the ops ``fn`` runs add none).  Outside
    ``count_step`` it is ``fn()``."""
    c = _active()
    if c is None:
        return fn()
    c.depth += 1
    try:
        out = fn()
    finally:
        c.depth -= 1
    if c.depth == 0:
        c.hbm_bytes += _nbytes(inputs) + _nbytes(out)
        c.n_ops += 1
        c.kernel_ops[name] += 1
        c.track(out)
    return out
