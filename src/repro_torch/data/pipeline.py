"""Data pipeline: a deterministic synthetic LM stream and binary token
files, batches moved to the device, background prefetch, checkpointable
state.

Copied from ``src/repro/data/pipeline.py``.  ``SyntheticLM`` draws from
the same numpy Philox stream, so its batches equal the JAX package's bit
for bit.  ``device_batch`` moves a host batch to one device as tensors,
on a process mesh only this rank's rows.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.distributed import parallel as par


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLM:
    """Deterministic synthetic token stream: batch contents are a pure
    function of (seed, step) so restarts reproduce the exact stream."""

    def __init__(self, vocab: int, seq: int, global_batch: int, seed: int = 0):
        self.vocab, self.seq, self.gb, self.seed = vocab, seq, global_batch, seed

    def batch_at(self, step: int):
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        tok = rng.integers(0, self.vocab, size=(self.gb, self.seq + 1),
                           dtype=np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class TokenFile:
    """Flat binary token file (np.uint16/int32), sequence-packed reader."""

    def __init__(self, path: str, vocab: int, seq: int, global_batch: int,
                 dtype=np.uint16):
        self.arr = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.seq, self.gb = vocab, seq, global_batch
        self.tokens_per_batch = global_batch * (seq + 1)
        self.n_batches = len(self.arr) // self.tokens_per_batch

    def batch_at(self, step: int):
        i = step % max(self.n_batches, 1)
        flat = np.asarray(self.arr[i * self.tokens_per_batch:(i + 1) * self.tokens_per_batch])
        tok = flat.reshape(self.gb, self.seq + 1).astype(np.int32) % self.vocab
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def device_batch(batch, device, mesh=None, batch_axes=None):
    """Host numpy batch (or tensors) -> tensors on ``device`` (integer
    arrays as int64, the index type of the embedding and the loss).  With
    a process mesh (JAX ``:60-68``), this rank's block of rows: the
    leading dim cut over ``batch_axes`` as ``P(batch_axes)`` cuts it, the
    batch replicated over every other axis; only that block is copied to
    the device."""
    out = {}
    for k, v in batch.items():
        if mesh is not None:
            v = par.block(v, 0, mesh, par.entry_axes(batch_axes))
        t = (v.contiguous() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.ascontiguousarray(v)))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


class Prefetcher:
    """Background-thread double buffering with straggler accounting."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self.slow_fetches = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch_at(s)
            try:
                self.q.put((s, b), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def next(self, timeout: float = 60.0):
        t0 = time.monotonic()
        s, b = self.q.get(timeout=timeout)
        if time.monotonic() - t0 > 0.5:
            self.slow_fetches += 1  # input-bound step: straggler signal
        self.step = s + 1
        return s, b

    def close(self):
        self._stop.set()
