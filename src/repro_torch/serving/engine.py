"""Slot-based continuous-batching serving engine.

Copied from ``src/repro/serving/engine.py``.  A fixed budget of B slots
shares one batched cache.  Requests are prefilled one at a time (B = 1)
and their caches are written into their slot; every engine tick runs one
batched decode step for all slots; finished slots are refilled from the
queue.  Beside the JAX engine's stats it keeps the host-clock seconds of
each prefill and decode tick (each ends in a device-to-host copy of the
chosen tokens, so the device work is inside the interval).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.distributed import parallel as par


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)


class Engine:
    """Under a sharding plan every rank runs the same engine over its
    model-local parameters and cache blocks (``LMBase`` serving); the
    plan's batch axes must not cut the slots: a B = 1 prefill and its
    slot write cannot cut them over "data"."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, greedy: bool = True):
        plan = getattr(model, "plan", None)
        if plan is not None and par.live_axes(plan.mesh, plan.batch_axes):
            raise NotImplementedError(
                f"the engine under a plan whose batch axes "
                f"{plan.batch_axes} cut the slots: its B = 1 prefills and "
                f"slot writes cannot be cut over them (drive the model's "
                f"prefill / decode_step with each rank's rows instead)")
        self.model, self.params = model, params
        self.B, self.max_len = slots, max_len
        self.eos = eos_id
        self.greedy = greedy
        self.device = model.device
        self.cache = model.init_cache(slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)   # next position to write
        self.queue: deque = deque()
        self.done: List[Request] = []
        self._tick_tok = np.zeros(slots, np.int32)
        self.prefill_s: List[tuple] = []            # (prompt length, seconds)
        self.tick_s: List[float] = []

    # ------------------------------------------------------------- admin
    def submit(self, req: Request):
        req.submitted_at = time.monotonic()
        self.queue.append(req)

    def _write_slot_cache(self, slot: int, cache1):
        """Insert a B=1 prefilled cache into the batched cache at `slot`."""
        for name, small in cache1.items():
            self.cache[name][:, slot:slot + 1] = small

    @torch.no_grad()
    def _admit(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None, :]
            cache1, logits = self.model.prefill(self.params, tokens,
                                                self.max_len)
            self._write_slot_cache(slot, cache1)
            # torch.argmax, like jnp.argmax, takes the first maximum
            nxt = int(torch.argmax(logits[0, :self.model.cfg.vocab_size]))
            self.prefill_s.append((len(req.prompt), time.perf_counter() - t0))
            req.tokens.append(nxt)
            req.first_token_at = time.monotonic()
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self._tick_tok[slot] = nxt

    # -------------------------------------------------------------- tick
    @torch.no_grad()
    def tick(self) -> int:
        """One engine step: admit waiting requests, decode all live slots."""
        self._admit()
        live = [i for i in range(self.B) if self.slot_req[i] is not None]
        if not live:
            return 0
        # NOTE uniform-pos simplification: decode uses per-slot position via
        # max + per-slot masking would need per-slot pos; we decode at each
        # slot's own position by running the batched step with pos = the
        # per-slot positions' max and masking in attention through pos.
        # For the reduced CPU demo all admitted slots advance together.
        pos = int(self.slot_pos[live].max())
        t0 = time.perf_counter()
        tok = torch.as_tensor(self._tick_tok.astype(np.int64),
                              device=self.device)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tok, pos)
        nxt = torch.argmax(logits[:, :self.model.cfg.vocab_size],
                           dim=-1).cpu().numpy().astype(np.int32)
        self.tick_s.append(time.perf_counter() - t0)
        emitted = 0
        for i in live:
            req = self.slot_req[i]
            req.tokens.append(int(nxt[i]))
            self._tick_tok[i] = nxt[i]
            self.slot_pos[i] += 1
            emitted += 1
            finished = (len(req.tokens) >= req.max_new_tokens
                        or (self.eos is not None and nxt[i] == self.eos)
                        or self.slot_pos[i] >= self.max_len - 1)
            if finished:
                req.done_at = time.monotonic()
                self.done.append(req)
                self.slot_req[i] = None
        return emitted

    def run_until_drained(self, max_ticks: int = 10_000):
        t = 0
        while (self.queue or any(r is not None for r in self.slot_req)):
            if self.tick() == 0 and not self.queue:
                break
            t += 1
            if t >= max_ticks:
                break
        return self.done

    # ---------------------------------------------------------- metrics
    def stats(self):
        if not self.done:
            return {}
        ttft = [r.first_token_at - r.submitted_at for r in self.done]
        lat = [r.done_at - r.submitted_at for r in self.done]
        toks = sum(len(r.tokens) for r in self.done)
        wall = max(r.done_at for r in self.done) - min(r.submitted_at
                                                       for r in self.done)
        return {"requests": len(self.done), "tokens": toks,
                "ttft_ms_mean": 1e3 * float(np.mean(ttft)),
                "latency_ms_mean": 1e3 * float(np.mean(lat)),
                "tokens_per_s": toks / max(wall, 1e-9)}
