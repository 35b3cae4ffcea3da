"""Training launcher: a real loop with checkpoint and restart, preemption
handling, deterministic data, straggler accounting and metrics logging.

Counterpart of ``src/repro/launch/train.py``, with the same flags plus
``--device``; ``--mesh`` and ``--distributed`` raise until the
multi-GPU port (ROADMAP.md item 8).  Checkpoints are the port's
``checkpoint/manager.py`` format, which the JAX package reads too.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 \\
        --global-batch 4 --seq 4096
    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM, device_batch
from repro_torch.device import resolve_device
from repro_torch.models.zoo import get_model
from repro_torch.obs.log import get_logger, set_quiet
from repro_torch.training.train_step import make_train_step
from repro_torch.utils.params import param_count, tree_leaves, tree_map

_log = get_logger("train")
_MULTI_GPU = "needs the multi-GPU port (ROADMAP.md item 8)"
_ENCDEC = ("the encdec family trains on frame embeddings (enc_emb), which "
           "SyntheticLM's token batches lack, as in the JAX launcher; drive "
           "it through training.train_step.make_train_step")


class TrainLoop:
    """Reusable loop object (tests and ``chip_smoke.py`` drive it
    directly).  ``history`` holds {step, loss, ms} for every step run."""

    def __init__(self, cfg, *, global_batch=8, seq=128, ckpt_dir=None,
                 mesh=None, seed=0, grad_compression=False, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(f"a device mesh {_MULTI_GPU}")
        if cfg.family == "encdec":
            raise NotImplementedError(_ENCDEC)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = get_model(cfg)
        self.step_fn, self.opt_init, _ = make_train_step(
            self.model, cfg, grad_compression=grad_compression)
        self.data = SyntheticLM(cfg.vocab_size, seq, global_batch, seed=seed)
        self.ckpt_dir = ckpt_dir
        self.seq, self.gb = seq, global_batch
        self.history = []
        self._preempted = False

    def init_state(self, seed=0):
        params = self.model.init(torch.Generator(self.device).manual_seed(seed))
        return params, self.opt_init(params), 0

    def _tree(self, params, opt_state):
        """What a checkpoint holds: plain dicts of tensors."""
        return {"params": tree_map(lambda p: p, params), "opt": opt_state}

    def restore_or_init(self, seed=0):
        if self.ckpt_dir:
            last = ckpt.latest_step(self.ckpt_dir)
            if last is not None:
                params, opt_state, _ = self.init_state(seed)
                state = ckpt.restore(self.ckpt_dir, last,
                                     self._tree(params, opt_state))
                saved = dict(tree_leaves(state["params"]))
                with torch.no_grad():
                    for name, p in tree_leaves(params):
                        p.copy_(saved[name])
                return params, state["opt"], last
        return self.init_state(seed)

    def request_preempt(self, *_):
        self._preempted = True

    def _save(self, step, params, opt_state, extra):
        ckpt.save(self.ckpt_dir, step, self._tree(params, opt_state),
                  extra=extra)

    def run(self, steps: int, *, save_every: int = 0, log=_log.info):
        params, opt_state, start = self.restore_or_init()
        step_times = []
        for step in range(start, steps):
            t0 = time.monotonic()
            batch = device_batch(self.data.batch_at(step), self.device)
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch, step)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.monotonic() - t0
            step_times.append(dt)
            self.history.append({"step": step + 1, "loss": loss,
                                 "ms": dt * 1e3})
            med = float(np.median(step_times[-20:]))
            straggler = dt > 3 * med and len(step_times) > 5
            log(f"step {step + 1} loss {loss:.4f} {dt * 1e3:.0f}ms"
                + (" [straggler]" if straggler else ""))
            if self.ckpt_dir and save_every and (step + 1) % save_every == 0:
                self._save(step + 1, params, opt_state,
                           {"data_step": step + 1})
            if self._preempted:
                if self.ckpt_dir:
                    self._save(step + 1, params, opt_state,
                               {"preempted": True})
                log(f"preempted at step {step + 1}; state saved")
                return params, opt_state, step + 1
        return params, opt_state, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help=f"a (data, model) device mesh; {_MULTI_GPU}")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help=f"multi-host initialisation; {_MULTI_GPU}")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-step progress lines")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    set_quiet(args.quiet)
    if args.distributed:
        raise NotImplementedError(f"--distributed {_MULTI_GPU}")
    if args.mesh:
        raise NotImplementedError(f"--mesh {_MULTI_GPU}")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    loop = TrainLoop(cfg, global_batch=args.global_batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir,
                     grad_compression=args.grad_compression,
                     device=args.device)
    signal.signal(signal.SIGTERM, loop.request_preempt)
    n = param_count(loop.model.param_defs())
    _log.info(f"arch={cfg.name} params={n / 1e6:.1f}M "
              f"batch={args.global_batch}x{args.seq}")
    loop.run(args.steps, save_every=args.save_every)
    return loop


if __name__ == "__main__":
    main()
