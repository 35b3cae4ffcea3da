"""Training launcher: a real loop with checkpoint and restart, preemption
handling, deterministic data, straggler accounting and metrics logging.

Counterpart of ``src/repro/launch/train.py``, with the same flags plus
``--device``.  Checkpoints are the port's ``checkpoint/manager.py``
format, which the JAX package reads too.  Over several cards it runs one
process per card: ``--distributed`` joins the process group that
``python -m torch.distributed.run`` describes in the environment (NCCL
on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``), ``--mesh d,m`` (or
``p,d,m`` with a "pod" axis) lays the ranks out as the mesh
(``launch/mesh.py``), and the loop trains with the plan
``distributed/rules.py`` makes for it: parameters, optimizer state and
batches sharded, logging on rank 0.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 \\
        --global-batch 4 --seq 4096
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --distributed --mesh 2,2 \\
        --arch qwen3-0.6b --steps 10 --global-batch 4 --seq 4096
    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM, device_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel as par
from repro_torch.distributed.rules import make_plan
from repro_torch.launch.mesh import make_process_mesh, process_device
from repro_torch.models.zoo import get_model
from repro_torch.obs.log import get_logger, set_quiet
from repro_torch.training import optimizers as opt
from repro_torch.training.train_step import make_train_step
from repro_torch.utils.params import param_count, tree_leaves, tree_map

_log = get_logger("train")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
_ENCDEC = ("the encdec family trains on frame embeddings (enc_emb), which "
           "SyntheticLM's token batches lack, as in the JAX launcher; give "
           "TrainLoop batches= that hold them, or drive it through "
           "training.train_step.make_train_step")


class TrainLoop:
    """Reusable loop object (tests and ``chip_smoke.py`` drive it
    directly).  ``history`` holds {step, loss, ms} for every step run, on
    every rank.  With ``mesh`` (a process mesh), the loop trains with
    the plan for (cfg, seq, global_batch) on it, on the mesh's device,
    and its parameters and optimizer state are this rank's shards.
    ``batches``: step -> the global batch of that step (numpy arrays or
    tensors), in place of ``SyntheticLM``'s token batches from ``seed``;
    the encdec family needs it, for its frame embeddings."""

    def __init__(self, cfg, *, global_batch=8, seq=128, ckpt_dir=None,
                 mesh=None, seed=0, grad_compression=False, device="cuda",
                 batches=None):
        if cfg.family == "encdec" and batches is None:
            raise NotImplementedError(_ENCDEC)
        self.mesh = mesh
        self.plan = None if mesh is None else make_plan(
            cfg, mesh, ShapeCfg("custom", seq, global_batch, "train"))
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.cfg = cfg
        self.model = get_model(cfg, self.plan)
        self.step_fn, self.opt_init, self.ocfg = make_train_step(
            self.model, cfg, self.plan, grad_compression=grad_compression)
        self.data = SyntheticLM(cfg.vocab_size, seq, global_batch, seed=seed)
        self.batches = batches or self.data.batch_at
        self.ckpt_dir = ckpt_dir
        self.seq, self.gb = seq, global_batch
        self.history = []
        self._preempted = False

    @property
    def is_main(self) -> bool:
        """Rank 0, or the only process: the one that logs."""
        return self.mesh is None or self.mesh.rank == 0

    def init_state(self, seed=0):
        """The full parameters drawn from ``seed`` on this rank's device
        (a mesh run starts exactly where the one-card run starts), then
        cut to this rank's shards; the optimizer state for them."""
        params = self.model.init(torch.Generator(self.device).manual_seed(seed))
        if self.mesh is not None:
            params = self.model.load(par.shard_tree(
                params, self.model.param_specs(), self.mesh))
        return params, self.opt_init(params), 0

    def _tree(self, params, opt_state):
        """What a checkpoint holds: plain dicts of tensors."""
        return {"params": tree_map(lambda p: p, params), "opt": opt_state}

    def specs(self):
        """The checkpoint tree's PartitionSpecs (None without a mesh)."""
        if self.mesh is None:
            return None
        ps = self.model.param_specs()
        return {"params": ps, "opt": opt.state_specs(
            self.ocfg.name, self.ocfg, ps, self.model.param_defs())}

    def restore_or_init(self, seed=0):
        if self.ckpt_dir:
            last = ckpt.latest_step(self.ckpt_dir)
            if last is not None:
                params, opt_state, _ = self.init_state(seed)
                state = ckpt.restore(self.ckpt_dir, last,
                                     self._tree(params, opt_state),
                                     mesh=self.mesh, specs=self.specs())
                saved = dict(tree_leaves(state["params"]))
                with torch.no_grad():
                    for name, p in tree_leaves(params):
                        p.copy_(saved[name])
                return params, state["opt"], last
        return self.init_state(seed)

    def batch_at(self, step: int):
        """Batch ``step`` of the stream on this rank's device: its rows
        under a mesh."""
        return device_batch(self.batches(step), self.device, self.mesh,
                            self.plan.batch_axes if self.plan else None)

    def request_preempt(self, *_):
        self._preempted = True

    def _save(self, step, params, opt_state, extra):
        ckpt.save(self.ckpt_dir, step, self._tree(params, opt_state),
                  extra=extra, mesh=self.mesh, specs=self.specs())

    def run(self, steps: int, *, save_every: int = 0, log=_log.info):
        params, opt_state, start = self.restore_or_init()
        if not self.is_main:
            log = lambda _: None        # noqa: E731
        step_times = []
        for step in range(start, steps):
            t0 = time.monotonic()
            batch = self.batch_at(step)
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
                    help="'d,m' => (data=d, model=m) processes, 'p,d,m' "
                         "adds a pod axis; default with --distributed: "
                         "(world, 1)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group python -m "
                         "torch.distributed.run describes (NCCL on "
                         "cuda:LOCAL_RANK, gloo with --device cpu)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-step progress lines")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    set_quiet(args.quiet)
    joined = False
    if args.distributed:
        import torch.distributed as dist
        joined = not dist.is_initialized()
        init_distributed(args.device)
    try:
        mesh = None
        if args.mesh or args.distributed:
            import torch.distributed as dist
            shape = (tuple(int(x) for x in args.mesh.split(",")) if args.mesh
                     else (dist.get_world_size() if joined else 1, 1))
            if len(shape) not in (2, 3):
                raise ValueError(f"--mesh {args.mesh}: give d,m or p,d,m")
            axes = ("pod", "data", "model")[-len(shape):]
            mesh = make_process_mesh(shape, axes, args.device)

        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_config(cfg)
        loop = TrainLoop(cfg, global_batch=args.global_batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, mesh=mesh,
                         grad_compression=args.grad_compression,
                         device=args.device)
        signal.signal(signal.SIGTERM, loop.request_preempt)
        n = param_count(loop.model.param_defs())
        if loop.is_main:
            _log.info(f"arch={cfg.name} params={n / 1e6:.1f}M "
                      f"batch={args.global_batch}x{args.seq}"
                      + (f" mesh={dict(mesh.shape)}" if mesh else ""))
        loop.run(args.steps, save_every=args.save_every)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    return loop


def init_distributed(device="cuda"):
    """Join the process group ``python -m torch.distributed.run``
    describes in the environment: NCCL with this process on
    ``cuda:LOCAL_RANK``, gloo for ``device="cpu"``.  Raises
    ``RuntimeError`` without that environment, CUDA or the card: a
    multi-card run never drops to the CPU or to one process.  A process
    already in a group (one that set it up itself) stays in it."""
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the environment python -m "
            f"torch.distributed.run sets (missing {', '.join(missing)}): "
            f"python -m torch.distributed.run --nproc-per-node N -m "
            f"repro_torch.launch.train --distributed ...")
    import torch.distributed as dist
    dev = process_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group("nccl", device_id=dev)
        else:
            dist.init_process_group("gloo")
    return dev


if __name__ == "__main__":
    main()
