"""One rank of the port's sharded training on the CPU, for
``tests/test_torch_train_mesh.py``.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/_torch_mesh_worker.py INPUT_DIR OUTPUT_DIR

Joins the gloo process group torchrun describes, then runs every entry
of ``CASES`` in turn over the one world of 4 ranks, each on its own
process mesh: the full parameters come from ``INPUT_DIR/<arch>.npz``
(dotted leaf names, as the test wrote them), are cut with
``shard_tree``, and the case takes two steps: the first from
``make_grad_fn`` and the optimizer's update (its gradients recorded), the
second through ``make_train_step``.  Rank 0 writes what the test compares to
``OUTPUT_DIR/<case>.npz``: the losses, the gathered gradients, the
parameters after each step, the optimizer state after the second and
whether shard -> gather gave the parameters back bit for bit.
``RESTORES``: a ``TrainLoop`` saves at step 1 on one layout, and loops on
other layouts restore from it and run to step 3.  Last, the launcher's
``main`` trains over the same group (``LAUNCHER``, its log on
standard output).
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.distributed import parallel as par  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import TrainLoop, init_distributed  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training import optimizers as opt  # noqa: E402
from repro_torch.training.train_step import (make_grad_fn,  # noqa: E402
                                             make_train_step)
from repro_torch.utils.params import tree_from_flat, tree_leaves  # noqa: E402

AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
LAYOUTS = ((4, 1), (1, 4), (2, 2), (2, 1, 2))
BATCH_SEED = 1

# name -> (arch, layout, global batch, seq, config overrides, optimizer
# config overrides)
CASES = {}
for _shape in LAYOUTS:
    CASES[f"qwen3-{'x'.join(map(str, _shape))}"] = (
        "qwen3-0.6b", _shape, 4, 32, {}, {})
for _shape in ((4, 1), (2, 2)):
    CASES[f"granite-micro4-{'x'.join(map(str, _shape))}"] = (
        "granite-3-8b", _shape, 16, 32, {"grad_accum_microbatches": 4}, {})
for _shape in ((2, 2), (2, 1, 2)):
    # min_dim_factored 16: the smoke widths (64, 128, 256) factor
    CASES[f"llama3-adafactor-{'x'.join(map(str, _shape))}"] = (
        "llama3-405b", _shape, 4, 32, {}, {"min_dim_factored": 16})
CASES["mamba2-4x1"] = ("mamba2-780m", (4, 1), 4, 32, {}, {})
CASES["moe-4x1"] = ("qwen3-moe-30b-a3b", (4, 1), 4, 32, {}, {})

# a TrainLoop on SAVE_LAYOUT saves at step 1; loops on each of
# RESTORE_LAYOUTS restore it and run to step 3
RESTORE_ARCH, SAVE_LAYOUT, RESTORE_LAYOUTS = "qwen3-0.6b", (2, 2), (
    (4, 1), (1, 4))
RESTORE_B, RESTORE_S = 4, 32
# the launcher's run over the 4 ranks at (2, 2), the smoke config; rank
# 0 alone logs
LAUNCHER = {"arch": "qwen3-0.6b", "steps": 2, "global_batch": 4, "seq": 32}


def case_config(arch, overrides):
    return smoke_config(get_config(arch)).replace(**overrides)


def mesh_of(shape):
    return make_process_mesh(shape, AXES2 if len(shape) == 2 else AXES3,
                             "cpu")


def _np(tree, prefix):
    return {f"{prefix}/{n}": x.detach().numpy().copy()
            for n, x in tree_leaves(tree)}


def run_case(name, in_dir, out_dir):
    arch, shape, B, S, over, opt_over = CASES[name]
    cfg = case_config(arch, over)
    mesh = mesh_of(shape)
    plan = make_plan(cfg, mesh, ShapeCfg("test", S, B, "train"))
    model = get_model(cfg, plan)
    specs = model.param_specs()
    with np.load(os.path.join(in_dir, f"{arch}.npz")) as f:
        full = tree_from_flat(model.param_defs(),
                              {k: torch.tensor(f[k]) for k in f.files})
    local = par.shard_tree(full, specs, mesh)
    back = par.gather_tree(local, specs, mesh)
    roundtrip = all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(tree_leaves(full), tree_leaves(back)))
    params = model.load(local)
    ocfg = opt.OptConfig(name=cfg.optimizer, **opt_over)
    step_fn, opt_init, _ = make_train_step(model, cfg, plan, opt_cfg=ocfg)
    data = SyntheticLM(cfg.vocab_size, S, B, seed=BATCH_SEED)

    def batch(i):
        return device_batch(data.batch_at(i), "cpu", mesh, plan.batch_axes)

    # step 1 as the sharded step takes it, its gradients gathered before
    # the optimizer clips them in place; step 2 through make_train_step
    grads, loss = make_grad_fn(model, cfg, plan)(params, batch(0))
    out = {"roundtrip": np.array(roundtrip), "grad_loss": loss.numpy(),
           **_np(par.gather_tree(grads, specs, mesh), "grad")}
    state = opt_init(params)
    update = opt.make_optimizer(ocfg.name, ocfg, mesh, specs)[2]
    params, state, met = update(grads, state, params)
    met["loss"] = loss
    for i in range(2):
        if i:
            params, state, met = step_fn(params, state, batch(i), i)
        out[f"loss{i + 1}"] = met["loss"].numpy()
        out[f"grad_norm{i + 1}"] = met["grad_norm"].numpy()
        out.update(_np(par.gather_tree(params, specs, mesh), f"p{i + 1}"))
    ss = opt.state_specs(ocfg.name, ocfg, specs, model.param_defs())
    out.update(_np(par.gather_tree(state, ss, mesh), "opt"))
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)


def run_restores(out_dir):
    cfg = smoke_config(get_config(RESTORE_ARCH))
    ckpt_dir = os.path.join(out_dir, "ckpt")
    quiet = lambda _: None      # noqa: E731

    def loop(shape, **kw):
        return TrainLoop(cfg, global_batch=RESTORE_B, seq=RESTORE_S,
                         mesh=mesh_of(shape), **kw)
    loop(SAVE_LAYOUT, ckpt_dir=ckpt_dir).run(1, save_every=1, log=quiet)
    for shape in RESTORE_LAYOUTS:
        lp = loop(shape, ckpt_dir=ckpt_dir)
        params, _, _ = lp.run(3, log=quiet)
        full = par.gather_tree(params, lp.model.param_specs(), lp.mesh)
        if lp.mesh.rank == 0:
            np.savez(os.path.join(
                out_dir, f"restore-{'x'.join(map(str, shape))}.npz"),
                steps=np.array([h["step"] for h in lp.history]),
                losses=np.array([h["loss"] for h in lp.history]),
                **_np(full, "p"))


def main(argv):
    in_dir, out_dir = argv
    init_distributed("cpu")
    try:
        for name in CASES:
            run_case(name, in_dir, out_dir)
        run_restores(out_dir)
        dist.barrier()
        # the launcher itself, in the group this process already joined
        train.main(["--distributed", "--mesh", "2,2", "--smoke",
                    "--device", "cpu"] + [
            a for k, v in LAUNCHER.items()
            for a in (f"--{k.replace('_', '-')}", str(v))])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
