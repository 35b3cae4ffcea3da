"""The port's dense-family training against the JAX package on the CPU:
``TransformerLM.loss`` and its gradients on the smoke configs of the four
dense ids, one whole train step (AdamW and Adafactor, one and two
microbatches, gradient compression off and on) from the same parameters
and batch, the remat settings against each other, and a ``TrainLoop``
preempted and restored against one that ran straight through.  JAX
parameters reach the port through ``convert.lm_params_from_jax``; the
smoke configs are f32."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.training.train_step import make_eval_step as jax_eval  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.launch.train import TrainLoop  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training.train_step import (make_eval_step,  # noqa: E402
                                             make_train_step)
from repro_torch.utils.params import tree_leaves  # noqa: E402

DENSE = ("qwen3-0.6b", "qwen2.5-14b", "granite-3-8b", "llama3-405b")


def models(arch, **kw):
    jcfg = jax_smoke(jax_config(arch)).replace(**kw)
    cfg = smoke_config(get_config(arch)).replace(**kw)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    m = get_model(cfg)
    m.load(convert.lm_params_from_jax(tree))
    return jm, jp, m


def batch(cfg, B=2, S=32, seed=1):
    return SyntheticLM(cfg.vocab_size, S, B, seed=seed).batch_at(0)


def flat_jax(tree):
    return {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    """qwen3 (qk-norm), qwen2.5 (qkv bias), granite and llama3 at smoke
    size: loss within 1e-6 and every parameter's gradient within 1e-5
    of its largest element (f32; sums in another order)."""
    jm, jp, m = models(arch)
    hb = batch(m.cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in hb.items()})
    leaves = tree_leaves(m.params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, met = m.loss(m.params, device_batch(hb, "cpu"))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    close(loss, jl, 1e-6, "loss")
    assert float(met["tokens"]) == float(jmet["tokens"])
    want = flat_jax(jg)
    assert set(want) == {name for name, _ in leaves}
    for (name, _), g in zip(leaves, grads):
        close(g, want[name], 1e-5, name)


@pytest.mark.parametrize("opt_name,micro,compress", [
    ("adamw", 1, False), ("adamw", 2, False), ("adamw", 1, True),
    ("adamw", 2, True), ("adafactor", 1, False), ("adafactor", 2, True)])
def test_train_step_matches_jax(opt_name, micro, compress):
    """One step of ``make_train_step`` on qwen3's smoke config from the
    same parameters and optimizer state, batch 4 x 32.  Loss within
    1e-6; the optimizer state within 1e-4 of each leaf's largest element.
    With compression, a gradient one f32 rounding apart may round to the
    next int8 quantum of its block (1/127 of the block's largest value),
    which moves m by up to 0.1 and v by up to 0.05 x 2 of that (relative
    to the leaf's largest): there every state element lies within 2/127
    of the leaf's largest, and at most 1 % of a leaf's elements beyond
    1e-4 of it.  Each parameter's movement p_after - p_before against
    JAX's, per element, within 1e-4 lr plus one f32 spacing of the
    parameter (the step rounds p once; a first step moves an element by
    about lr).  The only elements allowed beyond are those whose clipped
    JAX gradient is below 100 eps = 1e-6, where AdamW's first step
    lr g / (|g| + eps) turns with the gradient's last digits, and they
    are at most 0.1 % of a leaf."""
    jm, jp, m = models("qwen3-0.6b", grad_accum_microbatches=micro,
                       remat="full")
    jstep, jinit, jocfg = jax_step(jm, jm.cfg, None, opt_name,
                                   grad_compression=compress)
    step, init, ocfg = make_train_step(m, m.cfg, None, opt_name,
                                       grad_compression=compress)
    js = jinit(jp)
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js))
    hb = batch(m.cfg, B=4)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    before = flat_jax(jp)
    jgrad = flat_jax(jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(jp))
    jp2, js2, jmet = jax.jit(jstep)(jp, js, jb, jnp.int32(0))
    params, ts2, met = step(m.params, ts, device_batch(hb, "cpu"), 0)
    assert params is m.params and met["step"] == 1
    close(met["loss"], jmet["loss"], 1e-6, "loss")
    close(met["grad_norm"], jmet["grad_norm"], 1e-5, "grad_norm")
    lr = float(jmet["lr"])
    clip = min(1.0, 1.0 / max(float(jmet["grad_norm"]), 1e-9))
    want = flat_jax(jp2)
    for name, p in tree_leaves(params):
        moved = want[name].astype(np.float64) - before[name]
        got = p.detach().numpy().astype(np.float64) - before[name]
        beyond = np.abs(got - moved) > (
            1e-4 * lr + np.spacing(np.abs(want[name])))
        assert np.all(np.abs(jgrad[name][beyond]) * clip < 1e-6), name
        assert np.mean(beyond) <= 1e-3, (name, int(beyond.sum()))
    jstate = flat_jax({k: v for k, v in js2.items() if k != "step"})
    tstate = dict(tree_leaves({k: v for k, v in ts2.items()
                               if k != "step"}))
    assert set(jstate) == set(tstate)
    for name, v in jstate.items():
        if not compress:
            close(tstate[name], v, 1e-4, name)
            continue
        close(tstate[name], v, 2 / 127, name)
        d = np.abs(tstate[name].numpy() - v)
        assert np.mean(d > 1e-4 * np.abs(v).max()) <= 0.01, name
    assert int(ts2["step"]) == int(js2["step"]) == 1


def test_eval_step_matches_jax():
    """``make_eval_step``: loss, ce and token count of a masked batch
    within 1e-6, with no autograd graph."""
    jm, jp, m = models("granite-3-8b")
    hb = dict(batch(m.cfg))
    hb["mask"] = (np.arange(32)[None, :] % 3 != 0).repeat(2, 0).astype(
        np.float32)
    want = jax_eval(jm)(jp, {k: jnp.asarray(v) for k, v in hb.items()})
    got = make_eval_step(m)(m.params, device_batch(hb, "cpu"))
    assert not got["loss"].requires_grad
    assert float(got["tokens"]) == float(want["tokens"]) == 2 * 21
    for k in ("loss", "ce"):
        close(got[k], want[k], 1e-6, k)


def _loss_and_grads(remat, scan_block=0, arch="qwen3-0.6b"):
    torch.manual_seed(0)
    cfg = smoke_config(get_config(arch)).replace(
        n_layers=4, remat=remat, scan_block=scan_block)
    m = get_model(cfg)
    m.init(torch.Generator().manual_seed(3))
    leaves = tree_leaves(m.params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, _ = m.loss(m.params, device_batch(batch(cfg), "cpu"))
    return loss, torch.autograd.grad(loss, [p for _, p in leaves])


@pytest.mark.parametrize("remat,scan_block", [
    ("full", 0), ("dots", 0), ("none", 2), ("full", 2), ("dots", 2)])
def test_remat_settings_give_the_same_numbers(remat, scan_block):
    """Recomputation repeats the same CPU ops on the same values: loss
    and every gradient bit-equal to remat "none" without blocking, on 4
    layers (2 groups of 2 where blocked)."""
    want_loss, want = _loss_and_grads("none")
    loss, grads = _loss_and_grads(remat, scan_block)
    assert torch.equal(loss, want_loss)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="none, dots, full"):
        _loss_and_grads("everything")


def _loop(tmp, **kw):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    return TrainLoop(cfg, global_batch=4, seq=32, device="cpu",
                     ckpt_dir=tmp, **kw)


def test_preempted_and_restored_loop_equals_straight_run(tmp_path):
    """5 steps straight, against a run that a SIGTERM-style request stops
    after step 2 (saving its state), and a new loop restored from that
    checkpoint that finishes the 5: parameters, optimizer state and the
    losses of steps 3-5 equal (the same CPU ops on the same values)."""
    straight = _loop(None)
    p1, s1, n1 = straight.run(5, log=lambda _: None)
    first = _loop(str(tmp_path))

    def stop_at_2(line):
        if line.startswith("step 2 "):
            first.request_preempt()
    _, _, stopped = first.run(5, log=stop_at_2)
    assert stopped == 2 and [h["step"] for h in first.history] == [1, 2]
    second = _loop(str(tmp_path))
    p2, s2, n2 = second.run(5, log=lambda _: None)
    assert n1 == n2 == 5
    assert [h["step"] for h in second.history] == [3, 4, 5]
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in straight.history[2:]]
    for (name, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b), name


def test_train_main_smoke_on_cpu(tmp_path, capsys, monkeypatch):
    """The launcher on the CPU, one process: two steps and a checkpoint.
    ``--distributed`` outside ``torch.distributed.run``'s environment
    raises, as does a ``--mesh`` of 8 processes in a world of one."""
    from repro_torch.launch import train
    loop = train.main(["--arch", "granite-3-8b", "--smoke", "--steps", "2",
                       "--global-batch", "2", "--seq", "32", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path), "--save-every",
                       "2"])
    out = capsys.readouterr().out
    assert "arch=granite-3-8b" in out and "step 2 loss" in out
    assert len(loop.history) == 2
    assert all(np.isfinite(h["loss"]) for h in loop.history)
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
    for k in train._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    for flag, err, match in (
            (["--mesh", "2,4"], ValueError, "needs 8 process"),
            (["--distributed"], RuntimeError, "torch.distributed.run")):
        with pytest.raises(err, match=match):
            train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        *flag])


def test_train_main_moe_smoke_on_cpu(capsys):
    """The MoE family through the launcher: finite losses with the aux
    loss in them; the encdec family raises, as its batches need frame
    embeddings."""
    from repro_torch.launch import train
    loop = train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps",
                       "2", "--global-batch", "2", "--seq", "32",
                       "--device", "cpu"])
    assert "arch=qwen3-moe-30b-a3b" in capsys.readouterr().out
    assert len(loop.history) == 2
    assert all(np.isfinite(h["loss"]) for h in loop.history)
    with pytest.raises(NotImplementedError, match="enc_emb"):
        train.main(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                    "cpu"])


@pytest.mark.parametrize("arch,layers,block", [
    ("qwen3-moe-30b-a3b", 16, 8), ("llama4-maverick-400b-a17b", 8, 2),
    ("qwen3-0.6b", 6, 0)])
def test_step_launches_counts_the_two_level_remat(monkeypatch, arch, layers,
                                                  block):
    """``chip_smoke.step_launches``, the count the card's launch gates
    hold a training step to, against the attention forwards that one
    remat "full" forward and backward run, counted here: the two-level
    remat where the units fill groups of ``scan_block`` (qwen3-moe's 16
    layers in 2 groups of 8, as its deepest four-card cut runs; llama4's
    units of 2 layers in groups of 2), and one level without it.
    Exact."""
    from repro_torch.models import attention as att
    from repro_torch.training.train_step import _microbatch_grads
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    import chip_smoke
    calls = []
    plain = att.blocked_attention
    monkeypatch.setattr(att, "blocked_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = smoke_config(get_config(arch)).replace(
        n_layers=layers, scan_block=block, remat="full", dtype="float32",
        grad_accum_microbatches=1)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    _microbatch_grads(model.loss, params,
                      device_batch(batch(cfg, 2, 16, 0), "cpu"), 1,
                      torch.float32)
    want = chip_smoke.step_launches(cfg, False)
    assert len(calls) == want["flash_attention"]
    assert want["flash_attention_bwd"] == layers
