"""The port's SSM-family training against the JAX package on the CPU:
``Mamba2LM.loss`` and ``Zamba2LM.loss`` and every parameter's gradient
against ``jax.value_and_grad`` of the JAX ``loss`` from the same
parameters and batch, remat "none" against "full", and the training
launcher on the smoke configs.  JAX parameters reach the port through
``convert.lm_params_from_jax``; the smoke configs are f32 (d_model 64,
8 heads of 16, d_state 16, chunk 16)."""
import dataclasses

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
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.utils.params import tree_leaves  # noqa: E402

# zamba2 with 5 layers: 2 groups of 2 mamba layers and the shared block,
# then a tail layer outside any group
SSM = {"mamba2-780m": {}, "zamba2-1.2b": {"n_layers": 5}}
# Gradient gates, each within that share of its largest element.  mamba2:
# 1e-5, as the dense ids (f32 both, sums in another order; measured 2e-6
# to 3e-6).  zamba2: 5e-5.  Its tail layer's conv_bB, A_log and D_skip
# gradients are sums over the 128 tokens that cancel to a few percent of
# their terms, after 2 attention blocks; there JAX's own f32 gradient
# lies up to 1.3e-5 from the same model with its products in f64, and
# the two f32 runs measured 0.7e-5 to 3.0e-5 apart over three batches.
# A lost or doubled term (a missed carry, a head, a shared-block use)
# moves a gradient by O(1) of its largest element.
GRAD_TOL = {"mamba2-780m": 1e-5, "zamba2-1.2b": 5e-5}


def models(arch, **kw):
    kw = {**SSM[arch], **kw}
    jcfg = jax_smoke(jax_config(arch)).replace(**kw)
    cfg = smoke_config(get_config(arch)).replace(**kw)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = get_model(cfg)
    m.load(convert.lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def batch(cfg, B=2, S=64, seed=1):
    return SyntheticLM(cfg.vocab_size, S, B, seed=seed).batch_at(0)


def flat_jax(tree):
    return {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def loss_and_grads(m, hb):
    leaves = tree_leaves(m.params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, met = m.loss(m.params, device_batch(hb, "cpu"))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), met, {name: g for (name, _), g in
                                zip(leaves, grads)}


@pytest.mark.parametrize("arch", sorted(SSM))
def test_loss_and_grads_match_jax(arch):
    """Loss within 1e-6 and every parameter's gradient within
    ``GRAD_TOL`` of its largest element, at S 64 over 4 chunks of 16 (the
    state carried between chunks in every layer); the token count
    equal."""
    jm, jp, m = models(arch)
    hb = batch(m.cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in hb.items()})
    loss, met, grads = loss_and_grads(m, hb)
    close(loss, jl, 1e-6, "loss")
    assert float(met["tokens"]) == float(jmet["tokens"])
    want = flat_jax(jg)
    assert set(want) == set(grads)
    for name, g in grads.items():
        close(g, want[name], GRAD_TOL[arch], name)


def test_published_chunk_gives_finite_grads_where_jax_overflows():
    """mamba2 at smoke width with its published chunk of 256 over 256
    tokens: at random weights (dt ~ 0.7, A ~ -e) the in-chunk decay
    differences pass 88, where JAX's ``where(mask, exp(diff), 0)`` has
    the gradient 0 * inf = NaN in the masked entries, and JAX's
    gradients come out NaN.  The port masks before the exp: the same
    loss within 1e-6, and every gradient finite."""
    jm, jp, m = models("mamba2-780m")
    ssm = dataclasses.replace(m.cfg.ssm, chunk=256)
    jm = jax_model(jm.cfg.replace(ssm=ssm, logit_chunk=256))
    m = get_model(m.cfg.replace(ssm=ssm, logit_chunk=256))
    m.load(convert.lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    hb = batch(m.cfg, B=1, S=256)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in hb.items()})
    assert not all(np.isfinite(v).all() for v in flat_jax(jg).values())
    loss, _, grads = loss_and_grads(m, hb)
    close(loss, jl, 1e-6, "loss")
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name


def _port_loss_and_grads(arch, remat):
    cfg = smoke_config(get_config(arch)).replace(**SSM[arch], remat=remat)
    m = get_model(cfg)
    m.init(torch.Generator().manual_seed(3))
    return loss_and_grads(m, batch(cfg))


@pytest.mark.parametrize("arch", sorted(SSM))
def test_remat_full_gives_the_same_numbers(arch):
    """Recomputing each layer (mamba2) or each group (zamba2) in the
    backward repeats the same CPU ops on the same values: loss and every
    gradient bit-equal to remat "none"."""
    want_loss, _, want = _port_loss_and_grads(arch, "none")
    loss, _, grads = _port_loss_and_grads(arch, "full")
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("arch", sorted(SSM))
def test_train_main_smoke_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import train
    loop = train.main(["--arch", arch, "--smoke", "--steps", "2",
                       "--global-batch", "2", "--seq", "32", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path), "--save-every",
                       "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "step 2 loss" in out
    assert len(loop.history) == 2
    assert all(np.isfinite(h["loss"]) for h in loop.history)
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
