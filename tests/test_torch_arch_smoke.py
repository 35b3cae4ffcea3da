"""The port's counterpart of ``tests/test_arch_smoke.py``, on the CPU:
every registry id at its smoke size takes one ``make_train_step`` step
(finite loss, parameters moved) and a prefill then a decode step (finite
logits of the padded vocab).  For the families this slice ports (the MoE
ids qwen3-moe-30b-a3b and llama4-maverick-400b-a17b, the VLM
chameleon-34b, the encoder-decoder seamless-m4t-medium), the JAX
parameters go through ``convert.lm_params_from_jax`` and the loss and
every parameter's gradient are held against ``jax.value_and_grad``, the
prefill and decode logits and every cache entry against JAX's.
Tolerances (f32, sums in another order): the loss within 1e-6 of its
value, each gradient within 1e-5 of its leaf's largest element, logits
and caches within 1e-4 of their largest element, as
``tests/test_torch_lm.py`` holds the other families."""
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
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          smoke_config)
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from repro_torch.utils.params import tree_leaves  # noqa: E402

NEW = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "chameleon-34b",
       "seamless-m4t-medium")
B, S = 2, 32


def batch(cfg, seed=1):
    """A SyntheticLM batch (B, S), and for encdec frame embeddings
    (B, S, D) from seeded numpy."""
    hb = dict(SyntheticLM(cfg.vocab_size, S, B, seed=seed).batch_at(0))
    if cfg.family == "encdec":
        hb["enc_emb"] = np.random.default_rng(seed).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return hb


def close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step(arch):
    cfg = smoke_config(get_config(arch))
    m = get_model(cfg)
    m.init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in tree_leaves(m.params)}
    step, init, _ = make_train_step(m, cfg)
    params, _, met = step(m.params, init(m.params),
                          device_batch(batch(cfg), "cpu"), 0)
    assert np.isfinite(float(met["loss"])), arch
    assert any(not torch.equal(p, before[n]) for n, p in tree_leaves(params))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_after_prefill(arch):
    cfg = smoke_config(get_config(arch))
    m = get_model(cfg)
    m.init(torch.Generator().manual_seed(0))
    n, max_len = 16, 32
    hb = batch(cfg)
    if cfg.family == "encdec":
        inputs = torch.tensor(hb["enc_emb"][:, :n])
    else:
        inputs = torch.tensor(hb["tokens"][:, :n]).long()
    with torch.no_grad():
        cache, logits = m.prefill(m.params, inputs, max_len)
        assert bool(torch.isfinite(logits).all()), arch
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
        pos = 1 if cfg.family == "encdec" else n
        logits2, _ = m.decode_step(m.params, cache, tok, pos)
    assert logits2.shape == (B, cfg.vocab_padded), arch
    assert bool(torch.isfinite(logits2).all()), arch


def models(arch):
    jcfg = jax_smoke(jax_config(arch))
    cfg = smoke_config(get_config(arch))
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = get_model(cfg)
    m.load(convert.lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, m


@pytest.mark.parametrize("arch", NEW)
def test_loss_and_grads_match_jax(arch):
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
    close(met["aux"], jmet["aux"], 1e-6, "aux")
    if m.cfg.moe is not None:
        assert float(met["aux"].detach()) > 0
    want = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jg)}
    assert set(want) == {name for name, _ in leaves}
    for (name, _), g in zip(leaves, grads):
        close(g, want[name], 1e-5, name)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_jax(arch):
    jm, jp, m = models(arch)
    cfg, max_len = m.cfg, 40
    hb = batch(cfg, seed=2)
    encdec = cfg.family == "encdec"
    inputs = hb["enc_emb"] if encdec else hb["tokens"]
    jcache, jlogits = jm.prefill(jp, jnp.asarray(inputs), max_len)
    with torch.no_grad():
        t_in = torch.tensor(inputs)
        cache, logits = m.prefill(m.params, t_in if encdec else t_in.long(),
                                  max_len)
    close(logits, jlogits, 1e-4, "prefill logits")
    assert set(cache) == set(jcache)
    for name in jcache:
        close(cache[name], jcache[name], 1e-4, f"cache {name}")

    tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab_size], -1), np.int32)
    pos = 1 if encdec else S
    jl2, jc2 = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
    port_cache = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jcache))
    with torch.no_grad():
        l2, c2 = m.decode_step(m.params, port_cache,
                               torch.tensor(tok).long(), pos)
    close(l2, jl2, 1e-4, "decode logits")
    assert set(c2) == set(jc2)
    for name in jc2:
        close(c2[name], jc2[name], 1e-4, f"decoded cache {name}")
