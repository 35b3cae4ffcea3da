"""The port's language models against the JAX package on the same
parameters: smoke configs of zamba2 (5 layers: two groups and a tail
layer), mamba2-780m and qwen3-0.6b, f32.  The JAX parameters go
through ``convert.lm_params_from_jax``; prefill logits and every cache
entry, then one ``decode_step`` from the JAX cache, agree to 1e-4 of
the largest element (f32 sums in another order)."""
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
from repro_torch.models.zoo import get_model  # noqa: E402

ARCHS = {"zamba2-1.2b": {"n_layers": 5}, "mamba2-780m": {},
         "qwen3-0.6b": {}}
TOL = 1e-4


def models(arch):
    jcfg = jax_smoke(jax_config(arch)).replace(**ARCHS[arch])
    cfg = smoke_config(get_config(arch)).replace(**ARCHS[arch])
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    m = get_model(cfg)
    m.load(convert.lm_params_from_jax(tree))
    return jm, jp, tree, m


def close(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch):
    jm, jp, _, m = models(arch)
    B, S, max_len = 2, 32, 40
    tokens = np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (B, S)).astype(np.int32)
    jcache, jlogits = jm.prefill(jp, jnp.asarray(tokens), max_len)
    with torch.no_grad():
        cache, logits = m.prefill(m.params, torch.tensor(tokens).long(),
                                  max_len)
    close(logits, jlogits, "prefill logits")
    assert set(cache) == set(jcache)
    for name in jcache:
        close(cache[name], jcache[name], f"cache {name}")

    tok = np.asarray(jnp.argmax(jlogits[:, :m.cfg.vocab_size], -1), np.int32)
    jl2, jc2 = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(S))
    port_cache = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jcache))
    with torch.no_grad():
        l2, c2 = m.decode_step(m.params, port_cache, torch.tensor(tok).long(),
                               S)
    close(l2, jl2, "decode logits")
    for name in jc2:
        close(c2[name], jc2[name], f"decoded cache {name}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_round_trip_is_exact(arch):
    _, _, tree, m = models(arch)
    back = convert.lm_params_to_jax(m.params)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    back_flat = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in back_flat]
    for (path, a), (_, b) in zip(flat, back_flat):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # the port draws its own parameters in the same layout, with the same
    # initialisers: equal constants, and standard deviations within 15%
    own = get_model(m.cfg)
    own.init(torch.Generator().manual_seed(0))
    mine = dict(jax.tree_util.tree_leaves_with_path(
        convert.lm_params_to_jax(own.params)))
    for path, a in flat:
        b = mine[path]
        assert b.shape == a.shape and b.dtype == a.dtype, path
        if a.std() == 0:
            assert np.array_equal(a, b), path
        elif a.size >= 1000:
            assert abs(b.std() / a.std() - 1) < 0.15, path
