"""The port's sharded serving (every family's ``prefill`` /
``decode_step`` under a plan, caches laid out by
``launch/programs.py`` ``cache_specs``, the partial-softmax decode over
a cache cut on S, the engine on every rank) on the CPU, against the JAX
package's single-device ``prefill`` / ``decode_step`` and its engine.

One ``python -m torch.distributed.run --nproc-per-node 4`` of
``tests/_torch_serve_worker.py`` (gloo, 4 ranks) runs every case of the
worker's ``CASES`` and ``ENGINE_CASES`` and writes what it got; the tests
compare.  qwen3-0.6b's smoke config (4 query heads over 2 kv heads) at
(1, 2) cuts its kv heads, at (1, 4) its query heads with the cache cut
on S over "model", at (2, 2) the batch of 2 over "data", at (4, 1) with
a batch of 1 the cache on S over "data"; with 6 query heads its
attention is sequence-parallel at (1, 4) (prompts of 13 and 8), with
``seq_shard_activations`` its prefill's residual stream is cut on S;
qwen3-moe, mamba2, zamba2 and seamless split at (1, 4), zamba2 also
cuts its shared block's cache on S over "data" at (4, 1); the plans
"model" 4 does not divide the experts or SSM heads of: qwen3-moe with 6
experts (each expert's d_ff_expert cut), mamba2 and zamba2 at head_dim
64 (d_in cut, the layers whole; zamba2's prefill with its residual
stream cut on S).  The
parameters are JAX's initialisation (``PRNGKey(0)``), carried across by
``convert.lm_params_from_jax``; smoke configs in f32.

Tolerances: the split sums in another order than one device (the
row-parallel products summed over ranks, the partial softmaxes, the
split norms), so the prefill's last-token logits and the three decode
steps' are held within 1e-5 of the largest |logit|, the gathered caches
within 1e-5 of each leaf's largest element; the engine's finished
requests give JAX's engine's tokens exactly.
"""
import os
import subprocess
import sys

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
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import ProcessMesh  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.utils.params import tree_leaves  # noqa: E402

import _torch_serve_worker as W  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TOL = 1e-5


def _jax_cfg(arch, over=None):
    return W.with_overrides(jax_smoke(jax_config(arch)), over or {})


def _over(name):
    return W.CASES[name][5] if name in W.CASES else {}


def _arch(name):
    return W.CASES[name][0] if name in W.CASES else W.ENGINE_CASES[name]


@pytest.fixture(scope="module")
def jax_params():
    """{input key: JAX parameters from PRNGKey(0)}."""
    out = {}
    for name in list(W.CASES) + list(W.ENGINE_CASES):
        key = W.input_key(name)
        if key not in out:
            out[key] = jax_model(_jax_cfg(_arch(name), _over(name))).init(
                jax.random.PRNGKey(0))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_params):
    """The worker's outputs: one torchrun of 4 gloo ranks for the file,
    on JAX's parameters carried across by ``convert``."""
    d = tmp_path_factory.mktemp("serve")
    inp, out = d / "in", d / "out"
    inp.mkdir()
    out.mkdir()
    for key, jp in jax_params.items():
        tree = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp))
        np.savez(inp / f"{key}.npz", **{n: x.detach().numpy()
                                        for n, x in tree_leaves(tree)})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", os.path.join(HERE, "_torch_serve_worker.py"),
         str(inp), str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return out


def close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(W.CASES))
def test_prefill_and_decode_match_jax(run, jax_params, name):
    """Every case's prefill logits, three decode steps' logits (on the
    case's tokens) and final gathered cache against JAX's single-device
    ``prefill`` / ``decode_step`` on the whole batch."""
    arch, _, _, _, max_len, over, _ = W.CASES[name]
    jm = jax_model(_jax_cfg(arch, over))
    jp = jax_params[W.input_key(name)]
    inp, toks = W.case_inputs(name)
    # jitted once a case: eager calls would trace each scan anew
    prefill = jax.jit(jm.prefill, static_argnums=2)
    decode = jax.jit(jm.decode_step)
    jcache, jl = prefill(jp, jnp.asarray(inp), max_len)
    got = np.load(run / f"{name}.npz")
    close(got["logits0"], jl, f"{name} prefill logits")
    first = W.first_decode_pos(name)
    for i in range(W.DECODE_STEPS):
        jl, jcache = decode(jp, jcache, jnp.asarray(toks[i]),
                            jnp.int32(first + i))
        close(got[f"logits{i + 1}"], jl, f"{name} decode {i + 1} logits")
    keys = {k[len("cache/"):] for k in got.files if k.startswith("cache/")}
    assert keys == set(jcache)
    for k, v in jcache.items():
        close(got[f"cache/{k}"], v, f"{name} cache {k}")


@pytest.mark.parametrize("name", list(W.ENGINE_CASES))
def test_engine_matches_jax_engine(run, jax_params, name):
    """The engine on 4 ranks at (1, 4): every rank finishes the same
    requests with the same tokens, JAX's engine's on one device."""
    cfg = _jax_cfg(_arch(name))
    jm, jp = jax_model(cfg), jax_params[W.input_key(name)]
    eng = JaxEngine(jm, jp, slots=W.ENGINE_SLOTS, max_len=W.ENGINE_MAX_LEN)
    for i, p in enumerate(W.engine_prompts(cfg)):
        eng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=W.ENGINE_NEW))
    want = {r.rid: list(r.tokens) for r in eng.run_until_drained()}
    got = np.load(run / f"{name}.npz")
    assert bool(got["ranks_agree"])
    assert dict(zip(got["rids"].tolist(), got["tokens"].tolist())) == want
    assert len(want) == len(W.ENGINE_PROMPTS)


@pytest.mark.parametrize("pos", [2, 5, 15])
def test_decode_attention_over_cut_cache(run, pos):
    """``decode_attention`` over a cache of 16 cut on S over 4 ranks
    equals the whole cache's; at pos 2 ranks 1-3 hold no position up to
    pos (their scale is exactly 0, never NaN)."""
    got = np.load(run / "decode_attention.npz")
    cut, whole = got[f"cut{pos}"], got[f"whole{pos}"]
    assert np.isfinite(cut).all()
    np.testing.assert_allclose(cut, whole, rtol=0, atol=1e-6)


def _rank_plan(arch, shape, batch, max_len=16, rank=0):
    """A plan over a one-process view of rank ``rank`` of a (data, model)
    mesh: the layout needs no process group."""
    mesh = ProcessMesh(("data", "model"),
                       np.arange(int(np.prod(shape))).reshape(shape),
                       rank=rank)
    cfg = W.case_config(arch)
    return cfg, make_plan(cfg, mesh, ShapeCfg("serve", max_len, batch,
                                               "decode"))


def test_narrowings_raise():
    """The engine under a plan whose batch axes cut the slots raises
    naming them; a cache whose max_len its sequence axes do not divide
    raises, as an uneven parameter does."""
    cfg, plan = _rank_plan("qwen3-0.6b", (2, 2), 2)
    model = get_model(cfg, plan)
    with pytest.raises(NotImplementedError, match="batch axes"):
        Engine(model, None, slots=2, max_len=16)
    cfg, plan = _rank_plan("qwen3-0.6b", (1, 4), 1)
    model = get_model(cfg, plan)
    assert model.cache_cut is not None and model.cache_cut.n == 4
    assert model.init_cache(1, 16)["k"].shape == (2, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="does not split"):
        model.init_cache(1, 15)
