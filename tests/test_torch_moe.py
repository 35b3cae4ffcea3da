"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``moe_block`` on the CPU, f32, with the JAX parameters carried
across by ``convert.lm_params_from_jax`` and inputs drawn from seeded
numpy: the output, the aux loss, the routes and the kept choices, with
top-k 1 and 2, a shared expert (llama4's smoke config), and a router
skewed so that one expert overflows its capacity and choices drop.  The
gradients in x and every parameter against ``jax.vjp``; the routes seam
against the port's own top-k; the combine and its backward run twice,
bit-equal.  Tolerances: outputs and gradients within 1e-5 of the
largest element (f32, sums in another order), the aux loss within 1e-6
of its value."""
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.utils.params import init_params as jax_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.utils.params import tree_leaves  # noqa: E402

TOL = 1e-5


def configs(arch, **moe_kw):
    jcfg = jax_smoke(jax_config(arch))
    cfg = smoke_config(get_config(arch))
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def block_params(jcfg, skew=0.0):
    """JAX ``moe_defs`` parameters from PRNGKey(0) (numpy tree) and the
    port's copy; ``skew`` adds skew / D to the router's column of expert
    0, which raises expert 0's logit by skew times the mean of x."""
    tree = jax.tree.map(np.asarray,
                        jax_init(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0)))
    if skew:
        tree["router"] = tree["router"].copy()
        tree["router"][:, 0] += skew / jcfg.d_model
    return tree, convert.lm_params_from_jax(tree)


def inputs(cfg, B=2, S=24, seed=0, skew=0.0):
    """Standard normal (B, S, D), shifted by 1 when ``skew`` is set."""
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    return (x + (1.0 if skew else 0.0)).astype(np.float32)


def close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def jax_routes(tree, x, jcfg):
    """The JAX code's per-row routes and kept choices: ``lax.top_k`` of
    the softmax of the f32 router, a stable argsort by expert id, the
    position within the expert by ``searchsorted`` (side left), kept
    below the capacity.  Returns (e_idx (B, S*k), keep (B, S*k))."""
    m = jcfg.moe
    B, S, _ = x.shape
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(tree["router"]), -1)
    _, e_idx = jax.lax.top_k(probs, m.top_k)
    e_idx = np.asarray(e_idx).reshape(B, -1)
    C = jmoe._capacity(S, jcfg)
    keep = np.zeros_like(e_idx, bool)
    for b in range(B):
        perm = np.argsort(e_idx[b], kind="stable")
        se = e_idx[b][perm]
        pos = np.arange(len(se)) - np.searchsorted(se, se, side="left")
        keep[b, perm] = pos < C
    return e_idx, keep


CASES = [("qwen3-moe-30b-a3b", {"top_k": 2}, 0.0),
         ("qwen3-moe-30b-a3b", {"top_k": 1}, 0.0),
         ("llama4-maverick-400b-a17b", {}, 0.0),
         ("qwen3-moe-30b-a3b", {"top_k": 2}, 16.0)]


@pytest.mark.parametrize("arch,moe_kw,skew", CASES,
                         ids=["top2", "top1", "llama4-shared", "overflow"])
def test_moe_block_matches_jax(arch, moe_kw, skew):
    """Output, aux, routes and kept choices against JAX; with ``skew``
    the router sends most choices to expert 0, which overflows its
    capacity, so choices drop."""
    jcfg, cfg = configs(arch, **moe_kw)
    tree, p = block_params(jcfg, skew)
    x = inputs(cfg, skew=skew)
    jout, jaux = jmoe.moe_block(tree, jnp.asarray(x), jcfg)
    plan = {}
    out, aux = moe.moe_block(p, torch.tensor(x), cfg, record=plan)
    close(out, jout, TOL, "out")
    close(aux, jaux, 1e-6, "aux")
    e_idx, keep = jax_routes(tree, x, jcfg)
    assert np.array_equal(plan["experts"].numpy(), e_idx)
    assert np.array_equal(plan["keep"].numpy(), keep)
    assert plan["capacity"] == jmoe._capacity(x.shape[1], jcfg)
    if skew:
        # every token sends a choice to expert 0, which keeps C of S
        C, (B, S, _) = plan["capacity"], x.shape
        assert (e_idx == 0).sum() == B * S and C < S
        assert (~keep).sum() == B * (S - C) and (e_idx[~keep] == 0).all()
    if arch.startswith("llama4"):
        assert "shared" in p and cfg.moe.top_k == 1


@pytest.mark.parametrize("arch,moe_kw,skew", CASES,
                         ids=["top2", "top1", "llama4-shared", "overflow"])
def test_moe_block_gradients_match_jax(arch, moe_kw, skew):
    """d(out . g + aux) in x and in every parameter against ``jax.vjp``
    of JAX's ``moe_block``, within 1e-5 of each gradient's largest
    element.  Top-1 (and llama4): the renormalised gate g / g is 1, so
    out's part of the router's gradient is 0 in exact arithmetic and
    each side computes only its rounding residue there (1.4e-6 in JAX
    against the aux part's 4.9e-4, out of a dx of 4.0); the router is
    then held within 1e-6 of dx's largest element."""
    jcfg, cfg = configs(arch, **moe_kw)
    tree, p = block_params(jcfg, skew)
    x = inputs(cfg, skew=skew)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jf(params, xx):
        out, aux = jmoe.moe_block(params, xx, jcfg)
        return jnp.sum(out * g) + aux
    jtree = jax.tree.map(jnp.asarray, tree)
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jtree, jnp.asarray(x))
    leaves = tree_leaves(p)
    xt = torch.tensor(x, requires_grad=True)
    for _, t in leaves:
        t.requires_grad_(True)
    out, aux = moe.moe_block(p, xt, cfg)
    grads = torch.autograd.grad((out * torch.tensor(g)).sum() + aux,
                                [xt] + [t for _, t in leaves])
    close(grads[0], jgx, TOL, "dx")
    want = {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(jgp)}
    assert set(want) == {name for name, _ in leaves}
    dx_scale = float(np.abs(np.asarray(jgx)).max())
    for (name, _), got in zip(leaves, grads[1:]):
        if name == "router" and cfg.moe.top_k == 1:
            err = float(np.abs(got.numpy() - np.asarray(want[name])).max())
            assert err <= 1e-6 * dx_scale, (name, err, dx_scale)
            continue
        close(got, want[name], TOL, name)


def test_routes_seam_gives_the_same_numbers():
    """``routes`` set to the port's own top-k gives the same output,
    aux and gradients, bit for bit; other routes give other outputs."""
    _, cfg = configs("qwen3-moe-30b-a3b", top_k=2)
    _, p = block_params(configs("qwen3-moe-30b-a3b", top_k=2)[0], 16.0)
    x = torch.tensor(inputs(cfg, skew=16.0))
    leaves = [t for _, t in tree_leaves(p)]
    for t in leaves:
        t.requires_grad_(True)

    def run(routes=None):
        plan = {}
        out, aux = moe.moe_block(p, x, cfg, routes=routes, record=plan)
        return out, aux, plan, torch.autograd.grad(out.sum() + aux, leaves)
    out, aux, plan, grads = run()
    routes = plan["experts"].view(x.shape[0], x.shape[1], 2)
    out2, aux2, plan2, grads2 = run(routes)
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    assert torch.equal(plan["keep"], plan2["keep"])
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    other, _, _, _ = run(routes.flip(-1).roll(1, dims=1))
    assert not torch.equal(other, out)


def test_combine_and_backward_are_deterministic_gathers():
    """The dispatch and the combine (``_Route``) run twice give bit-equal
    outputs and gradients; their gradient equals autograd of the same
    function written with ``index_add_`` (the scatter-add the port
    avoids), within 1e-6 of the largest element, on an overflowing
    router."""
    jcfg, cfg = configs("qwen3-moe-30b-a3b", top_k=2)
    _, p = block_params(jcfg, 16.0)
    x0 = torch.tensor(inputs(cfg, skew=16.0))
    g = torch.tensor(np.random.default_rng(2).standard_normal(
        x0.shape).astype(np.float32))

    def run():
        x = x0.clone().requires_grad_(True)
        out, _ = moe.moe_block(p, x, cfg)
        return out, torch.autograd.grad((out * g).sum(), x)[0]
    a, da = run()
    b, db = run()
    assert torch.equal(a, b) and torch.equal(da, db)

    # the same dispatch with a scatter-add, through plain autograd
    r = moe.route(p, x0, cfg)
    B, S, D = x0.shape
    k, E, C = cfg.moe.top_k, cfg.moe.n_experts, r["capacity"]
    x = x0.clone().requires_grad_(True)
    slot = r["tok_slot"].reshape(B, S * k)
    buf = torch.zeros(B, E * C + 1, D)
    tok = torch.arange(S).repeat_interleave(k)
    for bb in range(B):
        buf[bb] = buf[bb].index_add(0, slot[bb], x[bb, tok])
    buf = buf[:, :E * C]
    plain = torch.autograd.grad((buf * buf).sum(), x)[0]
    x = x0.clone().requires_grad_(True)
    mine = moe._Route.apply(x, r["slot_tok"], r["tok_slot"])
    assert torch.equal(mine, buf.detach())
    close(torch.autograd.grad((mine * mine).sum(), x)[0], plain, 1e-6,
          "dispatch gradient")


def test_moe_units_every_two_with_shared_expert():
    """llama4's smoke config (every = 2: one unit {dense0, moe_layer},
    a shared expert): the parameter tree's keys and shapes equal JAX's,
    and loss, ce and aux on one batch within 1e-6 of JAX's."""
    arch = "llama4-maverick-400b-a17b"
    jcfg, cfg = configs(arch)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    m = get_model(cfg)
    m.load(convert.lm_params_from_jax(tree))
    want = {".".join(k.key for k in path): v.shape for path, v in
            jax.tree_util.tree_leaves_with_path(jp)}
    got = {name: tuple(d.shape) for name, d in tree_leaves(m.param_defs())}
    assert got == want
    assert "layers.moe_layer.moe.shared.w_gate" in got
    assert "layers.dense0.mlp.w_gate" in got
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33),
                                            dtype=np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met = m.loss(m.params, {k: torch.tensor(v).long()
                                  for k, v in batch.items()})
    for key, a, b in (("loss", loss, jl), ("ce", met["ce"], jmet["ce"]),
                      ("aux", met["aux"], jmet["aux"])):
        close(a, b, 1e-6, key)
    assert float(met["aux"]) > 0
