"""The port's SAC learner (``repro_torch.core.sac``) and replay buffer
against the JAX package's, on ResNet-50 (57 nodes).  Both sides start
from one learner state, carried over by ``repro_torch.convert``, and see
the same actions, rewards and action noise (numpy-seeded).  The JAX side
runs its GAT on the dense ``"jnp"`` backend; the port runs the plain
GAT and its plain backward on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gnn as jgnn  # noqa: E402
from repro.core import replay as jreplay  # noqa: E402
from repro.core import sac as jsac  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro.utils.params import init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gnn, params, replay, sac  # noqa: E402
from test_torch_gnn import _jax_pool_indices  # noqa: E402

B = 24
# Gradients: two chained GAT levels (critic) or six (actor through the
# critic) in another f32 summation order; held to 1e-4 of the largest
# element of each gradient.
GRAD_TOL = 1e-4
# Q values: each head sums 128 products of pooled features of order 3
# that cancel to |Q| ~ 0.3, so the trunk's ~1e-6 rounding differences
# reach Q as up to ~1e-5 absolute; losses inherit that.
Q_TOL = 5e-5


@pytest.fixture(scope="module")
def setup():
    jg = jzoo.resnet50()
    feats, adj = jg.features(), jg.adjacency()
    jl = jsac.SACLearner(jnp.asarray(feats), jnp.asarray(adj),
                         jax.random.PRNGKey(0))
    port = sac.SACLearner(torch.as_tensor(feats), torch.as_tensor(adj > 0),
                          generator=torch.Generator().manual_seed(0))
    port.load_state(convert.sac_state_from_jax(jl))
    return jl, port, feats, adj


def _batch(seed, n, steps=None):
    """Replay-like actions, rewards and clipped action noise."""
    rng = np.random.default_rng(seed)
    lead = (B,) if steps is None else (steps, B)
    acts = rng.integers(0, 3, lead + (n, 2)).astype(np.int32)
    rews = (5.0 + rng.standard_normal(lead)).astype(np.float32)
    noise = np.clip(0.2 * rng.standard_normal(lead + (n, 2, 3)), -0.5,
                    0.5).astype(np.float32)
    return acts, rews, noise


def _onehot(acts, noise):
    return (np.eye(3, dtype=np.float32)[acts] + noise).astype(np.float32)


def _jax_actor_loss(jl, feats, adj):
    """The JAX learner's actor loss (``SACLearner.__init__``), on the
    dense GAT backend."""
    alpha = jl.cfg.alpha

    def loss(ap, cp):
        logits = jgnn.gnn_forward(ap, feats, adj, backend="jnp")
        probs = jax.nn.softmax(logits, axis=-1)
        q1, q2 = jsac.critic_forward(cp, feats, adj, probs, backend="jnp")
        ent = jgnn.entropy(logits)
        return -(jnp.minimum(q1, q2) + alpha * ent), ent
    return loss


def _jax_critic_loss(feats, adj):
    def loss(cp, oh, r):
        q1, q2 = jax.vmap(lambda a: jsac.critic_forward(
            cp, feats, adj, a, backend="jnp"))(oh)
        return jnp.mean((q1 - r) ** 2 + (q2 - r) ** 2)
    return loss


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * np.abs(want).max(),
                               rtol=0)


def test_critic_spec_is_jax_leaf_order_and_state_round_trips(setup):
    jl, port, feats, _ = setup
    F = feats.shape[1]
    tree = init_params(jsac.critic_defs(F), jax.random.PRNGKey(1))
    paths = [".".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    spec = params.critic_spec(F)
    assert paths == [name for name, _, _ in spec]
    assert [tuple(x.shape) for x in jax.tree.leaves(tree)] == \
        [shape for _, shape, _ in spec]
    flat = convert.critic_from_jax(jax.tree.map(np.asarray, tree), F)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.asarray(x).ravel()
                                      for x in jax.tree.leaves(tree)]))
    for a, b in zip(jax.tree.leaves(convert.critic_to_jax(flat, F)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the whole learner state, Adam moments and step count included
    g = jax.tree.map(jnp.ones_like, jl.critic)
    _, opt_c = jsac._adam_step(1e-3, jl.critic, g, jl.opt_c)
    other = jsac.SACLearner(jl.feats, jl.adj, jax.random.PRNGKey(5))
    other.opt_c = opt_c
    state = convert.sac_state_from_jax(other)
    assert state["opt_c"]["t"] == 1 and state["opt_a"]["t"] == 0
    learner = sac.SACLearner(port.feats, port.mask)
    learner.load_state(state)
    back = convert.sac_state_to_jax(learner.state())
    for key in ("actor", "critic", "opt_a", "opt_c"):
        want = getattr(other, key)
        for a, b in zip(jax.tree.leaves(back[key]), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_critic_forward_matches_jax(setup):
    """B = 24 noisy one-hot actions as one batch axis of the port's
    critic (one ``gat_mp`` call per level), to ``Q_TOL``."""
    jl, port, feats, adj = setup
    acts, _, noise = _batch(0, feats.shape[0])
    oh = _onehot(acts, noise)
    jq1, jq2 = jax.vmap(lambda a: jsac.critic_forward(
        jl.critic, jnp.asarray(feats), jnp.asarray(adj), a,
        backend="jnp"))(jnp.asarray(oh))
    q1, q2 = sac.critic_forward(port.critic, port.feats, port.mask,
                                torch.as_tensor(oh))
    assert q1.shape == (B,)
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), atol=Q_TOL)
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), atol=Q_TOL)


def test_loss_gradients_match_jax_grad(setup):
    jl, port, feats, adj = setup
    jf, ja = jnp.asarray(feats), jnp.asarray(adj)
    F = feats.shape[1]
    # the pooled node sets agree first: a near-tie at the k-th place
    # would change the actor's graph, and would be the cause to name
    _, (i1, i2) = gnn.population_forward(port.actor[None], port.feats,
                                         port.mask)
    j1, j2 = _jax_pool_indices(jl.actor, jf, ja)
    np.testing.assert_array_equal(np.sort(i1[0].numpy()), np.sort(j1))
    np.testing.assert_array_equal(np.sort(i2[0].numpy()), np.sort(j2))

    acts, rews, noise = _batch(1, feats.shape[0])
    oh = _onehot(acts, noise)
    jloss, jgrad = jax.value_and_grad(_jax_critic_loss(jf, ja))(
        jl.critic, jnp.asarray(oh), jnp.asarray(rews))
    critic = port.critic.clone().requires_grad_()
    loss = port.critic_loss(critic, torch.as_tensor(oh),
                            torch.as_tensor(rews))
    (grad,) = torch.autograd.grad(loss, critic)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5,
                                                 abs=Q_TOL)
    _close_grad(grad.numpy(), convert.critic_from_jax(
        jax.tree.map(np.asarray, jgrad), F).numpy())

    (jaloss, jent), jagrad = jax.value_and_grad(
        _jax_actor_loss(jl, jf, ja), has_aux=True)(jl.actor, jl.critic)
    actor = port.actor.clone().requires_grad_()
    aloss, ent = port.actor_loss(actor, port.critic)
    (agrad,) = torch.autograd.grad(aloss, actor)
    assert float(aloss.detach()) == pytest.approx(float(jaloss), rel=1e-5,
                                                  abs=Q_TOL)
    assert float(ent.detach()) == pytest.approx(float(jent), rel=1e-5)
    want = convert.gnn_from_jax(jax.tree.map(np.asarray, jagrad)).numpy()
    _close_grad(agrad.numpy(), want)
    # every leaf of the actor gets a gradient, through all 4 GAT levels,
    # both pools' gates and the unpool scatters
    for name, leaf in params.unflatten(agrad[None]).items():
        assert float(leaf.abs().max()) > 0, name


def test_adam_step_matches_jax():
    """Same gradients, same state: the step is elementwise per leaf, so
    one flat vector reproduces it to 1e-6 relative (the float32 power in
    the bias correction may round differently by an ulp)."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": (11,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]

    def flat(tree):
        return torch.as_tensor(np.concatenate([np.asarray(tree[k]).ravel()
                                               for k in sorted(tree)]))

    jp, jstate = jax.tree.map(jnp.asarray, p), jsac._adam_init(p)
    tp, tstate = flat(p), sac.adam_init(flat(p))
    for g in gs:
        jp, jstate = jsac._adam_step(1e-3, jp, jax.tree.map(jnp.asarray, g),
                                     jstate)
        tp, tstate = sac.adam_step(1e-3, tp, flat(g), tstate)
        np.testing.assert_allclose(tp.numpy(), flat(jp).numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tstate["v"].numpy(),
                                   flat(jstate["v"]).numpy(), rtol=1e-6)
    assert tstate["t"] == int(jstate["t"]) == 3


def test_two_update_steps_match_update_scan(setup, monkeypatch):
    """Two gradient steps of ``update`` against the JAX learner's jitted
    ``_update_scan`` on the same acts, rewards and noise.  Adam's first
    step is lr * sign(g), so a parameter whose gradient is rounding noise
    may move 2 lr apart in the two packages; the losses, which average
    over every parameter, are compared (rtol 1e-3), not raw parameters."""
    monkeypatch.setenv("REPRO_GAT_BACKEND", "jnp")
    jl, _, feats, adj = setup
    steps, n = 2, feats.shape[0]
    acts, rews, noise = _batch(3, n, steps=steps)
    scan = jsac._make_update_scan(
        jl.cfg, lambda cp, oh, r: _jax_critic_loss(
            jnp.asarray(feats), jnp.asarray(adj))(cp, oh, r),
        _jax_actor_loss(jl, jnp.asarray(feats), jnp.asarray(adj)))
    out = scan(jl.actor, jl.critic, jl.opt_a, jl.opt_c, jnp.asarray(acts),
               jnp.asarray(rews), jnp.asarray(noise))
    jcl, jal, jen = (float(x) for x in out[4:])
    # the learner's own scan (default-backend dispatch, pinned to "jnp")
    # gives the same losses as the composed one
    own = jl._update_scan(jl.actor, jl.critic, jl.opt_a, jl.opt_c,
                          jnp.asarray(acts), jnp.asarray(rews),
                          jnp.asarray(noise))
    assert float(own[4]) == pytest.approx(jcl, rel=1e-5)

    port = sac.SACLearner(torch.as_tensor(feats), torch.as_tensor(adj > 0))
    port.load_state(convert.sac_state_from_jax(jl))

    class Fixed:           # a buffer that hands out the prepared batches
        def __init__(self):
            self.u = 0

        def __len__(self):
            return B

        def sample(self, batch):
            self.u += 1
            return acts[self.u - 1], rews[self.u - 1]

    info = port.update(Fixed(), steps, noise=torch.as_tensor(noise))
    assert info["critic_loss"] == pytest.approx(jcl, rel=1e-3)
    assert info["actor_loss"] == pytest.approx(jal, rel=1e-3)
    assert info["entropy"] == pytest.approx(jen, rel=1e-3)
    assert port.opt_a["t"] == port.opt_c["t"] == steps
    # a short buffer trains nothing
    assert port.update(replay.ReplayBuffer(n), steps) == {}


def test_replay_buffer_samples_like_jax():
    rng = np.random.default_rng(4)
    jb, tb = jreplay.ReplayBuffer(9, capacity=50, seed=7), \
        replay.ReplayBuffer(9, capacity=50, seed=7)
    for _ in range(4):                      # wraps the ring once
        acts = rng.integers(0, 3, (17, 9, 2))
        rews = rng.standard_normal(17).astype(np.float32)
        jb.add_batch(acts, rews)
        tb.add_batch(acts, rews)
    jb.add(acts[0], 1.5)
    tb.add(acts[0], 1.5)
    assert len(tb) == len(jb) == 50 and tb.ptr == jb.ptr
    for _ in range(5):
        (ja, jr), (ta, tr) = jb.sample(B), tb.sample(B)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tr, jr)
        assert ta.dtype == np.int32


def test_explore_actions_are_gumbel_max_of_the_actor(setup):
    _, port, feats, _ = setup
    gum = port.draw_gumbel(3)
    acts = port.explore_actions(3, gum)
    logits = gnn.gnn_forward(port.actor, port.feats, port.mask)
    assert acts.shape == (3, feats.shape[0], 2) and acts.dtype == torch.int32
    np.testing.assert_array_equal(
        acts.numpy(), torch.argmax(logits[None] + gum, -1).numpy())
    noise = port.draw_noise(2)
    assert noise.shape == (2, B, feats.shape[0], 2, 3)
    assert float(noise.abs().max()) <= 0.5
