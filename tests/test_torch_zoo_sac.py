"""The port's multi-workload SAC pieces (``critic_forward_masked``,
``ZooSAC``, ``ReplayBank``) against the JAX package's, over a 2-bucket
zoo of small graphs (resnet50 | mobilenet_v2, tiny_gpt), from one
learner state (``repro_torch.convert``), on the same replay rows and
action noise (numpy-seeded).  The JAX side runs its GAT on the dense
"jnp" backend; the port the plain GAT and its plain backward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import replay as jreplay  # noqa: E402
from repro.core import sac as jsac  # noqa: E402
from repro.graphs import bucketed as jbucketed  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import replay, sac  # noqa: E402
from repro_torch.graphs import bucketed, zoo  # noqa: E402

SMALL = ["resnet50", "mobilenet_v2", "tiny_gpt"]
B = 24
# Q values sum 128 products of pooled features of order 3 that cancel to
# |Q| ~ 0.3: the trunk's ~1e-6 rounding differences (another f32 order)
# reach them as ~1e-6 absolute
Q_TOL = 1e-5
LOSS_REL = 1e-5


@pytest.fixture(scope="module")
def setup():
    bz = bucketed.build_bucketed_zoo([zoo.WORKLOADS[n]() for n in SMALL],
                                     "auto", device="cpu")
    jbz = jbucketed.build_bucketed_zoo([jzoo.WORKLOADS[n]() for n in SMALL],
                                       "auto")
    assert bz.n_buckets == 2 and bz.bucket_sizes == (1, 2)
    return bz, jbz


def _onehots(rng, gb, lead):
    acts = rng.integers(0, 3, lead + (gb.n_graphs, B, gb.n_max, 2))
    noise = np.clip(0.2 * rng.standard_normal(acts.shape + (3,)), -0.5,
                    0.5).astype(np.float32)
    return acts.astype(np.int32), noise


def test_critic_forward_masked_matches_jax(setup):
    bz, jbz = setup
    gb, jgb = bz.buckets[1], jbz.buckets[1]
    port = sac.ZooSAC(bz, generator=torch.Generator().manual_seed(0))
    acts, noise = _onehots(np.random.default_rng(0), gb, ())
    oh = (np.eye(3, dtype=np.float32)[acts] + noise).astype(np.float32)
    # garbage in the padded rows of the actions: inert on both sides
    q1, q2 = sac.critic_forward_masked(port.critic, gb.feats, gb.adj > 0,
                                       gb.node_mask, torch.as_tensor(oh))
    cp = convert.critic_to_jax(port.critic, tree=True)
    jq = jax.vmap(lambda f, a, m, o: jax.vmap(
        lambda x: jsac.critic_forward_masked(cp, f, a, m, x, backend="jnp"))(
        o))(jgb.feats, jgb.adj, jgb.node_mask, jnp.asarray(oh))
    assert q1.shape == (gb.n_graphs, B)
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq[0]), atol=Q_TOL,
                               rtol=0)
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq[1]), atol=Q_TOL,
                               rtol=0)
    # one graph with every node real: the single-graph critic
    g = zoo.resnet50()
    one = sac.critic_forward_masked(
        port.critic, bz.buckets[0].feats, bz.buckets[0].adj > 0,
        bz.buckets[0].node_mask, torch.as_tensor(oh[:1, :, :g.n]))
    ref = sac.critic_forward(port.critic, torch.as_tensor(g.features()),
                             torch.as_tensor(g.adjacency() > 0),
                             torch.as_tensor(oh[0, :, :g.n]))
    for a, b in zip(one, ref):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), atol=1e-6,
                                   rtol=0)


def _banks(bz, seed=5):
    """Port and JAX replay banks holding the same 30 rows per graph."""
    rng = np.random.default_rng(seed)
    ours = replay.ReplayBank(bz.node_slots, seed=seed)
    theirs = jreplay.ReplayBank(bz.node_slots, seed=seed)
    for i, n in enumerate(bz.node_slots):
        a = rng.integers(0, 3, (30, n, 2))
        r = (5.0 + rng.standard_normal(30)).astype(np.float32)
        ours.add_graph(i, a, r)
        theirs.add_graph(i, a, r)
    return ours, theirs


def test_one_update_step_matches_jax(setup, monkeypatch):
    monkeypatch.setenv("REPRO_GAT_BACKEND", "jnp")
    bz, jbz = setup
    jl = jsac.ZooSAC(jbz, jax.random.PRNGKey(0))
    port = sac.ZooSAC(bz)
    port.load_state(convert.sac_state_from_jax(jl))
    bank, jbank = _banks(bz)
    rng = np.random.default_rng(6)
    noise = [np.clip(0.2 * rng.standard_normal(
        (1, gb.n_graphs, B, gb.n_max, 2, 3)), -0.5, 0.5).astype(np.float32)
        for gb in bz.buckets]
    acts, rews = zip(*(jbank.sample_bucket(ids, B, 1)
                       for ids in jl._bucket_ids))
    out = jl._update_scan(jl.actor, jl.critic, jl.opt_a, jl.opt_c,
                          tuple(jnp.asarray(a) for a in acts),
                          tuple(jnp.asarray(r) for r in rews),
                          tuple(jnp.asarray(n) for n in noise))
    jcl, jal, jen = (float(x) for x in out[4:])
    info = port.update(bank, 1, noise=tuple(torch.as_tensor(n)
                                            for n in noise))
    # the banks drew the same rows: both rngs moved alike
    for ours, theirs in zip(bank.buffers, jbank.buffers):
        assert ours.rng.integers(1 << 30) == theirs.rng.integers(1 << 30)
    assert info["critic_loss"] == pytest.approx(jcl, rel=LOSS_REL)
    assert info["entropy"] == pytest.approx(jen, rel=LOSS_REL)
    assert info["actor_loss"] == pytest.approx(jal, rel=LOSS_REL)
    assert port.opt_a["t"] == port.opt_c["t"] == 1
    # a bank short of a batch trains nothing
    assert port.update(replay.ReplayBank(bz.node_slots), 1) == {}


def test_one_graph_zoo_sac_is_sac_learner():
    """A zoo of one graph with every node real: the same init from one
    generator seed, the same replay draws (a one-graph bank draws what
    ``ReplayBuffer(seed)`` draws) and noise give the losses and
    parameters of ``SACLearner``."""
    g = zoo.resnet50()
    bz = bucketed.build_bucketed_zoo([g], device="cpu")
    zs = sac.ZooSAC(bz, generator=torch.Generator().manual_seed(0))
    sl = sac.SACLearner(torch.as_tensor(g.features()),
                        torch.as_tensor(g.adjacency() > 0),
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(zs.actor, sl.actor) and torch.equal(zs.critic,
                                                           sl.critic)
    rng = np.random.default_rng(7)
    bank, buf = replay.ReplayBank([g.n], seed=3), replay.ReplayBuffer(g.n,
                                                                     seed=3)
    a = rng.integers(0, 3, (40, g.n, 2))
    r = (5.0 + rng.standard_normal(40)).astype(np.float32)
    bank.add_graph(0, a, r)
    buf.add_batch(a, r)
    noise = torch.as_tensor(np.clip(0.2 * rng.standard_normal(
        (2, B, g.n, 2, 3)), -0.5, 0.5).astype(np.float32))
    got = zs.update(bank, 2, noise=(noise[:, None],))
    want = sl.update(buf, 2, noise=noise)
    for k in ("critic_loss", "actor_loss", "entropy"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    np.testing.assert_allclose(zs.critic.numpy(), sl.critic.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(zs.actor.numpy(), sl.actor.numpy(),
                               atol=1e-6, rtol=0)
    # the explore rollouts are Gumbel-max samples of the same logits
    gum = sl.draw_gumbel(3)
    np.testing.assert_array_equal(
        zs.explore_actions(3, (gum[:, None],))[0][:, 0].numpy(),
        sl.explore_actions(3, gum).numpy())
