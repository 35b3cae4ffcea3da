"""The port's padded multi-graph IR (``repro_torch.graphs.batch`` /
``bucketed``) and its copy of ``env_policy`` against the JAX package's:
every array of every bucket and every index map equal, bit for bit, for
the 7-graph zoo under the "auto", "off" and K = 2 policies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.graphs import batch as jbatch  # noqa: E402
from repro.graphs import bucketed as jbucketed  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro.utils.envpolicy import env_policy as jenv_policy  # noqa: E402
from repro_torch.graphs import batch, bucketed, zoo  # noqa: E402
from repro_torch.memsim.simulator import SimGraph  # noqa: E402
from repro_torch.utils.envpolicy import env_policy  # noqa: E402

NAMES = list(zoo.WORKLOADS)


def _same_batch(gb, jgb):
    """Every array of a port GraphBatch equals the JAX one exactly, dtype
    included."""
    for name in SimGraph._fields:
        a, b = getattr(gb.sim, name).numpy(), np.asarray(getattr(jgb.sim,
                                                               name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("node_mask", "n_nodes", "ref_latency", "feats", "adj"):
        a, b = getattr(gb, name).numpy(), np.asarray(getattr(jgb, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert gb.names == jgb.names
    assert (gb.n_graphs, gb.n_max, gb.w_max, gb.n_features) == \
        (jgb.n_graphs, jgb.n_max, jgb.w_max, jgb.n_features)
    assert gb.sizes == tuple(int(n) for n in np.asarray(jgb.n_nodes))


@pytest.fixture(scope="module")
def graphs():
    return ([f() for f in zoo.WORKLOADS.values()],
            [jzoo.WORKLOADS[n]() for n in NAMES])


@pytest.mark.parametrize("policy", ["auto", "off", 2])
def test_bucketed_zoo_equals_jax(graphs, policy):
    ours, theirs = graphs
    bz = bucketed.build_bucketed_zoo(ours, policy, device="cpu")
    jbz = jbucketed.build_bucketed_zoo(theirs, policy)
    assert bz.n_buckets == jbz.n_buckets == {"auto": 4, "off": 1, 2: 2}[
        policy]
    for gb, jgb in zip(bz.buckets, jbz.buckets):
        _same_batch(gb, jgb)
    assert (bz.graph_bucket, bz.graph_slot, bz.names) == \
        (jbz.graph_bucket, jbz.graph_slot, jbz.names)
    assert bz.bucket_sizes == jbz.bucket_sizes
    assert bz.node_slots == jbz.node_slots
    assert bz.n_eff == jbz.n_eff
    assert bz.real_sizes() == jbz.real_sizes()
    assert bz.pad_waste_frac() == jbz.pad_waste_frac()
    np.testing.assert_array_equal(bz.zoo_perm(), jbz.zoo_perm())
    # the round trip: per-bucket scalars to zoo order, zoo-order
    # mappings to per-bucket slices
    rng = np.random.default_rng(0)
    per = [rng.standard_normal((3, k)).astype(np.float32)
           for k in bz.bucket_sizes]
    np.testing.assert_array_equal(
        bz.gather_zoo([torch.as_tensor(x) for x in per]).numpy(),
        np.asarray(jbz.gather_zoo([jnp.asarray(x) for x in per])))
    n_max = max(gb.n_max for gb in bz.buckets)
    maps = rng.integers(0, 3, (2, bz.n_graphs, n_max, 2)).astype(np.int32)
    for a, b in zip(bz.split_zoo_mappings(torch.as_tensor(maps)),
                    jbz.split_zoo_mappings(jnp.asarray(maps))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_over_padded_batch_and_from_batch_equal_jax():
    ours = [zoo.resnet50(), zoo.tiny_gpt()]
    theirs = [jzoo.resnet50(), jzoo.tiny_gpt()]
    kw = dict(w_max=40, in_width=5, release_width=7)
    gb = batch.build_graph_batch(ours, 200, device="cpu", **kw)
    jgb = jbatch.build_graph_batch(theirs, 200, **kw)
    _same_batch(gb, jgb)
    assert gb.n_max == 200 and gb.w_max == 40
    assert gb.sim.in_acts.shape[-1] == 5 and gb.sim.release_idx.shape[-1] == 7
    one, jone = bucketed.BucketedZoo.from_batch(gb), \
        jbucketed.BucketedZoo.from_batch(jgb)
    assert one.buckets[0] is gb
    assert (one.graph_bucket, one.graph_slot, one.names) == \
        (jone.graph_bucket, jone.graph_slot, jone.names)
    # a padded slice is the graph's padded SimGraph
    sl, jsl = gb.graph_sim(1), jgb.graph_sim(1)
    for a, b in zip(sl, jsl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="n_max"):
        batch.build_graph_batch(ours, 100, device="cpu")


def test_assign_buckets_equals_jax():
    rng = np.random.default_rng(1)
    cases = [[57, 108, 388, 1043, 1010, 65, 123], [10, 10, 10], [5],
             [3, 7, 1000, 2000, 64]] + [
        list(rng.integers(2, 3000, rng.integers(1, 12))) for _ in range(20)]
    for sizes in cases:
        for policy in ("auto", "off", 1, 2, 3, 5, "4"):
            assert bucketed.assign_buckets(sizes, policy) == \
                jbucketed.assign_buckets(sizes, policy), (sizes, policy)


@pytest.mark.parametrize("value", ["auto", "off", "AUTO", " off ", 3, "7"])
def test_env_policy_resolves_like_jax(value, monkeypatch):
    kw = dict(choices=("auto", "off"), default="auto", int_ok=True)
    assert env_policy("X", override=value, **kw) == \
        jenv_policy("X", override=value, **kw)
    monkeypatch.setenv("REPRO_ZOO_BUCKETS", str(value))
    assert bucketed.resolve_bucket_policy() == \
        jbucketed.resolve_bucket_policy()
    kw = dict(choices=("off", "1"), default="off",
              int_prefixes=("thread",), int_ok=True)
    for v in ("1", "thread:4", "THREAD:2", 5):
        assert env_policy("Y", override=v, **kw) == \
            jenv_policy("Y", override=v, **kw)


@pytest.mark.parametrize("value", ["bogus", "0", -3, "thread:0", "thread:x",
                                   "1.5", ""])
def test_env_policy_raises_like_jax(value, monkeypatch):
    kw = dict(choices=("off", "auto"), default="auto", int_ok=True,
              int_prefixes=("thread",))
    with pytest.raises(ValueError) as ours:
        env_policy("REPRO_X", override=value, **kw)
    with pytest.raises(ValueError) as theirs:
        jenv_policy("REPRO_X", override=value, **kw)
    assert str(ours.value) == str(theirs.value)
    monkeypatch.setenv("REPRO_ZOO_BUCKETS", str(value))
    with pytest.raises(ValueError, match="REPRO_ZOO_BUCKETS"):
        bucketed.resolve_bucket_policy()
    with pytest.raises(ValueError, match="REPRO_ZOO_BUCKETS"):
        jbucketed.resolve_bucket_policy()


def test_autotune_builds_the_k_it_chose(monkeypatch):
    """A zoo built with "autotune" is bucketed by the K that
    ``autotune_bucket_k`` chose from its (here fixed) probe times."""
    from repro_torch.distributed import dispatch

    def probe(z, **kw):
        return {k: 0.5 + 2e-6 * b.n_graphs * b.n_max ** 2
                for k, b in enumerate(z.buckets)}
    monkeypatch.setattr(dispatch, "_probe_bucket_ms", probe)
    monkeypatch.setattr(dispatch, "_AUTOTUNE_CACHE", {})
    monkeypatch.setattr(dispatch, "_AUTOTUNE_REPORT", {})
    graphs = [zoo.resnet50(), zoo.mobilenet_v2(), zoo.tiny_gpt(), zoo.bert()]
    built = bucketed.build_bucketed_zoo(graphs, "autotune", device="cpu")
    k = dispatch.autotune_bucket_k(graphs, device="cpu")
    assign = bucketed.assign_buckets([g.n for g in graphs], k)
    assert built.graph_bucket == tuple(assign)
    assert built.n_buckets == max(assign) + 1
    report = dispatch.autotune_report(graphs, device="cpu")
    assert report["chosen_k"] == k and report["n_dev"] == 1
    with pytest.raises(ValueError, match="needs the graphs"):
        bucketed.assign_buckets([g.n for g in graphs], "autotune")
    with pytest.raises(ValueError, match="empty zoo"):
        bucketed.assign_buckets([], "auto")
