"""The zoo simulator's plain version (``repro_torch.memsim.batch``, what
a CPU tensor runs) against the JAX package's
``evaluate_population_bucketed`` on all 7 zoo graphs, with random tiers
in the padded slots: rectified tiers, eps and valid bit-equal, latency
and reward within 1e-6 relative; and graph by graph against the port's
single-graph simulator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.graphs import bucketed as jbucketed  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro.memsim import batch as jmb  # noqa: E402
from repro_torch import device as rdev  # noqa: E402
from repro_torch.graphs import bucketed, zoo  # noqa: E402
from repro_torch.memsim import batch as mb  # noqa: E402
from repro_torch.memsim import simulator as sim  # noqa: E402

REL = 1e-6
P = 3


def _maps(rng, gb):
    """Random tiers, the padded slots included; the first row all-VMEM
    (spills on byte-heavy graphs), the second all-HBM (never spills)."""
    maps = rng.integers(0, 3, (P, gb.n_graphs, gb.n_max, 2)).astype(np.int32)
    maps[0, :, :] = 2
    maps[1, :, :] = 0
    for i, n in enumerate(gb.sizes):
        maps[:2, i, n:] = rng.integers(0, 3, (2, gb.n_max - n, 2))
    return maps


@pytest.mark.parametrize("policy", ["auto", "off"])
def test_bucketed_evaluation_equals_jax(policy):
    names = list(zoo.WORKLOADS)
    bz = bucketed.build_bucketed_zoo([zoo.WORKLOADS[n]() for n in names],
                                     policy, device="cpu")
    jbz = jbucketed.build_bucketed_zoo([jzoo.WORKLOADS[n]() for n in names],
                                       policy)
    rng = np.random.default_rng(0)
    maps = [_maps(rng, gb) for gb in bz.buckets]
    rdev.reset_launch_counts()
    res = mb.evaluate_population_bucketed(
        bz, [torch.as_tensor(m) for m in maps])
    assert rdev.launch_counts()["memsim_zoo"] == 0     # CPU: plain version
    want = jmb.evaluate_population_bucketed(
        jbz, [jnp.asarray(m) for m in maps])
    for key in ("eps", "valid"):
        np.testing.assert_array_equal(res[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("latency", "reward", "speedup"):
        np.testing.assert_allclose(res[key].numpy(), np.asarray(want[key]),
                                   rtol=REL, atol=0, err_msg=key)
    for a, b in zip(res["rectified"], want["rectified"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert res["reward"].shape == (P, bz.n_graphs)
    assert bool((~res["valid"]).any()) and bool(res["valid"].any())
    # graph by graph: the single-graph simulator on the real rows
    for gi, name in enumerate(bz.names):
        k, s = bz.graph_bucket[gi], bz.graph_slot[gi]
        gb = bz.buckets[k]
        n = gb.sizes[s]
        one = sim.evaluate_population(
            sim.build_sim_graph(zoo.WORKLOADS[name](), "cpu"),
            torch.as_tensor(maps[k][:, s, :n]).contiguous(),
            float(gb.ref_latency[s]))
        for key in mb.SCALARS:
            assert torch.equal(one[key], res[key][:, gi]), (name, key)
        assert torch.equal(one["rectified"], res["rectified"][k][:, s, :n])
        assert not res["rectified"][k][:, s, n:].any()


def test_plain_pieces_and_aggregation_equal_jax():
    ours = [zoo.resnet50(), zoo.tiny_gpt()]
    gb = bucketed.build_bucketed_zoo(ours, "off", device="cpu").buckets[0]
    jgb = jbucketed.build_bucketed_zoo([jzoo.resnet50(), jzoo.tiny_gpt()],
                                       "off").buckets[0]
    rng = np.random.default_rng(1)
    m = rng.integers(0, 3, (2, gb.n_max, 2)).astype(np.int32)
    rect, eps = mb.rectify_zoo(gb, torch.as_tensor(m))
    jrect, jeps = jmb.rectify_zoo(jgb, jnp.asarray(m))
    np.testing.assert_array_equal(rect.numpy(), np.asarray(jrect))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    assert not rect[0, gb.sizes[0]:].any()
    np.testing.assert_allclose(mb.latency_zoo(gb, rect).numpy(),
                               np.asarray(jmb.latency_zoo(jgb, jrect)),
                               rtol=REL, atol=0)
    one = mb.evaluate_zoo(gb, torch.as_tensor(m))
    jone = jmb.evaluate_zoo(jgb, jnp.asarray(m))
    np.testing.assert_array_equal(one["eps"].numpy(), np.asarray(jone["eps"]))
    np.testing.assert_allclose(one["reward"].numpy(),
                               np.asarray(jone["reward"]), rtol=REL)
    # the bucketed forms over a one-bucket zoo
    bz, jbz = bucketed.BucketedZoo.from_batch(gb), \
        jbucketed.BucketedZoo.from_batch(jgb)
    rects, eps = mb.rectify_bucketed(bz, [torch.as_tensor(m)])
    jrects, jeps = jmb.rectify_bucketed(jbz, [jnp.asarray(m)])
    np.testing.assert_array_equal(rects[0].numpy(), np.asarray(jrects[0]))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(jeps))
    np.testing.assert_allclose(
        mb.latency_bucketed(bz, [torch.as_tensor(m)]).numpy(),
        np.asarray(jmb.latency_bucketed(jbz, [jnp.asarray(m)])), rtol=REL,
        atol=0)
    res = mb.evaluate_bucketed(bz, [torch.as_tensor(m)])
    jres = jmb.evaluate_bucketed(jbz, [jnp.asarray(m)])
    np.testing.assert_array_equal(res["valid"].numpy(),
                                  np.asarray(jres["valid"]))
    np.testing.assert_allclose(res["reward"].numpy(),
                               np.asarray(jres["reward"]), rtol=REL)
    # the mean of 5 rewards of order 1 sums in another f32 order: within
    # 1e-7 absolute; the minimum is exact
    rewards = rng.standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        mb.aggregate_rewards(torch.as_tensor(rewards), "mean").numpy(),
        np.asarray(jmb.aggregate_rewards(jnp.asarray(rewards), "mean")),
        rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        mb.aggregate_rewards(torch.as_tensor(rewards), "worst").numpy(),
        np.asarray(jmb.aggregate_rewards(jnp.asarray(rewards), "worst")))
    with pytest.raises(ValueError, match="mean"):
        mb.aggregate_rewards(torch.as_tensor(rewards), "median")


def test_input_checks():
    gb = bucketed.build_bucketed_zoo([zoo.resnet50(), zoo.mobilenet_v2()],
                                     "off", device="cpu").buckets[0]
    with pytest.raises(ValueError, match=r"\(P, G, N_max, 2\)"):
        mb.evaluate_population_zoo(gb, torch.zeros((2, gb.n_max, 2),
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="the batch is"):
        mb.evaluate_population_zoo(gb, torch.zeros(
            (1, gb.n_graphs, gb.n_max + 1, 2), dtype=torch.int32))
    bz = bucketed.BucketedZoo.from_batch(gb)
    with pytest.raises(ValueError, match="buckets"):
        mb.evaluate_population_bucketed(bz, [])
