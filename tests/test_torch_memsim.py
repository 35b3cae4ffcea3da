"""The port's simulator (plain version, CPU) against the JAX package:
rectified tiers and eps bit-equal to the numpy oracle
``repro.memsim.reference.rectify_np`` on every zoo graph, latency and
reward equal to the JAX ``evaluate_population`` within 1e-6 rel (bit
equality is what the float order aims at, and what it reaches today)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.graphs import zoo as jzoo  # noqa: E402
from repro.memsim import compiler as jcompiler  # noqa: E402
from repro.memsim import reference as jref  # noqa: E402
from repro.memsim import simulator as jsim  # noqa: E402
from repro_torch.graphs import zoo  # noqa: E402
from repro_torch.memsim import compiler, simulator as sim  # noqa: E402

GRAPHS = sorted(zoo.WORKLOADS)
REL = 1e-6


def _mappings(g, seed=0):
    """2 random mappings, the compiler's heuristic, all-HBM and
    all-fastest-tier (which spills)."""
    rng = np.random.default_rng(seed)
    maps = [rng.integers(0, 3, (g.n, 2)).astype(np.int32) for _ in range(2)]
    maps += [compiler.heuristic_mapping(g), np.zeros((g.n, 2), np.int32),
             np.full((g.n, 2), 2, np.int32)]
    return np.stack(maps)


@pytest.fixture(scope="module", params=GRAPHS)
def case(request):
    name = request.param
    g, jg = zoo.WORKLOADS[name](), jzoo.WORKLOADS[name]()
    return name, g, jg, sim.build_sim_graph(g), jsim.build_sim_graph(jg)


def test_zoo_copies_match_reference(case):
    _, g, jg, sg, jsg = case
    assert g.n == jg.n and g.edges == jg.edges
    np.testing.assert_array_equal(g.features(), jg.features())
    for field in jsim.SimGraph._fields:
        np.testing.assert_array_equal(getattr(sg, field).numpy(),
                                      np.asarray(getattr(jsg, field)),
                                      err_msg=field)


def test_rectify_bit_equal_to_oracle(case):
    name, g, _, sg, jsg = case
    maps = _mappings(g)
    rect, eps = sim.rectify(sg, torch.as_tensor(maps))
    assert rect.dtype == torch.int32 and eps.dtype == torch.float32
    for i, m in enumerate(maps):
        r_ref, e_ref = jref.rectify_np(jsg, m)
        np.testing.assert_array_equal(rect[i].numpy(), r_ref, err_msg=name)
        assert eps[i].numpy().tobytes() == np.float32(e_ref).tobytes(), name
    # the all-fast mapping overflows the fast tiers on the big graphs
    if name in ("bert", "moe_transformer", "dense_cnn"):
        assert float(eps[-1]) > 0.0


def test_evaluate_population_matches_jax(case):
    name, g, jg, sg, jsg = case
    maps = _mappings(g, seed=1)
    _, ref = compiler.compiler_reference(g, "cpu")
    _, jref_lat = jcompiler.compiler_reference(jg)
    assert np.float32(ref) == np.float32(jref_lat)
    res = sim.evaluate_population(sg, torch.as_tensor(maps), ref)
    jres = jsim.evaluate_population(jsg, jnp.asarray(maps),
                                    jnp.float32(jref_lat))
    np.testing.assert_array_equal(res["rectified"].numpy(),
                                  np.asarray(jres["rectified"]))
    np.testing.assert_array_equal(res["eps"].numpy(),
                                  np.asarray(jres["eps"]))
    np.testing.assert_array_equal(res["valid"].numpy(),
                                  np.asarray(jres["valid"]))
    for k in ("latency", "reward", "speedup"):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]),
                                   rtol=REL, atol=0, err_msg=k)


def test_latency_matches_jax_on_unrectified_mappings(case):
    _, g, _, sg, jsg = case
    maps = _mappings(g, seed=2)
    lat = sim.latency(sg, torch.as_tensor(maps))
    for i, m in enumerate(maps):
        j = float(jsim.latency(jsg, jnp.asarray(m)))
        assert float(lat[i]) == pytest.approx(j, rel=REL)
    # one (N, 2) mapping gives a scalar
    assert sim.latency(sg, torch.as_tensor(maps[0])).dim() == 0


@pytest.mark.parametrize("name", ["resnet50", "bert", "dense_cnn"])
def test_compiler_reference_matches_jax(name):
    rect, lat = compiler.compiler_reference(zoo.WORKLOADS[name](), "cpu")
    jrect, jlat = jcompiler.compiler_reference(jzoo.WORKLOADS[name]())
    np.testing.assert_array_equal(rect, jrect)
    assert lat == pytest.approx(jlat, rel=REL)
    np.testing.assert_array_equal(
        compiler.heuristic_mapping(zoo.WORKLOADS[name]()),
        jcompiler.heuristic_mapping(jzoo.WORKLOADS[name]()))


def test_evaluate_single_mapping_and_input_checks():
    g = zoo.resnet50()
    sg = sim.build_sim_graph(g)
    _, ref = compiler.compiler_reference(g, "cpu")
    m = torch.as_tensor(compiler.heuristic_mapping(g))
    one = sim.evaluate(sg, m, ref)
    assert one["reward"].dim() == 0 and one["rectified"].shape == (g.n, 2)
    assert float(one["speedup"]) == pytest.approx(1.0, rel=REL)
    with pytest.raises(ValueError, match="nodes"):
        sim.evaluate_population(sg, m[None, :10], ref)
    with pytest.raises(ValueError, match=r"\(P, N, 2\)"):
        sim.evaluate_population(sg, m, ref)


@pytest.mark.parametrize("name,kwargs", [("resnet50", {"passes": 1}),
                                         ("bert", {"budget": 72})])
def test_greedy_dp_matches_jax(name, kwargs):
    """Same mapping and history iterations as JAX's greedy_dp, rewards
    within 1e-6 rel: the simulator agrees, so every argmax does too.
    BERT stops at a budget of 72 candidates (8 nodes)."""
    mapping, hist = compiler.greedy_dp(zoo.WORKLOADS[name](), device="cpu",
                                       **kwargs)
    jmapping, jhist = jcompiler.greedy_dp(jzoo.WORKLOADS[name](), **kwargs)
    assert mapping.dtype == np.int32
    np.testing.assert_array_equal(mapping, jmapping)
    assert [it for it, _ in hist] == [it for it, _ in jhist]
    np.testing.assert_allclose([r for _, r in hist], [r for _, r in jhist],
                               rtol=REL, atol=0)
    # the search moved off all-HBM
    assert (mapping != 0).any()
