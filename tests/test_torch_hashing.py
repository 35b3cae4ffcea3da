"""The port's graph hashing (``graphs/hashing.py``) against the JAX
package's: canonical hashes and forms, WL sketches, sketch similarity and
``SketchIndex`` queries on extracted graphs, zoo graphs, random DAGs,
their relabelings and one-field perturbations.  The placement service's
cache keys and neighbour lookups depend on these being equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from repro.graphs import extract as jextract  # noqa: E402
from repro.graphs import graph as jgraph  # noqa: E402
from repro.graphs import hashing as jhashing  # noqa: E402
from repro.graphs import zoo as jzoo  # noqa: E402
from repro_torch.graphs import extract, graph, hashing, zoo  # noqa: E402

EXTRACTED = [("qwen3-0.6b", "decode_32k"), ("zamba2-1.2b", "train_4k"),
             ("seamless-m4t-medium", "prefill_32k"),
             ("llama4-maverick-400b-a17b", "decode_32k")]
ZOO = ["resnet50", "bert", "mobilenet_v2", "tiny_gpt"]


def _to_jax(g):
    """The same graph built from the JAX package's classes."""
    return jgraph.WorkloadGraph(
        g.name, [jgraph.Node(**dataclasses.asdict(nd)) for nd in g.nodes],
        list(g.edges))


def _random_dag(seed):
    """Random topo-ordered DAG with distinct node payloads."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 25))
    nodes = [graph.Node(op=graph.OP_TYPES[int(rng.integers(
        len(graph.OP_TYPES)))],
        weight_bytes=float((i + 1) * 1024 + rng.integers(512)),
        ofm=(1, 1, int(rng.integers(1, 64))),
        flops=float(rng.integers(1, 10 ** 6))) for i in range(n)]
    edges = sorted({(int(s), d) for d in range(1, n) for s in rng.choice(
        d, size=min(d, int(rng.integers(1, 3))), replace=False)})
    return graph.WorkloadGraph("rand", nodes, edges)


def _relabel(g, seed):
    """The same DAG under a random linear extension of its order."""
    rng = np.random.default_rng(seed)
    preds = [[] for _ in range(g.n)]
    succs = [[] for _ in range(g.n)]
    for s, d in g.edges:
        preds[d].append(s)
        succs[s].append(d)
    indeg = [len(p) for p in preds]
    ready = [i for i in range(g.n) if indeg[i] == 0]
    order = []
    while ready:
        i = ready.pop(int(rng.integers(len(ready))))
        order.append(i)
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    inv = {old: new for new, old in enumerate(order)}
    return graph.WorkloadGraph(
        g.name, [g.nodes[i] for i in order],
        sorted((inv[s], inv[d]) for s, d in g.edges))


def _perturb(g, field, i=None):
    """One field of one node changed, as the simulator would see it."""
    i = g.n // 2 if i is None else i
    nd = g.nodes[i]
    new = {"weight_bytes": dict(weight_bytes=nd.weight_bytes + 1.0),
           "flops": dict(flops=nd.flops * 2 + 1.0),
           "ofm": dict(ofm=(nd.ofm[0], nd.ofm[1], nd.ofm[2] + 1)),
           "weight_access_frac": dict(
               weight_access_frac=nd.weight_access_frac / 2),
           "batch": dict(batch=nd.batch + 1)}[field]
    nodes = list(g.nodes)
    nodes[i] = dataclasses.replace(nd, **new)
    return dataclasses.replace(g, nodes=nodes)


def _graphs():
    out = [extract.extract_for(a, s) for a, s in EXTRACTED]
    out += [zoo.WORKLOADS[n]() for n in ZOO]
    out += [_random_dag(seed) for seed in range(4)]
    out += [_relabel(_random_dag(seed), seed + 100) for seed in range(4)]
    out += [_perturb(out[0], f) for f in ("weight_bytes", "flops", "ofm",
                                          "weight_access_frac", "batch")]
    dropped = out[-1]
    out.append(dataclasses.replace(dropped, edges=dropped.edges[:-1]))
    return out


GRAPHS = _graphs()


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_hash_form_and_sketch_equal_jax(i):
    g = GRAPHS[i]
    r = _to_jax(g)
    assert hashing.canonical_form(g) == jhashing.canonical_form(r)
    assert hashing.canonical_hash(g) == jhashing.canonical_hash(r)
    assert g.canonical_hash() == r.canonical_hash()
    assert hashing.wl_sketch(g) == jhashing.wl_sketch(r)
    assert hashing.wl_sketch(g, slots=3) == jhashing.wl_sketch(r, slots=3)


def test_extracted_hashes_equal_jax_extraction():
    for a, s in EXTRACTED:
        assert extract.extract_for(a, s).canonical_hash() == \
            jextract.extract_for(a, s).canonical_hash()
    for n in ZOO:
        assert zoo.WORKLOADS[n]().canonical_hash() == \
            jzoo.WORKLOADS[n]().canonical_hash()


def test_relabeling_keeps_and_perturbation_changes_the_hash():
    for seed in range(4):
        g = _random_dag(seed)
        assert _relabel(g, seed + 7).canonical_hash() == g.canonical_hash()
    base = GRAPHS[0]
    for f in ("weight_bytes", "flops", "ofm", "weight_access_frac",
              "batch"):
        assert _perturb(base, f).canonical_hash() != base.canonical_hash()


def test_similarity_and_index_queries_equal_jax():
    sigs = {f"g{i}": hashing.wl_sketch(g) for i, g in enumerate(GRAPHS)}
    mine, ref = hashing.SketchIndex(), jhashing.SketchIndex()
    for k, sig in sigs.items():
        group = hashing.canonical_hash(GRAPHS[int(k[1:])])[:1]
        mine.add(k, sig, group=group)
        ref.add(k, sig, group=group)
    assert mine.items() == ref.items() and len(mine) == len(ref)
    probes = [hashing.wl_sketch(_perturb(g, "weight_bytes", 1))
              for g in GRAPHS[:8]] + list(sigs.values())
    for p in probes:
        for k, sig in sigs.items():
            assert hashing.sketch_similarity(p, sig) == \
                jhashing.sketch_similarity(p, sig)
        for group in {hashing.canonical_hash(g)[:1] for g in GRAPHS}:
            for excl in ((), tuple(sigs)[:3]):
                assert mine.query(p, group=group, exclude=excl) == \
                    ref.query(p, group=group, exclude=excl)
    assert hashing.sketch_similarity((), ()) == 0.0
    assert hashing.sketch_similarity((1, 2), (1,)) == 0.0


def test_near_neighbour_found_and_far_graph_not():
    g = GRAPHS[0]
    idx = hashing.SketchIndex()
    idx.add("base", hashing.wl_sketch(g), group=256)
    near = hashing.wl_sketch(_perturb(g, "weight_bytes", 3))
    key, sim = idx.query(near, group=256)
    assert key == "base" and sim > 0.4
    assert idx.query(near, group=128) == (None, 0.0)
    far = hashing.wl_sketch(zoo.resnet50())
    assert idx.query(far, group=256)[1] < 0.4
