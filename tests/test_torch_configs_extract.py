"""The port's model configs (all ten registry ids) and graph extraction
(``graphs/extract.py``) against the JAX package's: every config field by
field, every (arch, shape) cell's graph node by node, with equal
canonical hashes, and the same ``KeyError``s for what neither serves."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.graphs import extract as jextract  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.graphs import extract  # noqa: E402

CELLS = list(jregistry.all_cells(include_skipped=True))


def _fields(x):
    """A config as plain data: nested dataclasses as dicts."""
    return dataclasses.asdict(x) if x is not None else None


@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_config_equals_jax_field_by_field(arch):
    mine, ref = registry.get_config(arch), jregistry.get_config(arch)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert _fields(mine) == _fields(ref)
    assert mine.vocab_padded == ref.vocab_padded
    assert mine.q_per_kv == ref.q_per_kv
    assert _fields(base.smoke_config(mine)) == \
        _fields(jbase.smoke_config(ref))


def test_registry_and_shapes_equal_jax():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert base.SUBQUADRATIC_FAMILIES == jbase.SUBQUADRATIC_FAMILIES
    assert list(registry.all_cells(include_skipped=True)) == CELLS
    assert list(registry.all_cells()) == list(jregistry.all_cells())
    for name in base.SHAPES:
        assert dataclasses.asdict(registry.get_shape(name)) == \
            dataclasses.asdict(jregistry.get_shape(name))


def _assert_graphs_equal(g, r):
    assert g.name == r.name and g.n == r.n
    assert list(g.edges) == list(r.edges)
    for a, b in zip(g.nodes, r.nodes):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.ifm_bytes, a.ofm_bytes) == (b.ifm_bytes, b.ofm_bytes)
    ga, ra = g.arrays(), r.arrays()
    assert set(ga) == set(ra)
    for k in ga:
        if k == "producers_of":
            assert ga[k] == ra[k]
        else:
            np.testing.assert_array_equal(ga[k], ra[k])
    assert g.ring_width() == r.ring_width()
    np.testing.assert_array_equal(g.features(), r.features())
    np.testing.assert_array_equal(g.adjacency(), r.adjacency())
    assert g.canonical_hash() == r.canonical_hash()


@pytest.mark.parametrize("arch,shape,ok,why", CELLS,
                         ids=[f"{a}-{s}" for a, s, _, _ in CELLS])
def test_extract_for_equals_jax(arch, shape, ok, why):
    if not ok:
        with pytest.raises(KeyError, match=shape) as mine:
            extract.extract_for(arch, shape)
        with pytest.raises(KeyError) as ref:
            jextract.extract_for(arch, shape)
        assert str(mine.value) == str(ref.value)
        return
    _assert_graphs_equal(extract.extract_for(arch, shape),
                         jextract.extract_for(arch, shape))


@pytest.mark.parametrize("name", ["resnet50", "bert"])
def test_paper_workloads_resolve_through_the_zoo(name):
    _assert_graphs_equal(extract.extract_for(name, "ignored"),
                         jextract.extract_for(name, "ignored"))


@pytest.mark.parametrize("arch,shape", [("no-such-arch", "decode_32k"),
                                        ("qwen3-0.6b", "decode_1k")])
def test_unknown_ids_raise_as_in_jax(arch, shape):
    with pytest.raises(KeyError) as mine:
        extract.extract_for(arch, shape)
    with pytest.raises(KeyError) as ref:
        jextract.extract_for(arch, shape)
    assert str(mine.value) == str(ref.value)
    if arch == "no-such-arch":
        with pytest.raises(KeyError, match="unknown arch"):
            registry.get_config(arch)


def test_extract_graph_unsharded_equals_jax():
    """The per-chip division of ``extract_graph`` and the graph before it,
    on a mesh other than the default."""
    cfg, ref_cfg = registry.get_config("zamba2-1.2b"), \
        jregistry.get_config("zamba2-1.2b")
    for shape in ("train_4k", "decode_32k"):
        _assert_graphs_equal(
            extract._extract_unsharded(cfg, base.SHAPES[shape]),
            jextract._extract_unsharded(ref_cfg, jbase.SHAPES[shape]))
        _assert_graphs_equal(
            extract.extract_graph(cfg, base.SHAPES[shape], mesh_data=4,
                                  mesh_model=8),
            jextract.extract_graph(ref_cfg, jbase.SHAPES[shape],
                                   mesh_data=4, mesh_model=8))
