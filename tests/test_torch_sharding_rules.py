"""The port's sharding plan and layouts against the JAX package's:
``distributed/rules.py`` ``make_plan``, ``utils/params.py``
``make_specs`` / ``validate_divisibility``, ``training/optimizers.py``
``state_specs``, ``distributed/parallel.py`` ``shard_tree`` and
``checkpoint/manager.py`` ``restore(mesh=, specs=)``.

The plans are compared for every registry arch (and its smoke config)
at every shape it supports, on both production meshes and on (2, 2),
(1, 4), (4, 1), (2, 1, 2) and (3, 2) (which divides no width): JAX's
on the fake mesh of ``tests/test_sharding_rules.py``, the port's on ``launch.mesh.Mesh`` over
a repeated ``"cpu"``.  The shards are compared with the slices a
``NamedSharding`` of the same spec gives each device, in a JAX
subprocess with 8 forced host devices; the port's rank r stands where
that mesh has its r-th device in row-major order (one process per
card).  A ``ProcessMesh`` of one rank needs no process group, so every
rank's view is built here in one process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke  # noqa: E402
from repro.distributed.rules import make_plan as jax_plan  # noqa: E402
from repro.launch.programs import cache_specs as jax_cache_specs  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.training import optimizers as jopt  # noqa: E402
from repro.utils.params import make_specs as jax_specs  # noqa: E402
from repro.utils.params import (  # noqa: E402
    validate_divisibility as jax_validate)
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs.base import (SHAPES, ShapeCfg,  # noqa: E402
                                      supports_shape)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          smoke_config)
from repro_torch.data.pipeline import device_batch  # noqa: E402
from repro_torch.distributed import parallel as par  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import (ProcessMesh, make_mesh,  # noqa: E402
                                     make_process_mesh, make_production_mesh)
from repro_torch.launch.programs import (batch_specs,  # noqa: E402
                                         cache_specs, local_cache_struct)
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training import optimizers as opt  # noqa: E402
from repro_torch.utils.params import PartitionSpec as P  # noqa: E402
from repro_torch.utils.params import (make_specs,  # noqa: E402
                                      tree_leaves, validate_divisibility)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
          ((3, 2), ("data", "model"))]   # 3 divides no width: problems
FIELDS = ("rules", "batch_axes", "seq_axes", "shard_heads", "kv_ok",
          "cache_batch", "cache_seq", "cache_kv", "data_axes", "resid_seq",
          "model_axis")


class _FakeMesh:
    """tests/test_sharding_rules.py's static stand-in."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _grid(arch):
    """(port cfg, JAX cfg, shape name, mesh shape, axes) over both the
    published and the smoke config."""
    for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                      (smoke_config(get_config(arch)),
                       jax_smoke(jax_config(arch)))):
        for name, shape in SHAPES.items():
            if not supports_shape(cfg, shape)[0]:
                continue
            for mshape, axes in MESHES:
                yield cfg, jcfg, name, mshape, axes


def _plans(cfg, jcfg, name, mshape, axes):
    mesh = make_mesh(mshape, axes, ["cpu"] * int(np.prod(mshape)))
    return (make_plan(cfg, mesh, SHAPES[name]),
            jax_plan(jcfg, _FakeMesh(mshape, axes), JAX_SHAPES[name]))


def _jax_flat(tree):
    import jax
    from repro.utils.params import is_def
    return {".".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: is_def(x) or isinstance(
                    x, jax.sharding.PartitionSpec))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_jax(arch):
    """Every field of the plan but the mesh, per (config, shape, mesh)."""
    n = 0
    for cfg, jcfg, name, mshape, axes in _grid(arch):
        got, want = _plans(cfg, jcfg, name, mshape, axes)
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (
                arch, cfg.n_layers, name, mshape, f)
        assert got.model_size == mshape[-1]
        n += 1
    assert n >= 2 * 3 * len(MESHES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_divisibility_match_jax(arch):
    """``make_specs`` leaf by leaf (``tuple`` of the spec) and
    ``validate_divisibility``'s problems, in order; the published configs
    divide on both production meshes, as JAX's own test asserts."""
    problems = 0
    for cfg, jcfg, name, mshape, axes in _grid(arch):
        got, want = _plans(cfg, jcfg, name, mshape, axes)
        defs, jdefs = get_model(cfg).param_defs(), jax_model(jcfg).param_defs()
        specs = dict(tree_leaves(make_specs(defs, got.rules)))
        jspecs = _jax_flat(jax_specs(jdefs, want.rules))
        assert set(specs) == set(jspecs)
        for k, s in specs.items():
            assert isinstance(s, P)
            assert tuple(s) == tuple(jspecs[k]), (arch, name, mshape, k)
        sizes = dict(zip(axes, mshape))
        p = validate_divisibility(defs, got.rules, sizes)
        assert p == jax_validate(jdefs, want.rules, sizes), (arch, name,
                                                             mshape)
        if mshape[-1] == 16 and cfg.d_model != 64:
            assert not p, (arch, name, mshape, p[:3])
        problems += len(p)
    assert problems > 0      # the (3, 2) mesh: the lists compared are full


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch):
    """``launch/programs.py`` ``cache_specs`` leaf by leaf against JAX's
    ``launch/programs.py`` ``cache_specs``, per (config, shape, mesh),
    and ``batch_specs`` against the specs JAX's attaches."""
    n = 0
    for cfg, jcfg, name, mshape, axes in _grid(arch):
        got, want = _plans(cfg, jcfg, name, mshape, axes)
        cs = cache_specs(get_model(cfg), cfg, got)
        jcs = jax_cache_specs(jax_model(jcfg), jcfg, want)
        bs = batch_specs(cfg, SHAPES[name], got)
        for k in bs:
            assert tuple(bs[k]) == tuple(JaxP(want.batch_axes, None,
                                              *([None] * (k == "enc_emb"))))
        assert set(cs) == set(jcs)
        for k, s in cs.items():
            assert isinstance(s, P)
            assert tuple(s) == tuple(jcs[k]), (arch, name, mshape, k)
        n += 1
    assert n >= 2 * 3 * len(MESHES)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_state_specs_match_jax(arch, opt_name):
    """``state_specs`` mirrors the parameters' specs as JAX's does
    (``tests/test_optimizers.py::test_state_specs_mirror_param_specs``):
    AdamW's m and v, Adafactor's vr / vc of the factored leaves and v of
    the others, and the replicated step."""
    ocfg = opt.OptConfig(name=opt_name)
    jocfg = jopt.OptConfig(name=opt_name)
    for cfg, jcfg, name, mshape, axes in _grid(arch):
        if name != "train_4k" or mshape not in ((16, 16), (2, 2)):
            continue
        got, want = _plans(cfg, jcfg, name, mshape, axes)
        defs, jdefs = get_model(cfg).param_defs(), jax_model(jcfg).param_defs()
        ss = opt.state_specs(opt_name, ocfg, make_specs(defs, got.rules),
                             defs)
        jss = jopt.state_specs(opt_name, jocfg, jax_specs(jdefs, want.rules),
                               jdefs)
        assert tuple(ss.pop("step")) == tuple(jss.pop("step")) == ()
        flat, jflat = dict(tree_leaves(ss)), _jax_flat(jss)
        assert set(flat) == set(jflat)
        for k, s in flat.items():
            assert tuple(s) == tuple(jflat[k]), (arch, mshape, k)


# ------------------------------------------------- shards against JAX
SHARD_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                ((4, 1), ("data", "model")),
                ((2, 1, 2), ("pod", "data", "model")),
                ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data",
                                                          "model"))]
SPECS2 = [("data", "model"), ("model", None, "data"), (("data", "model"),),
          (None, ("model", "data")), (None, None, "model"), ()]
SPECS3 = [(("pod", "data"), "model"), ("model", ("data", "pod")),
          (None, ("pod", "model"), "data"), ("pod",)]
ARRAY_SHAPE = (8, 16, 16)


def _specs_for(axes):
    return SPECS2 + (SPECS3 if "pod" in axes else [])


# the serving caches of every arch's smoke config on each shard mesh, a
# batch of 1 (the sequence cut over the spare data axes too) and of 4
CACHE_BATCHES, CACHE_LEN = (1, 4), 32


def _cache_cases():
    """[(mesh index, arch, batch, leaf, spec, global shape)]."""
    out = []
    for m, (mshape, axes) in enumerate(SHARD_MESHES):
        mesh = make_mesh(mshape, axes, ["cpu"] * int(np.prod(mshape)))
        for arch in ARCH_IDS:
            cfg = smoke_config(get_config(arch))
            for b in CACHE_BATCHES:
                plan = make_plan(cfg, mesh, ShapeCfg("serve", CACHE_LEN, b,
                                                       "decode"))
                model = get_model(cfg)
                cs = cache_specs(model, cfg, plan)
                for k, st in model.cache_struct(b, CACHE_LEN).items():
                    out.append((m, arch, b, k, tuple(cs[k]), st.shape))
    return out


CACHE_CASES = _cache_cases()


def _rank_mesh(mshape, axes, rank):
    return ProcessMesh(axes, np.arange(int(np.prod(mshape))).reshape(mshape),
                       rank=rank)


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """From a JAX subprocess with 8 host devices: per (mesh, spec), each
    mesh position's slice of a ``NamedSharding``; and the elastic-restore
    case of ``test_distributed.py``: a tree saved sharded on (4, 2),
    restored by JAX onto (2, 4), each device's values."""
    d = str(tmp_path_factory.mktemp("elastic"))
    code = f"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import manager as ckpt
out = {{"slices": []}}
x = np.zeros({ARRAY_SHAPE!r}, np.float32)
for mshape, axes in {SHARD_MESHES!r}:
    n = int(np.prod(mshape))
    mesh = jax.make_mesh(mshape, axes, devices=jax.devices()[:n])
    for spec in (({SPECS2!r}) + (({SPECS3!r}) if "pod" in axes else [])):
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(x.shape)
        out["slices"].append([[[s.start or 0, s.stop or x.shape[i]]
                               for i, s in enumerate(idx[dev])]
                              for dev in mesh.devices.flat])
out["cache"] = []
for m, spec, shape in {[(c[0], [list(e) if isinstance(e, tuple) else e for e in c[4]], list(c[5])) for c in CACHE_CASES]!r}:
    mshape, axes = {SHARD_MESHES!r}[m]
    mesh = jax.make_mesh(mshape, axes,
                         devices=jax.devices()[:int(np.prod(mshape))])
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out["cache"].append([[(s.stop or shape[i]) - (s.start or 0)
                          for i, s in enumerate(idx[dev])]
                         for dev in mesh.devices.flat])
tree = {{"w": jnp.arange(64.0).reshape(8, 8)}}
m1 = jax.make_mesh((4, 2), ("data", "model"))
t1 = {{"w": jax.device_put(tree["w"], NamedSharding(m1, P("data", "model")))}}
ckpt.save({d!r}, 1, t1)
m2 = jax.make_mesh((2, 4), ("data", "model"))
r = ckpt.restore({d!r}, 1, tree, mesh=m2, specs={{"w": P("data", "model")}})
by_dev = {{s.device: np.asarray(s.data).tolist()
          for s in r["w"].addressable_shards}}
out["elastic"] = [by_dev[dev] for dev in m2.devices.flat]
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), d


@pytest.mark.parametrize("m", range(len(SHARD_MESHES)),
                         ids=["x".join(map(str, s)) for s, _ in SHARD_MESHES])
def test_shards_match_named_sharding(jax_shards, m):
    """Each rank's ``shard_tree`` block of an arange is the slice JAX's
    ``NamedSharding`` gives the device at that mesh position, for specs
    with single axes, tuples of axes in either order and replicated
    dims; ``device_batch`` takes the rows of ``P(batch_axes)``."""
    want = jax_shards[0]["slices"]
    start = sum(len(_specs_for(a)) for _, a in SHARD_MESHES[:m])
    mshape, axes = SHARD_MESHES[m]
    full = torch.arange(float(np.prod(ARRAY_SHAPE))).reshape(ARRAY_SHAPE)
    for j, spec in enumerate(_specs_for(axes)):
        for r, sl in enumerate(want[start + j]):
            mesh = _rank_mesh(mshape, axes, r)
            got = par.shard_tree({"x": full}, {"x": P(*spec)}, mesh)["x"]
            exp = full[tuple(slice(a, b) for a, b in sl)]
            assert torch.equal(got, exp), (mshape, spec, r)
            assert par.global_shape(got.shape, P(*spec), mesh) == ARRAY_SHAPE
            if spec and isinstance(spec[0], (str, tuple)):
                rows = device_batch({"x": full.numpy()}, "cpu", mesh,
                                    spec[0])["x"]
                assert torch.equal(rows, full[slice(*sl[0])])


def test_local_cache_struct_matches_named_sharding(jax_shards):
    """Each rank's ``local_cache_struct`` leaf shape is the shape of the
    slice a ``NamedSharding`` of the leaf's cache spec gives the device
    at that mesh position, for every arch's smoke config on each shard
    mesh at a batch of 1 and of 4."""
    want = jax_shards[0]["cache"]
    assert len(want) == len(CACHE_CASES)
    for (m, arch, b, leaf, _, _), shapes in zip(CACHE_CASES, want):
        mshape, axes = SHARD_MESHES[m]
        cfg = smoke_config(get_config(arch))
        for r, shape in enumerate(shapes):
            mesh = _rank_mesh(mshape, axes, r)
            plan = make_plan(cfg, mesh, ShapeCfg("serve", CACHE_LEN, b,
                                                   "decode"))
            got = local_cache_struct(get_model(cfg), plan, b, CACHE_LEN)
            assert got[leaf].shape == tuple(shape), (arch, mshape, b, leaf,
                                                     r)


def test_restore_matches_jax_elastic_case(jax_shards):
    """``test_distributed.py::test_elastic_restore_across_mesh_shapes``:
    the tree JAX saved sharded on (4, 2) restores in the port onto
    (2, 4), each rank holding the values JAX's restore gives the device
    at that position, and onto (1, 1), whole."""
    want, d = jax_shards[0]["elastic"], jax_shards[1]
    specs = {"w": P("data", "model")}
    for r, vals in enumerate(want):
        mesh = _rank_mesh((2, 4), ("data", "model"), r)
        got = ckpt.restore(d, 1, {"w": torch.zeros(4, 2)}, mesh=mesh,
                           specs=specs)
        assert torch.equal(got["w"], torch.tensor(vals))
    one = make_process_mesh((1, 1), ("data", "model"), "cpu")
    got = ckpt.restore(d, 1, {"w": torch.zeros(8, 8)}, mesh=one, specs=specs)
    assert torch.equal(got["w"], torch.arange(64.0).reshape(8, 8))
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(d, 1, {"w": torch.zeros(8, 8)},
                     mesh=_rank_mesh((2, 4), ("data", "model"), 0),
                     specs=specs)


def test_process_mesh_layout_and_size_check():
    """A world of one process without a process group: the (1, 1) mesh,
    its rank and device; any other size raises before anything is
    placed, naming the launcher."""
    m = make_process_mesh((1, 1), ("data", "model"), "cpu")
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    assert m.groups == {} and m.device == torch.device("cpu")
    assert m.coords == {"data": 0, "model": 0}
    for shape in ((2, 4), (16, 16)):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            make_process_mesh(shape, ("data", "model"), "cpu")
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="needs (256|512) process"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    r = _rank_mesh((2, 1, 2), ("pod", "data", "model"), 3)
    assert r.coords == {"pod": 1, "data": 0, "model": 1}
