"""The port's checkpoint manager against the JAX package's: a directory
either one writes has the same keys, manifest and checksum, verifies and
restores in the other; keep-N and corruption behave the same."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jckpt  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402


def _tree(seed=0):
    """Nested dicts and lists of 32-bit numpy arrays (JAX holds no 64-bit
    ones by default), as the placement service stores them: int32
    mappings, an f32 prior."""
    rng = np.random.default_rng(seed)
    return {
        "maps": {f"{h:064x}": rng.integers(0, 3, (7 + h, 2)).astype(np.int32)
                 for h in (3, 1, 2)},
        "prior": rng.normal(size=50).astype(np.float32),
        "opt": [{"m": rng.normal(size=(2, 3)).astype(np.float32),
                 "t": np.int32(5)}, rng.normal(size=4).astype(np.float32)],
        "skip": None,
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return None if tree is None else torch.as_tensor(np.asarray(tree))


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    return None if tree is None else jnp.asarray(tree)


def _jax_to_np(tree):
    if isinstance(tree, dict):
        return {k: _jax_to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_to_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    elif want is None:
        assert got is None
    else:
        a = got.cpu().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        b = np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_same_layout_and_checksum(tmp_path):
    tree = _tree()
    mine = ckpt.save(str(tmp_path / "torch"), 3, _as_torch(tree),
                     extra={"k": [1, 2]})
    ref = jckpt.save(str(tmp_path / "jax"), 3, _as_jax(tree),
                     extra={"k": [1, 2]})
    assert _manifest(mine) == _manifest(ref)
    assert os.path.basename(mine) == os.path.basename(ref) == "step_00000003"
    assert sorted(np.load(os.path.join(mine, "arrays.npz")).files) == \
        sorted(np.load(os.path.join(ref, "arrays.npz")).files)
    assert ckpt.SEP == jckpt.SEP


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(1)
    d = str(tmp_path)
    path = jckpt.save(d, 7, _as_jax(tree), extra={"note": "jax"})
    assert ckpt.verify(path)
    assert ckpt.latest_step(d) == 7 and ckpt.all_steps(d) == [7]
    got = ckpt.restore(d, 7, _as_torch(tree))
    _assert_tree_equal(got, tree)
    assert isinstance(got["prior"], torch.Tensor)
    assert ckpt.load_manifest(d, 7)["extra"] == {"note": "jax"}
    _assert_tree_equal(ckpt.restore(d, 7, tree), tree)     # numpy leaves


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _tree(2)
    d = str(tmp_path)
    path = ckpt.save(d, 2, _as_torch(tree))
    assert jckpt.verify(path)
    got = jckpt.restore(d, 2, _as_jax(tree))
    _assert_tree_equal(_jax_to_np(got), tree)


def test_keep_n_and_corruption_as_in_jax(tmp_path):
    for mod, name in ((ckpt, "torch"), (jckpt, "jax")):
        d = str(tmp_path / name)
        for step in range(1, 6):
            mod.save(d, step, {"x": np.full(3, step, np.float32)}, keep=2)
        assert mod.all_steps(d) == [4, 5]
        path = os.path.join(d, "step_00000005", "arrays.npz")
        with open(path, "r+b") as f:
            f.seek(60)
            f.write(b"\xff\xff")
    for mod in (ckpt, jckpt):
        for name in ("torch", "jax"):
            d = str(tmp_path / name)
            assert not mod.verify(os.path.join(d, "step_00000005"))
            assert mod.verify(os.path.join(d, "step_00000004"))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path / "jax"), 5, {"x": np.zeros(3)})
    assert ckpt.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bfloat16_leaf_verifies_and_restores(tmp_path, writer):
    """A bfloat16 leaf (ml_dtypes; ``np.load`` gives it back as 2-byte
    void, a dtype with no buffer format) checksums as its bytes: the
    checkpoint either package writes verifies in both, and the port
    restores it with the check on."""
    x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
                    jnp.bfloat16)
    tree = {"w": np.asarray(x), "step": np.int32(3)}
    d = str(tmp_path)
    mod = jckpt if writer == "jax" else ckpt
    path = mod.save(d, 1, tree)
    assert ckpt.verify(path) and jckpt.verify(path)
    got = ckpt.restore(d, 1, tree)
    assert got["w"].tobytes() == tree["w"].tobytes()
    assert int(got["step"]) == 3


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "seamless-m4t-medium"])
def test_moe_and_encdec_trees_round_trip(tmp_path, arch):
    """A smoke model's parameters and prefill cache, JAX's trees of MoE
    units ({dense0, moe_layer}, a shared expert) or of enc / dec layers
    with the cross cache: written by JAX, restored in the port into
    ``lm_params_from_jax`` / ``lm_cache_from_jax`` templates, bit-equal;
    written back by the port, verified and restored by JAX."""
    import jax
    from repro.configs.registry import get_config, smoke_config
    from repro.models.zoo import get_model
    from repro_torch import convert
    from repro_torch.utils.params import tree_map
    cfg = smoke_config(get_config(arch))
    m = get_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    inputs = (jnp.ones((1, 8, cfg.d_model)) if cfg.family == "encdec"
              else jnp.arange(8)[None] % cfg.vocab_size)
    cache, _ = m.prefill(params, inputs, 16)
    tree = {"params": params, "cache": cache}
    want = _jax_to_np(jax.tree.map(np.asarray, tree))
    jckpt.save(str(tmp_path / "jax"), 1, tree)
    # plain dicts of the model's tensors, as TrainLoop checkpoints them
    template = {"params": tree_map(lambda t: t, convert.lm_params_from_jax(
                    want["params"])),
                "cache": convert.lm_cache_from_jax(want["cache"])}
    got = ckpt.restore(str(tmp_path / "jax"), 1, template)
    _assert_tree_equal(got, want)
    path = ckpt.save(str(tmp_path / "torch"), 1, got)
    assert jckpt.verify(path)
    back = jckpt.restore(str(tmp_path / "torch"), 1, _as_jax(want))
    _assert_tree_equal(_jax_to_np(back), want)
