"""The port's training over several processes (``distributed/parallel.py``,
the plan seam of every model family, ``make_train_step(plan=)``, the
sharded optimizers and batches, ``TrainLoop(mesh=)`` and restore onto
another layout) on the CPU, against the port's one-device step and the
JAX package's single-device loss and step.

One ``python -m torch.distributed.run --nproc-per-node 4`` of
``tests/_torch_mesh_worker.py`` (gloo, 4 ranks) runs every case over
layouts (4, 1), (1, 4), (2, 2) and (2, 1, 2) and writes what it got; the
tests compare.  qwen3-0.6b's smoke config (4 heads over 2 kv heads)
shards its kv heads at "model" 2 and projects them whole and expands
them at "model" 4; granite-3-8b runs 4 microbatches over the local rows;
llama3-405b runs Adafactor (factored at the smoke widths with
``min_dim_factored`` 16); mamba2-780m and qwen3-moe-30b-a3b run data
parallel at (4, 1) and split their 8 SSM heads and 4 experts over
"model" at (1, 4) and (2, 2); zamba2-1.2b splits its mamba layers and
shared block, seamless-m4t-medium its encoder, decoder and
cross-attention at (1, 4), and both at (2, 2) beside FSDP over "data"
(zamba2 at 5 layers: two groups and a tail); qwen3 at (4, 1) also under
remat "dots" and the two-level remat; qwen3 with 6 query heads runs its
attention sequence-parallel at (1, 4) (8 query rows a rank), and with
``seq_shard_activations`` its residual stream cut on S (Megatron-SP);
the plans whose "model" axis divides neither the experts nor the SSM
heads run: qwen3-moe with 6 experts at (1, 4) and 3 at (2, 2) (each
expert's d_ff_expert cut), mamba2 at head_dim 64 (2 heads, d_in 128 cut:
the layer whole on every rank) and zamba2 so with its residual stream
cut on S; qwen3 steps with int8 gradient compression at (4, 1) and
(2, 2); masked batches over several batch shards (qwen3 at (4, 1), (2, 2),
(2, 1, 2) and compressed at (2, 2), granite's 4 microbatches, the MoE,
seamless, and B 12 in 3 microbatches, where a rank's rows fall in two)
take JAX's masked mean per global microbatch, and the sharded eval step
JAX's eval of the global batch; checkpoints saved on one layout are restored onto another
(qwen3's heads, mamba2's SSM heads, qwen3-moe's experts, seamless);
last, the launcher's ``main`` trains over the same 4 ranks, and again
with ``--grad-compression``.  The parameters of
qwen3 (4 and 6 query heads), mamba2 and qwen3-moe are JAX's
initialisation, carried across by ``convert.lm_params_from_jax``, the
others the port's draws; all in f32.

Tolerances: the sharded step sums in another order than one device (the
gradient over ranks, the vocab-parallel softmax, the row-parallel
products).  The loss is held within 1e-6 of one device's (relative),
every gathered gradient within 1e-5 of its leaf's largest element, the
optimizer state within 1e-5 (the same gates for every case, the
split ones included: they sum over ranks the SSM heads' B / C
gradients, the gated norm's squares, the experts' partial combines and
the query rows' attention in another order too).  The parameters'
movement (after - before)
within 1e-4 of the learning rates' sum plus one f32 spacing per element,
except where AdamW's g / (|g| + eps) turns with the gradient's last
digits: elements whose clipped gradient at some step is below 100 eps
(1e-6), at most 0.1 % of a leaf, as ``test_torch_train.py`` holds one
step against JAX.  The split cases (``SPLIT_CASES`` of the worker) sum
over ranks in more places, and AdamW divides each gradient by its own
size, so an element far below its leaf's largest carries the sums'
rounding relatively larger (1e-4 of it where the gradient gate allows
1e-5 of the leaf's largest): they hold the movement within one f32
spacing per element per step (two: each step rounds p once, and both
roundings can fall the other way, as at one element of mamba2-1x4's
embedding), and their exempt elements also count those whose first
moment after step 2 cancels to below 1 % of its terms, where m / sqrt(v)
turns with the gradients' last digits (one element of zamba2-1x4's
out_proj: 0.7 %); still at most 0.1 % of a leaf.  The compressed cases
(``COMPRESSED`` of the worker: int8 gradient compression at (4, 1) and
(2, 2)) quantise the mean gradient, so where it lies at a rounding
boundary of its int8 block the code turns to the next step of 1/127 of
the block's largest with the sums' last digits (one element of qwen3's
mlp w_down at step 2: 109.5 steps).  The elements whose code differs
between the sharded run's recorded gradients and one device's at some
step (``int8_turned``) count as exempt too, still at most 0.1 % of a
leaf, and their optimizer state (AdamW's m and v, which carry the
turned step) is held on the other elements.  The sharded
compression itself is held bit for bit against JAX's
``compress_decompress`` of each whole leaf on a fixed tree.
"""
import dataclasses
import os
import subprocess
import sys

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
from repro.distributed.compression import \
    compress_decompress as jax_compress  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.training.train_step import _microbatch_grads as jax_grads  # noqa: E402
from repro.training.train_step import make_eval_step as jax_eval  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.distributed import parallel as par  # noqa: E402
from repro_torch.distributed.compression import compress_decompress  # noqa: E402
from repro_torch.distributed.rules import make_plan  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import TrainLoop  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.training import optimizers as opt  # noqa: E402
from repro_torch.training.train_step import (_microbatch_grads,  # noqa: E402
                                             make_train_step)
from repro_torch.utils.params import (tree_from_flat, tree_leaves,  # noqa: E402
                                      tree_map)

import _torch_mesh_worker as W  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
SRC = os.path.join(ROOT, "src")


JAX_ARCH = "qwen3-0.6b"     # the case held against the JAX package's step
# the parameter files (``input_key``) that hold JAX's initialisation, each
# by a case that reads it: their cases can be held against the JAX package
JAX_INPUTS = {W.input_key(n): n for n in (
    "qwen3-4x1", "mamba2-4x1", "moe-4x1", "qwen3-sp-1x4", "moe-ffcut-1x4",
    "moe-ffcut-2x2", "mamba2-inner-1x4")}


@pytest.fixture(scope="module")
def jax_models():
    """{input key: (JAX model, its parameters from PRNGKey(0))}."""
    out = {}
    for key, name in JAX_INPUTS.items():
        arch, over = W.CASES[name][0], W.CASES[name][4]
        jm = jax_model(W.with_overrides(jax_smoke(jax_config(arch)), over))
        out[key] = jm, jm.init(jax.random.PRNGKey(0))
    return out


@pytest.fixture(scope="module")
def jax_qwen3(jax_models):
    return jax_models[JAX_ARCH]


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_models):
    """The worker's outputs and standard output: one torchrun of 4 gloo
    ranks for the file.  The parameters of ``JAX_INPUTS`` are JAX's
    (carried across by ``convert``), the others the port's draws from
    seed 0."""
    d = tmp_path_factory.mktemp("mesh")
    inp, out = d / "in", d / "out"
    inp.mkdir()
    out.mkdir()
    for key, name in {W.input_key(n): n for n in W.CASES}.items():
        arch, over = W.CASES[name][0], W.CASES[name][4]
        if key in JAX_INPUTS:
            tree = convert.lm_params_from_jax(
                jax.tree.map(np.asarray, jax_models[key][1]))
        else:
            tree = get_model(W.case_config(arch, over)).init(
                torch.Generator().manual_seed(0))
        np.savez(inp / f"{key}.npz", **{n: x.detach().numpy()
                                        for n, x in tree_leaves(tree)})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", os.path.join(HERE, "_torch_mesh_worker.py"),
         str(inp), str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, out, proc.stdout + proc.stderr


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _sub(d, prefix):
    return {k[len(prefix) + 1:]: v for k, v in d.items()
            if k.startswith(prefix + "/")}


def _np(tree):
    return {n: x.detach().numpy().copy() for n, x in tree_leaves(tree)}


def close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def moved_close(got, want, before, lr_sum, small, what, roundings=1):
    """The parameter's movement against the reference's (module note):
    ``roundings`` f32 spacings per element."""
    moved = want.astype(np.float64) - before
    beyond = np.abs(got.astype(np.float64) - before - moved) > (
        1e-4 * lr_sum
        + roundings * np.spacing(np.abs(want).astype(np.float32)))
    assert np.all(small[beyond]), (what, int(beyond.sum()))
    assert np.mean(beyond) <= 1e-3, (what, int(beyond.sum()))


def int8_codes(g):
    """The int8 code of each element of a gradient leaf in
    ``compress_decompress``'s round trip (blocks of 256 of the flattened
    leaf, each over its largest |g| / 127), in its f32 arithmetic."""
    flat = g.astype(np.float32).reshape(-1)
    pad = np.concatenate([flat, np.zeros((-flat.size) % 256, np.float32)])
    pad = pad.reshape(-1, 256)
    scale = np.abs(pad).max(1, keepdims=True) / np.float32(127.0)
    q = np.clip(np.round(pad / np.maximum(scale, np.float32(1e-12))),
                -127, 127)
    return q.reshape(-1)[:flat.size].reshape(g.shape)


def int8_turned(got, ref, n):
    """Elements of leaf ``n`` whose int8 code differs between the
    sharded run's gradients (``grad``, ``grad2``: its steps') and the
    one-device reference's at some step."""
    out = np.zeros(ref["steps"][0]["grads"][n].shape, bool)
    for i, st in enumerate(ref["steps"]):
        g = _sub(got, "grad" if i == 0 else f"grad{i + 1}")[n]
        out |= int8_codes(g) != int8_codes(st["grads"][n])
    return out


def first_moment_cancels(steps, n, b1=0.9):
    """Elements whose AdamW first moment after the last step sums the
    steps' clipped gradients to below 1 % of its terms' sizes."""
    terms = [(1 - b1) * b1 ** (len(steps) - 1 - i)
             * s["grads"][n].astype(np.float64) * s["clip"]
             for i, s in enumerate(steps)]
    return np.abs(sum(terms)) < 1e-2 * sum(np.abs(t) for t in terms)


def one_device(name, inp):
    """The port's one-device run of a case from the same parameters and
    batches: loss and gradients of the first batch, then per step the
    loss, clipped gradients and parameters, and the optimizer state."""
    arch, _, B, S, over, opt_over = W.CASES[name]
    cfg = W.case_config(arch, over)
    m = get_model(cfg)
    with np.load(inp / f"{W.input_key(name)}.npz") as f:
        params = m.load(tree_from_flat(m.param_defs(),
                                       {k: torch.tensor(f[k])
                                        for k in f.files}))
    ocfg = opt.OptConfig(name=cfg.optimizer, **opt_over)
    # make_train_step's one-device step, its gradients kept before the
    # optimizer clips them in place (and before the int8 round trip of
    # a compressed case)
    _, init, update = opt.make_optimizer(cfg.optimizer, ocfg)
    out = {"before": _np(params), "steps": []}
    state = init(params)
    for i in range(2):
        b = device_batch(W.host_batch(name, i), "cpu")
        g, loss, _ = _microbatch_grads(m.loss, params, b,
                                       cfg.grad_accum_microbatches,
                                       getattr(torch, cfg.grad_accum_dtype))
        grads = _np(g)
        if name in W.COMPRESSED:
            g = tree_map(compress_decompress, g)
        params, state, met = update(g, state, params)
        clip = min(1.0, ocfg.grad_clip / max(float(met["grad_norm"]), 1e-9))
        out["steps"].append({"loss": float(loss), "grads": grads,
                             "clip": clip, "lr": float(met["lr"]),
                             "params": _np(params)})
    out["opt"] = _np({k: v for k, v in state.items() if k != "step"})
    return out


@pytest.fixture(scope="module")
def refs(run):
    return {name: one_device(name, run[0]) for name in W.CASES}


CASE_NAMES = list(W.CASES)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_shard_gather_round_trip(run, name):
    """``gather_tree(shard_tree(t))`` gave every parameter back bit for
    bit on every layout."""
    assert bool(_load(run[1] / f"{name}.npz")["roundtrip"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_loss_and_grads_match_one_device(run, refs, name):
    """The sharded loss of the first batch, and every gradient gathered
    from the shards, against one device's."""
    got, want = _load(run[1] / f"{name}.npz"), refs[name]["steps"][0]
    close(got["grad_loss"], want["loss"], 1e-6, "loss")
    grads = _sub(got, "grad")
    assert set(grads) == set(want["grads"])
    for n, g in want["grads"].items():
        close(grads[n], g, 1e-5, n)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_steps_match_one_device(run, refs, name):
    """Two sharded steps (the second through ``make_train_step``): both
    losses, the parameters and the optimizer state (AdamW's m and v,
    Adafactor's vr / vc / v) gathered from the shards against one
    device's."""
    got, ref = _load(run[1] / f"{name}.npz"), refs[name]
    for i in range(2):
        close(got[f"loss{i + 1}"], ref["steps"][i]["loss"], 1e-6,
              f"loss{i + 1}")
    lr_sum = sum(s["lr"] for s in ref["steps"])
    want = ref["steps"][1]["params"]
    params = _sub(got, "p2")
    assert set(params) == set(want)
    for n, p in want.items():
        small = np.zeros(p.shape, bool)
        for s in ref["steps"]:
            small |= np.abs(s["grads"][n]) * s["clip"] < 1e-6
        if name in W.COMPRESSED:
            small |= int8_turned(got, ref, n)
        roundings = 1
        if name in W.SPLIT_CASES:
            roundings = len(ref["steps"])
            small |= first_moment_cancels(ref["steps"], n)
        moved_close(params[n], p, ref["before"][n], lr_sum, small, n,
                    roundings)
    state = _sub(got, "opt")
    assert int(state.pop("step")) == 2
    assert set(state) == set(ref["opt"])
    for n, v in ref["opt"].items():
        if name in W.COMPRESSED:
            # AdamW's m and v of a parameter: the elements whose int8
            # code turned left out, at most 0.1 % of the leaf
            turned = int8_turned(got, ref, n.split(".", 1)[1])
            assert np.mean(turned) <= 1e-3, (n, int(turned.sum()))
            state[n], v = state[n][~turned], v[~turned]
        close(state[n], v, 1e-5, n)


def _jax_case(run, jax_models, name):
    """The JAX package's model of case ``name`` and its parameters: JAX's
    initialisation where the case's inputs are (``JAX_INPUTS``), else the
    port's draws the worker read."""
    key = W.input_key(name)
    if key in jax_models:
        return jax_models[key]
    arch, over = W.CASES[name][0], W.CASES[name][4]
    jm = jax_model(W.with_overrides(jax_smoke(jax_config(arch)), over))
    return jm, jax.tree.map(jnp.asarray, tree_from_flat(
        get_model(W.case_config(arch, over)).param_defs(),
        _load(run[0] / f"{key}.npz")))


def _jax_batch(name):
    return {k: jnp.asarray(v) for k, v in W.host_batch(name, 0).items()}


def _holds_jax_step(run, refs, name, jm, jp, grad_compression=False):
    """Case ``name`` against the JAX package on the same parameters and
    batch (``host_batch``): the loss (``model.loss``; with several
    microbatches, the step's) and one step of JAX's single-device
    ``make_train_step(model, cfg, None, grad_compression=)``, ``cfg`` with
    the case's microbatches."""
    got = _load(run[1] / f"{name}.npz")
    cfg = W.with_overrides(jm.cfg, W.CASES[name][4])
    jb = _jax_batch(name)
    step, init, _ = jax_step(jm, cfg, None,
                             grad_compression=grad_compression)
    jp1, _, jmet = jax.jit(step)(jp, init(jp), jb, jnp.int32(0))
    jl = (jm.loss(jp, jb)[0] if cfg.grad_accum_microbatches == 1
          else jmet["loss"])
    close(got["grad_loss"], jl, 1e-6, "loss")
    close(got["loss1"], jl, 1e-6, "loss1")
    flat = lambda t: {".".join(k.key for k in path): np.asarray(v)  # noqa
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    want, before = flat(jp1), flat(jp)
    one = refs[name]["steps"][0]
    params = _sub(got, "p1")
    assert set(params) == set(want)
    for n, p in want.items():
        close(params[n], p, 1e-5, n)
        small = np.abs(one["grads"][n]) * one["clip"] < 1e-6
        if grad_compression:
            small |= int8_codes(_sub(got, "grad")[n]) != int8_codes(
                one["grads"][n])
        moved_close(params[n], p, before[n], float(jmet["lr"]), small, n)


def test_slice_matches_jax_single_device(run, refs, jax_qwen3):
    """qwen3-0.6b at (2, 2) (kv heads sharded, vocab-parallel loss, FSDP
    over "data") against the JAX package on the same parameters and
    batch: the loss within 1e-6 of ``model.loss`` (relative), the
    parameters after one step within 1e-5 of each leaf's largest element
    of JAX's single-device ``make_train_step(model, cfg, None)`` and
    their movement as the module note says (the small gradients: the
    port's one-device ones, held against JAX's in ``test_torch_train``)."""
    _holds_jax_step(run, refs, "qwen3-2x2", *jax_qwen3)


@pytest.mark.parametrize("name", [n for n in W.COMPRESSED
                                  if n not in W.MASKED])
def test_compressed_step_matches_jax_single_device(run, refs, jax_qwen3,
                                                   name):
    """qwen3-0.6b at (4, 1) and (2, 2) with int8 gradient compression
    (each rank its block of every whole leaf's round trip) against JAX's
    single-device ``make_train_step(..., grad_compression=True)``: the
    loss and the parameters after one step, as
    ``test_slice_matches_jax_single_device`` holds them."""
    _holds_jax_step(run, refs, name, *jax_qwen3, grad_compression=True)


@pytest.mark.parametrize("shape", W.COMPRESSION_LAYOUTS,
                         ids=lambda s: "x".join(map(str, s)))
def test_sharded_compression_bit_equal_to_jax(run, shape):
    """``compress_sharded`` of the worker's fixed tree cut on ``shape``,
    gathered, against JAX's ``compress_decompress`` of each whole leaf,
    bit for bit: shards that straddle 256-element blocks, a leaf of 288
    whose shards hold 72 (compressed), a 1-D leaf cut over both axes, a
    replicated leaf and a bf16 one; the leaf of 200 and the integers
    left exactly as they were."""
    got = _load(run[1] / "compression.npz")
    t = "x".join(map(str, shape))
    tree = W.compression_tree()
    for n, x in tree.items():
        dtype = W.COMPRESSION_LEAVES[n][1]
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = np.asarray(jax_compress(jx).astype(
            jnp.float32 if dtype != "int32" else jnp.int32))
        g = got[f"{t}/{n}"]
        assert g.dtype == want.dtype and g.shape == want.shape, n
        assert np.array_equal(g.view(np.uint32 if dtype != "int32"
                                     else np.int32),
                              want.view(np.uint32 if dtype != "int32"
                                        else np.int32)), n
        if n in ("small", "ints"):
            assert np.array_equal(g, x), n
        else:
            assert not np.array_equal(g, x), n


# the split cases held against the JAX package's single-device loss and
# gradients on the same parameters
JAX_SPLIT_CASES = ("mamba2-1x4", "moe-1x4", "qwen3-sp-1x4",
                   "qwen3-resid-seq-1x4", "moe-ffcut-1x4", "moe-ffcut-2x2",
                   "mamba2-inner-1x4", "zamba2-inner-seq-1x4")


@pytest.mark.parametrize("name", JAX_SPLIT_CASES)
def test_split_matches_jax_single_device(run, jax_models, name):
    """mamba2-780m's SSM heads, qwen3-moe-30b-a3b's experts, qwen3's
    attention sequence-parallel (6 query heads over 2 kv heads: each rank
    8 query rows at their causal offset, the rows gathered) and qwen3
    with its residual stream cut on S (Megatron-SP: all-gathers and
    reduce-scatters on S, the norms model-partial), and the plans whose
    "model" axis divides neither the experts nor the SSM heads (6
    experts at (1, 4) and 3 at (2, 2), each expert's d_ff_expert cut;
    mamba2 and zamba2 at head_dim 64, their mamba layers whole on every
    rank, zamba2's residual stream cut on S; zamba2 on the port's draws,
    as its other cases), against ``jax.value_and_grad`` of the JAX
    package's ``model.loss`` on one device: the loss within 1e-6 of its
    value and every gathered gradient within 1e-5 of its leaf's largest
    element, as ``test_torch_arch_smoke.py`` and
    ``test_torch_train_ssm.py`` hold the one-device port (f32, sums in
    another order)."""
    got = _load(run[1] / f"{name}.npz")
    jm, jp = _jax_case(run, jax_models, name)
    jb = _jax_batch(name)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    close(got["grad_loss"], jl, 1e-6, "loss")
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    grads = _sub(got, "grad")
    assert set(grads) == set(flat)
    for n, g in flat.items():
        close(grads[n], g, 1e-5, n)


MASKED = list(W.MASKED)


@pytest.mark.parametrize("name", MASKED)
def test_masked_matches_jax_single_device(run, refs, jax_models, name):
    """A masked batch over several batch shards (the worker's
    ``masked_batch``: prompts and padding weighing 0, some tokens 0.5, a
    whole global microbatch or row 0) against the JAX package's
    single-device step on the global batch with the same microbatches:
    the loss within 1e-6 (relative) and every gathered gradient within
    1e-5 of its leaf's largest element of JAX's ``_microbatch_grads``
    (its masked mean per global microbatch), and one step of
    ``make_train_step(model, cfg, None)`` as
    ``test_slice_matches_jax_single_device`` holds it; and the step's
    earlier loss, the mean of the ranks' own means, misses JAX's by at
    least 100 times the loss's gate."""
    got = _load(run[1] / f"{name}.npz")
    jm, jp = _jax_case(run, jax_models, name)
    cfg = W.with_overrides(jm.cfg, W.CASES[name][4])
    jg, jl, _ = jax.jit(lambda p, b: jax_grads(
        jm.loss, p, b, cfg.grad_accum_microbatches, None))(
        jp, _jax_batch(name))
    close(got["grad_loss"], jl, 1e-6, "loss")
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    grads = _sub(got, "grad")
    assert set(grads) == set(flat)
    for n, g in flat.items():
        close(grads[n], g, 1e-5, n)
    old = float(got["rank_means_loss"])
    assert abs(old - float(jl)) >= 100 * 1e-6 * abs(float(jl)), (old, jl)
    _holds_jax_step(run, refs, name, jm, jp,
                    grad_compression=name in W.COMPRESSED)


@pytest.mark.parametrize("name", MASKED)
def test_masked_eval_matches_jax_single_device(run, jax_models, name):
    """``make_eval_step(model, plan)`` on each rank's rows of a masked
    batch against JAX's ``make_eval_step`` on the global batch: loss,
    ce, aux and the token count within 1e-6 (relative)."""
    got = _load(run[1] / f"{name}.npz")
    jm, jp = _jax_case(run, jax_models, name)
    want = jax_eval(jm)(jp, _jax_batch(name))
    assert {k[len("eval/"):] for k in got if k.startswith("eval/")} == set(
        want)
    for k, v in want.items():
        close(got[f"eval/{k}"], v, 1e-6, k)


# the cases whose data axes have more than one process: FSDP gathers
FSDP_CASES = [n for n in CASE_NAMES if max(W.CASES[n][1][:-1]) > 1]


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_gathers_per_unit(run, name, monkeypatch):
    """Every rank's FSDP collectives in the first step's gradient
    (``make_grad_fn``, ``parallel.fsdp_counts``): the all-gathers, the
    reduce-scatters and the most elements one all-gather gave, equal to
    ``chip_smoke.step_collectives``: a unit's slice of each stacked leaf
    gathered where the unit runs and in each recompute, the leaves
    outside the stacks once a forward, each gradient reduce-scattered
    once, per microbatch; never a whole stack.  A masked case's equal
    the unmasked case's of its layout (``MASKED``' twin); its step adds
    one all-reduce of the token counts per batch axis over one process
    (``parallel.token_reduces``), an unmasked step none."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    arch, shape, B, S, over, _ = W.CASES[name]
    cfg = W.case_config(arch, over)
    mesh = make_mesh(shape, W.AXES2 if len(shape) == 2 else W.AXES3,
                     ["cpu"] * int(np.prod(shape)))
    plan = make_plan(cfg, mesh, ShapeCfg("test", S, B, "train"))
    model = get_model(cfg, plan)
    want = chip_smoke.step_collectives(model)
    out = _load(run[1] / f"{name}.npz")
    got = out["fsdp"]
    assert len(got) == 4
    for r, row in enumerate(got):
        assert dict(zip(W.FSDP_KEYS, map(int, row))) == want, (r, row)
    if W.MASKED.get(name):
        assert np.array_equal(got, _load(run[1] / f"{W.MASKED[name]}.npz")[
            "fsdp"])
    batch = par.live_axes(mesh, plan.batch_axes)
    assert list(out["token_reduces"]) == [
        len(batch) if name in W.MASKED else 0] * 4


RESTORE_CASES = [(arch, shape) for arch, (_, shapes) in W.RESTORES.items()
                 for shape in shapes]


@pytest.mark.parametrize("arch,shape", RESTORE_CASES,
                         ids=[W.restore_name(*c)[len("restore-"):]
                              for c in RESTORE_CASES])
def test_restore_onto_another_layout(run, arch, shape):
    """A ``TrainLoop`` on the arch's save layout (qwen3: (2, 2); mamba2,
    qwen3-moe, seamless: (1, 4), their SSM heads, experts or attention
    heads cut over "model") saved at step 1; a loop on ``shape``
    restored it (its shards cut from the full arrays) and ran steps 2
    and 3: losses within 1e-6 and parameters within 1e-5 of each leaf's
    largest element against a one-device loop that ran the 3 steps
    straight (the same seed and stream)."""
    got = _load(run[1] / f"{W.restore_name(arch, shape)}.npz")
    straight = W.restore_loop(arch)
    params, _, _ = straight.run(3, log=lambda _: None)
    assert list(got["steps"]) == [2, 3]
    for i, h in enumerate(straight.history[1:]):
        close(got["losses"][i], h["loss"], 1e-6, f"loss {h['step']}")
    want = _np(params)
    for n, p in want.items():
        close(_sub(got, "p")[n], p, 1e-5, n)


def _plan(arch, shape, **over):
    cfg = smoke_config(get_config(arch)).replace(**over)
    axes = ("data", "model")
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    return cfg, make_plan(cfg, mesh, ShapeCfg("t", 32, 4, "train"))


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_every_family_builds_at_model_2(arch):
    """Every family takes a "model" axis of 2 (the split the worker's
    cases run) and of 1."""
    for shape in ((2, 2), (4, 1)):
        cfg, plan = _plan(arch, shape)
        assert get_model(cfg, plan).plan is plan


def test_ssm_rules_disagreeing_accepted():
    """A plan that cuts the SSM's d_in over "model" but not its heads
    (4 heads of 32 on an 8-way axis: d_in 128 divides, H does not), and
    one that also cuts the residual stream on S (``resid_seq``) through
    those mamba layers: ``get_model`` builds both, the d_in leaves stay
    cut (the layer gathers them as it runs), and no mamba leaf is
    model-partial (the layer runs whole).  ``mamba2-inner-1x4`` and
    ``zamba2-inner-seq-1x4`` hold their numbers."""
    cfg = smoke_config(get_config("mamba2-780m"))
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, head_dim=32))
    mesh = make_mesh((1, 8), ("data", "model"), ["cpu"] * 8)
    for c in (cfg, cfg.replace(seq_shard_activations=True)):
        plan = make_plan(c, mesh, ShapeCfg("t", 32, 4, "train"))
        assert plan.rules["ssm_inner"] == "model"
        assert plan.rules["ssm_head"] is None
        assert plan.resid_seq == ("model" if c.seq_shard_activations
                                  else None)
        model = get_model(c, plan)
        specs = dict(tree_leaves(model.param_specs()))
        assert tuple(specs["layers.w_x"]) == (None, "data", "model")
        assert tuple(specs["layers.A_log"]) == (None, None)
        assert not {n for n in model.model_partial_leaves()
                    if n.startswith("layers.")}


def test_moe_experts_not_dividing_accepted():
    """6 experts on a 4-way "model" axis: ``get_model`` builds the plan
    JAX makes, each expert's d_ff_expert cut over "model" (every rank
    all 6 experts), the router model-partial.  ``moe-ffcut-1x4`` and
    ``moe-ffcut-2x2`` hold its numbers."""
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=6))
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    plan = make_plan(cfg, mesh, ShapeCfg("t", 32, 4, "train"))
    assert plan.rules["expert"] is None
    model = get_model(cfg, plan)
    specs = dict(tree_leaves(model.param_specs()))
    assert tuple(specs["layers.moe.w_gate"]) == (None, None, "data",
                                                 "model")
    assert tuple(specs["layers.moe.w_down"]) == (None, None, "model",
                                                 "data")
    assert "layers.moe.router" in model.model_partial_leaves()


def test_grad_compression_under_a_plan_accepted():
    """``make_train_step(plan=, grad_compression=True)`` builds the
    sharded step; ``qwen3-compress-4x1`` / ``-2x2`` and
    ``test_sharded_compression_bit_equal_to_jax`` hold its numbers."""
    cfg, plan = _plan("qwen3-0.6b", (4, 1))
    step, init, ocfg = make_train_step(get_model(cfg, plan), cfg, plan,
                                       grad_compression=True)
    assert callable(step) and callable(init) and ocfg.name == cfg.optimizer


def test_launcher_over_four_processes(run):
    """``launch.train.main(["--distributed", "--mesh", "2,2", ...])`` in
    the worker's gloo group of 4: rank 0 alone logs, and its losses (as
    logged, 4 decimals) are those of one process."""
    log = run[2]
    assert log.count("step 2 loss") == 1
    assert "mesh={'data': 2, 'model': 2}" in log
    la = W.LAUNCHER
    one = TrainLoop(smoke_config(get_config(la["arch"])),
                    global_batch=la["global_batch"], seq=la["seq"],
                    device="cpu")
    one.run(la["steps"], log=lambda _: None)
    for h in one.history:
        assert f"step {h['step']} loss {h['loss']:.4f}" in log


def test_launcher_grad_compression_over_four_processes(run):
    """``launch.train.main(["--distributed", "--mesh", "4,1",
    "--grad-compression", ...])`` in the worker's gloo group of 4: its
    losses within 1e-6 (relative) of one process's compressed loop."""
    got = _load(run[1] / "launcher-compressed.npz")["losses"]
    la = W.LAUNCHER
    one = TrainLoop(smoke_config(get_config(la["arch"])),
                    global_batch=la["global_batch"], seq=la["seq"],
                    device="cpu", grad_compression=True)
    one.run(la["steps"], log=lambda _: None)
    assert len(got) == la["steps"]
    for g, h in zip(got, one.history):
        close(g, h["loss"], 1e-6, f"loss {h['step']}")


def test_no_fallback_from_the_card(monkeypatch):
    """A process mesh or ``--distributed`` on the card raises when CUDA,
    or this rank's card, is missing: it never drops to the CPU or to one
    process."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "3"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.init_distributed("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.make_process_mesh((1, 1), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 but only 2"):
        train_mod.init_distributed("cuda")
