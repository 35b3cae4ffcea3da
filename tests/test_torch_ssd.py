"""The port's SSD scan (plain version, CPU) against the JAX Pallas
kernel in interpret mode (``repro.kernels.ssd_scan``, as
tests/test_kernels.py runs it), the JAX ``ssd_chunked`` (both 1e-5: the
same chunked algorithm, sums in another order) and the sequential
oracle ``ssd_scan_ref`` (1e-3, as tests/test_kernels.py holds it).
Inputs come from a numpy seed.  Then the CUDA launch path with a fake
library standing in for the built one: one C call per call, counted
once, no plain fallback, and the C declaration's arguments."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

SHAPES = [(64, 2, 16, 8, 16), (128, 3, 32, 16, 32), (256, 1, 64, 32, 64),
          (100, 2, 16, 8, 128),      # S < chunk
          (128, 2, 16, 128, 64),     # mamba2-780m's d_state
          (512, 2, 16, 16, 64)]      # 8 chunks, slow decay


def _inputs(S, H, hd, N, B=2, seed=0, init=False, slow_decay=False):
    """x, dt, A_log, B, C (and an initial state).  dt = softplus(normal)
    and A = -exp(0.3 normal) decay ~0.8 a step, so a chunk's state is
    ~e^-50 of itself a chunk later; ``slow_decay`` draws them as Mamba2
    initialises them (per head a dt log-uniform in [1e-3, 0.1] and
    A = -uniform [1, 16]; dt times exp(0.5 normal) per step), where the
    state carried across chunks shows in y."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    if slow_decay:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H)
                    + 0.5 * rng.standard_normal((B, S, H)))
        A_log = np.log(rng.uniform(1.0, 16.0, H))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        A_log = rng.standard_normal(H) * 0.3
    dt, A_log = dt.astype(np.float32), A_log.astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    arrays = [x, dt, A_log, Bm, Cm]
    if init:
        arrays.append(rng.standard_normal((B, H, N, hd)).astype(np.float32))
    return arrays


def _port(x, dt, A_log, Bm, Cm, chunk, init_state=None):
    t = [torch.tensor(a) for a in (x, dt, A_log, Bm, Cm)]
    st = None if init_state is None else torch.tensor(init_state)
    y, fs = ops.ssd_scan(*t, chunk=chunk, init_state=st)
    return y.numpy(), fs.numpy()


def _close(got, want, tol):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("S,H,hd,N,chunk", SHAPES)
def test_ssd_matches_pallas_interpret_and_ssd_chunked(S, H, hd, N, chunk):
    x, dt, A_log, Bm, Cm = _inputs(S, H, hd, N, seed=S,
                                   slow_decay=S // chunk >= 8)
    y, fs = _port(x, dt, A_log, Bm, Cm, chunk)
    jy, jfs = jssd(*map(jnp.asarray, (x, dt, A_log, Bm, Cm)), chunk=chunk)
    _close(y, jy, 1e-5)
    _close(fs, jfs, 1e-5)
    cy, cfs = jm2.ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, A_log)),
                              chunk)
    _close(y, cy, 1e-5)
    _close(fs, cfs, 1e-5)


@pytest.mark.parametrize("S,H,hd,N,chunk", SHAPES)
def test_ssd_matches_sequential_reference(S, H, hd, N, chunk):
    x, dt, A_log, Bm, Cm = _inputs(S, H, hd, N, seed=S + 1,
                                   slow_decay=S // chunk >= 8)
    y, fs = _port(x, dt, A_log, Bm, Cm, chunk)
    la = dt * -np.exp(A_log)
    ry, rfs = ssd_scan_ref(jnp.asarray(x * dt[..., None]), jnp.asarray(la),
                           jnp.asarray(Bm), jnp.asarray(Cm))
    assert np.abs(y - np.asarray(ry)).max() < 1e-3
    assert np.abs(fs - np.asarray(rfs)).max() < 1e-3


def test_ssd_chunked_with_initial_state_matches_jax():
    x, dt, A_log, Bm, Cm, st0 = _inputs(64, 2, 16, 8, seed=3, init=True)
    y, fs = mamba2.ssd_chunked(*map(torch.tensor, (x, Bm, Cm, dt, A_log)),
                               16, init_state=torch.tensor(st0))
    jy, jfs = jm2.ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, A_log)), 16,
                              init_state=jnp.asarray(st0))
    _close(y.numpy(), jy, 1e-5)
    _close(fs.numpy(), jfs, 1e-5)


@pytest.mark.parametrize("P,S,chunk", [(64, 192, 32), (128, 256, 64),
                                        (32, 256, 32)])
def test_ssd_from_an_initial_state_over_several_chunks(P, S, chunk):
    """The state carried into a sequence: the port from init_state (the
    state a prefix of P steps leaves) against the Pallas kernel over the
    prefix and the sequence together (its y past the prefix and its final
    state), and against JAX's ssd_chunked from the same init_state; 3 to
    8 chunks, where passing the state from chunk to chunk can go wrong."""
    x, dt, A_log, Bm, Cm = _inputs(P + S, 2, 16, 16, seed=P + S,
                                   slow_decay=True)
    jx = [jnp.asarray(a) for a in (x, dt, A_log, Bm, Cm)]
    _, st0 = jssd(jx[0][:, :P], jx[1][:, :P], jx[2], jx[3][:, :P],
                  jx[4][:, :P], chunk=chunk)
    st0 = np.asarray(st0)
    jy, jfs = jssd(*jx, chunk=chunk)
    rest = [a[:, P:] for a in (x, dt)] + [A_log] + [a[:, P:] for a in (Bm,
                                                                       Cm)]
    y, fs = _port(*rest, chunk, init_state=st0)
    _close(y, np.asarray(jy)[:, P:], 1e-5)
    _close(fs, jfs, 1e-5)
    cy, cfs = jm2.ssd_chunked(*map(jnp.asarray, (rest[0], rest[3], rest[4],
                                                 rest[1], A_log)), chunk,
                              init_state=jnp.asarray(st0))
    _close(y, cy, 1e-5)
    _close(fs, cfs, 1e-5)


def test_ssd_chunked_keeps_the_chunk_assert():
    x, dt, A_log, Bm, Cm = _inputs(40, 2, 16, 8)
    with pytest.raises(AssertionError):
        mamba2.ssd_chunked(*map(torch.tensor, (x, Bm, Cm, dt, A_log)), 16)


# ------------------------------------------- the wrapper, with a fake library
class _FakeLib:
    """Stands in for the built library: records each C call's arguments
    and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def function(self, lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append((name, args))
            return self.err
        return fn


def _no_plain(*args):
    raise AssertionError("the plain version ran for a kernel launch")


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrapper's launch path on CPU tensors: a fake library, the
    stream call made without CUDA, and the plain version forbidden."""
    from repro_torch import device as rdev

    def make(err=0):
        lib = _FakeLib(err)
        monkeypatch.setattr(ops.build, "function", lib.function)
        monkeypatch.setattr(ops.build, "cuda_call",
                            lambda fn, like, *args: fn(*args, 0))
        monkeypatch.setattr(ops, "ssd_scan_plain", _no_plain)
        rdev.reset_launch_counts()
        return lib
    yield make
    rdev.reset_launch_counts()


def _operands(S, H, hd, N, init=False):
    x, dt, A_log, Bm, Cm, *st = _inputs(S, H, hd, N, B=1, init=init)
    xd, la = ops._operands(*map(torch.tensor, (x, dt, A_log)))
    return (xd, la, torch.tensor(Bm), torch.tensor(Cm),
            torch.tensor(st[0]) if init else None)


@pytest.mark.parametrize("S,chunk,init", [(512, 256, False), (100, 256, True),
                                          (192, 64, True)])
def test_ssd_launch_is_one_c_call_counted_once(fake_lib, S, chunk, init):
    """One C call (three CUDA kernels inside) per call, counted once, with
    the chunk Q = min(chunk, S), outputs and scratch of the sizes the C
    interface states: states (B, S/Q, H, N, hd), totals (B, S/Q, H) and
    C B^T (B, S/Q, QP, QP), QP = Q rounded up to 64."""
    from repro_torch import device as rdev
    lib = fake_lib()
    xd, la, Bm, Cm, st0 = _operands(S, 2, 32, 16, init)
    y, fs = ops._launch(xd, la, Bm, Cm, chunk, st0)
    assert [c[0] for c in lib.calls] == ["ssd_scan_fwd"]
    args = lib.calls[0][1]
    Q = min(chunk, S)
    assert args[10:16] == (1, S, 2, 32, 16, Q) and args[16] == 0
    assert (args[4] is None) == (st0 is None)
    assert y.shape == xd.shape and fs.shape == (1, 2, 16, 32)
    counts = rdev.launch_counts()
    assert counts["ssd_scan"] == 1 and sum(counts.values()) == 1
    ops._launch(xd, la, Bm, Cm, chunk, st0)
    assert rdev.launch_counts()["ssd_scan"] == 2 and len(lib.calls) == 2


def test_ssd_failed_launch_raises_without_fallback(fake_lib):
    """A nonzero CUDA error raises RuntimeError: no plain version runs and
    nothing is counted."""
    from repro_torch import device as rdev
    lib = fake_lib(err=700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops._launch(*_operands(64, 2, 16, 8)[:4], 32, None)
    assert len(lib.calls) == 1
    assert rdev.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("hd,N,match", [(24, 8, "head dims"),
                                        (16, 257, "d_state")])
def test_ssd_launch_refuses_what_the_kernel_does_not_take(fake_lib, hd, N,
                                                          match):
    lib = fake_lib()
    with pytest.raises(ValueError, match=match):
        ops._launch(*_operands(32, 2, hd, N)[:4], 16, None)
    assert lib.calls == []


def test_ssd_argtypes_match_c_declaration():
    import ctypes
    import pathlib
    import re
    text = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
            / "ssd_scan.cu").read_text()
    found = re.search(r'extern "C" int ssd_scan_fwd\(([^)]*)\)', text)
    assert found
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    assert len(params) == len(ops._ARGTYPES)
    for param, t in zip(params, ops._ARGTYPES):
        want = ctypes.c_void_p if "*" in param else ctypes.c_int
        assert param.startswith("int ") or "*" in param
        assert t is want, (param, t)
