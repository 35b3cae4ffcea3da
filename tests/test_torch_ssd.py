"""The port's SSD scan (plain version, CPU) against the JAX Pallas
kernel in interpret mode (``repro.kernels.ssd_scan``, as
tests/test_kernels.py runs it), the JAX ``ssd_chunked`` (both 1e-5: the
same chunked algorithm, sums in another order) and the sequential
oracle ``ssd_scan_ref`` (1e-3, as tests/test_kernels.py holds it).
Inputs come from a numpy seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

SHAPES = [(64, 2, 16, 8, 16), (128, 3, 32, 16, 32), (256, 1, 64, 32, 64),
          (100, 2, 16, 8, 128)]      # the last: S < chunk


def _inputs(S, H, hd, N, B=2, seed=0, init=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.3).astype(np.float32)
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
    x, dt, A_log, Bm, Cm = _inputs(S, H, hd, N, seed=S)
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
    x, dt, A_log, Bm, Cm = _inputs(S, H, hd, N, seed=S + 1)
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


def test_ssd_chunked_keeps_the_chunk_assert():
    x, dt, A_log, Bm, Cm = _inputs(40, 2, 16, 8)
    with pytest.raises(AssertionError):
        mamba2.ssd_chunked(*map(torch.tensor, (x, Bm, Cm, dt, A_log)), 16)
