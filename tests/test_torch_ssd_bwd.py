"""The SSD scan's backward on the CPU: ``ssd_scan``'s gradients in x,
dt, A_log, B, C and the initial state (autograd through the plain
version, what kernel F is held against on the card) against ``jax.vjp``
of ``repro.models.mamba2.ssd_chunked``; ``ssd_scan_bwd_plain`` against
autograd of ``ssd_scan_plain``; the heads-first decomposition that
kernel F computes (each head's W once, dS summed over heads by groups
before the dB and dC products) against ``ssd_scan_bwd_plain``; then
kernel F's launch path with a fake library standing in for the built
one (one C call a backward, counted once, the forward's scratch passed
on, no plain fallback, the scratch it allocates, the C declaration's
arguments).  Inputs come from a numpy seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

# (S, H, hd, N, chunk, init, decay): S < chunk, several chunks, hd 16
# and 32, an initial state, Mamba2's slow and fast decay draws (fast at
# chunks short enough that JAX's own gradient stays finite, below)
CASES = [(12, 2, 16, 8, 16, False, "fast"),
         (64, 2, 16, 8, 16, False, "fast"),
         (64, 3, 32, 16, 32, True, "fast"),
         (128, 2, 16, 16, 32, True, "slow"),
         (256, 2, 32, 24, 64, False, "slow"),
         (96, 4, 16, 32, 32, True, "slow")]


def _inputs(S, H, hd, N, init, decay, B=2, seed=0):
    """x, dt, A_log, B, C, init_state (or None), dy, dfinal.  "fast":
    dt = softplus(normal), A = -exp(0.3 normal), ~0.8 a step; "slow":
    as Mamba2 initialises them (per head dt log-uniform in [1e-3, 0.1],
    A = -uniform [1, 16]; dt times exp(0.5 normal) per step), where the
    state carried across chunks matters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd))
    if decay == "slow":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H)
                    + 0.5 * rng.standard_normal((B, S, H)))
        A_log = np.log(rng.uniform(1.0, 16.0, H))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        A_log = rng.standard_normal(H) * 0.3
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    st0 = rng.standard_normal((B, H, N, hd)) if init else None
    dy = rng.standard_normal((B, S, H, hd))
    dfinal = rng.standard_normal((B, H, N, hd))
    f32 = lambda a: None if a is None else a.astype(np.float32)  # noqa
    return [f32(a) for a in (x, dt, A_log, Bm, Cm, st0, dy, dfinal)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def _port_grads(x, dt, A_log, Bm, Cm, st0, dy, dfinal, chunk):
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dt, A_log, Bm,
                                                         Cm)]
    st = None if st0 is None else torch.tensor(st0, requires_grad=True)
    y, fs = ops.ssd_scan(*ins, chunk=chunk, init_state=st)
    grads = torch.autograd.grad([y, fs], ins + ([] if st is None else [st]),
                                [torch.tensor(dy), torch.tensor(dfinal)])
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("zero_dfinal", [False, True])
@pytest.mark.parametrize("S,H,hd,N,chunk,init,decay", CASES)
def test_ssd_grads_match_jax_vjp(S, H, hd, N, chunk, init, decay,
                                 zero_dfinal):
    """Gradients in x, dt, A_log, B, C (and the initial state) within
    1e-5 of each gradient's largest element (f32 both, sums in another
    order), for a random dy with a random or a zero final-state
    cotangent."""
    x, dt, A_log, Bm, Cm, st0, dy, dfinal = _inputs(S, H, hd, N, init,
                                                    decay, seed=S + N)
    if zero_dfinal:
        dfinal = np.zeros_like(dfinal)
    got = _port_grads(x, dt, A_log, Bm, Cm, st0, dy, dfinal, chunk)

    def f(x, Bm, Cm, dt, A_log, *st):
        return jm2.ssd_chunked(x, Bm, Cm, dt, A_log, chunk,
                               init_state=st[0] if st else None)
    args = [jnp.asarray(a) for a in (x, Bm, Cm, dt, A_log)] + (
        [] if st0 is None else [jnp.asarray(st0)])
    _, vjp = jax.vjp(f, *args)
    jg = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    want = [jg[0], jg[3], jg[4], jg[1], jg[2]] + list(jg[5:])
    names = ["x", "dt", "A_log", "B", "C", "init_state"]
    assert len(got) == len(want) == 5 + init
    for name, g, w in zip(names, got, want):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("S,chunk,init,with_dfinal", [
    (64, 16, True, True), (64, 16, False, False), (40, 64, True, False)])
def test_bwd_plain_is_autograd_of_the_plain_forward(S, chunk, init,
                                                    with_dfinal):
    """``ssd_scan_bwd_plain`` (and the wrapper on CPU tensors) give
    exactly autograd's gradients of ``ssd_scan_plain``; dfinal None is
    a zero cotangent, and dinit is None without an initial state."""
    x, dt, A_log, Bm, Cm, st0, dy, dfinal = _inputs(S, 3, 16, 8, init,
                                                    "slow", seed=7)
    xd, la = ops._operands(*map(torch.tensor, (x, dt, A_log)))
    Bt, Ct, dyt = map(torch.tensor, (Bm, Cm, dy))
    st = None if st0 is None else torch.tensor(st0)
    df = torch.tensor(dfinal) if with_dfinal else None
    got = ops.ssd_scan_bwd_plain(xd, la, Bt, Ct, st, dyt, df, chunk=chunk)
    wrapped = ops.ssd_scan_bwd(xd, la, Bt, Ct, st, dyt, df, chunk=chunk)
    ins = [t.clone().requires_grad_() for t in (xd, la, Bt, Ct)]
    sti = None if st is None else st.clone().requires_grad_()
    y, fs = ops.ssd_scan_plain(*ins, chunk, sti)
    out = (y * dyt).sum() + ((fs * df).sum() if with_dfinal else 0)
    want = torch.autograd.grad(out, ins + ([] if sti is None else [sti]))
    assert len(got) == 5 and (got[4] is None) == (not init)
    for a, b, c in zip(got, wrapped, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)


def test_fast_decay_over_a_long_chunk_stays_finite():
    """With a chunk of 256 fast-decay steps |cum| passes 88 inside a
    chunk: masked after the exp, exp(cum_i - cum_j) for j > i overflows
    and its gradient 0 * inf is NaN (JAX's autodiff of ``ssd_chunked``
    gives NaN in dt and A_log there).  The plain version masks before
    the exp: its f32 gradients are finite and within 1e-5 of the same
    computed in f64."""
    x, dt, A_log, Bm, Cm, st0, dy, dfinal = _inputs(256, 2, 16, 8, True,
                                                    "fast", B=1, seed=3)
    la = dt * -np.exp(A_log)
    assert np.cumsum(la, axis=1).min() < -88
    xd = x * dt[..., None]

    def grads(dtype):
        t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
        return ops.ssd_scan_bwd_plain(t(xd), t(la), t(Bm), t(Cm), t(st0),
                                      t(dy), t(dfinal), chunk=256)
    for name, g32, g64 in zip(("xd", "la", "B", "C", "init_state"),
                              grads(torch.float32), grads(torch.float64)):
        _close(g32.numpy(), g64.numpy(), 1e-5, name)


# ------------------------------------------- kernel F, with a fake library
class _FakeLib:
    """Stands in for the built libraries: records each C call's name and
    arguments and returns ``err`` for the backward (0 for the forward)."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def function(self, lib, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls.append((name, args))
            return self.err if name == "ssd_scan_bwd" else 0
        return fn


def _no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran for a kernel launch")


@pytest.fixture
def fake_lib(monkeypatch):
    """The launch paths on CPU tensors: a fake library, the stream call
    made without CUDA, and both plain versions forbidden."""
    from repro_torch import device as rdev

    def make(err=0):
        lib = _FakeLib(err)
        monkeypatch.setattr(ops.build, "function", lib.function)
        monkeypatch.setattr(ops.build, "cuda_call",
                            lambda fn, like, *args: fn(*args, 0))
        monkeypatch.setattr(ops, "ssd_scan_plain", _no_plain)
        monkeypatch.setattr(ops, "ssd_scan_bwd_plain", _no_plain)
        rdev.reset_launch_counts()
        return lib
    yield make
    rdev.reset_launch_counts()


def _function_inputs(S=192, H=2, hd=32, N=16, init=True):
    x, dt, A_log, Bm, Cm, st0, dy, dfinal = _inputs(S, H, hd, N, init,
                                                    "slow", B=1)
    xd, la = ops._operands(*map(torch.tensor, (x, dt, A_log)))
    ins = [t.contiguous().requires_grad_() for t in
           (xd, la, torch.tensor(Bm), torch.tensor(Cm))]
    st = None if st0 is None else torch.tensor(st0).requires_grad_()
    return ins, st, torch.tensor(dy), torch.tensor(dfinal)


@pytest.mark.parametrize("init,use_final", [(True, True), (False, False)])
def test_backward_is_one_c_call_on_the_forward_scratch(fake_lib, init,
                                                       use_final):
    """Through ``_SSDScan``: the forward is one ``ssd_scan_fwd`` call, the
    backward one ``ssd_scan_bwd`` call, each counted once.  The backward
    receives the forward's own operands and scratch (the states that
    hold each chunk's incoming state, the totals, C B^T: the same
    pointers), dy, dfinal (null when the final state is not used), the
    shapes with Q = min(chunk, S), and dinit only with an initial
    state."""
    from repro_torch import device as rdev
    lib = fake_lib()
    ins, st, dy, dfinal = _function_inputs(init=init)
    y, fs = ops._SSDScan.apply(*ins, st, 64)
    loss = (y * dy).sum() + ((fs * dfinal).sum() if use_final else 0)
    grads = torch.autograd.grad(loss, ins + ([st] if init else []))
    assert [c[0] for c in lib.calls] == ["ssd_scan_fwd", "ssd_scan_bwd"]
    fwd, bwd = lib.calls[0][1], lib.calls[1][1]
    assert bwd[0:4] == fwd[0:4]                   # xd, la, B, C
    assert bwd[4:7] == fwd[5:8]                   # states, totals, cb
    assert bwd[7] is not None and (bwd[8] is None) == (not use_final)
    assert (bwd[16] is None) == (not init)        # dinit
    assert bwd[17:23] == (1, 192, 2, 32, 16, 64) and bwd[23] == 0
    assert len(grads) == 4 + init
    assert grads[0].shape == ins[0].shape and grads[1].shape == ins[1].shape
    counts = rdev.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    assert sum(counts.values()) == 2


def test_saved_states_are_what_the_backward_receives(fake_lib,
                                                     monkeypatch):
    """The tensors the backward hands to the C call are the forward's
    scratch tensors themselves (no copy, no rerun of the pass)."""
    lib = fake_lib()
    kept = {}
    real = ops._launch

    def launch(*args, **kwargs):
        out = real(*args, **kwargs)
        kept["saved"] = out[2]
        return out
    monkeypatch.setattr(ops, "_launch", launch)
    ins, st, dy, _ = _function_inputs()
    y, _ = ops._SSDScan.apply(*ins, st, 64)
    torch.autograd.grad((y * dy).sum(), ins)
    bwd = lib.calls[-1][1]
    assert [t.data_ptr() for t in kept["saved"]] == list(bwd[4:7])
    assert kept["saved"][0].shape == (1, 3, 2, 16, 32)


def test_failed_backward_launch_raises_without_fallback(fake_lib):
    """A nonzero CUDA error from the backward raises RuntimeError: no
    plain version runs and the backward is not counted."""
    from repro_torch import device as rdev
    lib = fake_lib(err=700)
    ins, st, dy, _ = _function_inputs()
    y, _ = ops._SSDScan.apply(*ins, st, 64)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        torch.autograd.grad((y * dy).sum(), ins)
    assert [c[0] for c in lib.calls] == ["ssd_scan_fwd", "ssd_scan_bwd"]
    assert rdev.launch_counts()["ssd_scan_bwd"] == 0


def test_bwd_wrapper_on_cuda_needs_the_forward_scratch(fake_lib):
    """The public wrapper launches F on the scratch it is given, counted
    once; on a non-CPU tensor without it, it raises instead of rerunning
    anything."""
    from repro_torch import device as rdev
    lib = fake_lib()
    (xd, la, Bm, Cm), st, dy, dfinal = _function_inputs()
    xd, la, Bm, Cm = (t.detach() for t in (xd, la, Bm, Cm))
    _, _, saved = ops._launch(xd, la, Bm, Cm, 64, st, keep=True)
    out = ops._launch_bwd(xd, la, Bm, Cm, saved, dy, dfinal, 64, True)
    assert len(out) == 5 and out[4].shape == st.shape
    assert rdev.launch_counts()["ssd_scan_bwd"] == 1
    assert [c[0] for c in lib.calls] == ["ssd_scan_fwd", "ssd_scan_bwd"]
    meta = xd.to("meta")
    with pytest.raises(ValueError, match="saved"):
        ops.ssd_scan_bwd(meta, la, Bm, Cm, st, dy, dfinal, chunk=64)


def test_bwd_argtypes_match_c_declaration():
    import ctypes
    import pathlib
    import re
    text = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
            / "ssd_scan_bwd.cu").read_text()
    found = re.search(r'extern "C" int ssd_scan_bwd\(([^)]*)\)', text)
    assert found
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    assert len(params) == len(ops._BWD_ARGTYPES) == 24
    for param, t in zip(params, ops._BWD_ARGTYPES):
        want = ctypes.c_void_p if "*" in param else ctypes.c_int
        assert param.startswith("int ") or "*" in param
        assert t is want, (param, t)


def test_head_group_matches_the_cuda_source():
    """The wrapper sizes the dS scratch by the CUDA source's head group."""
    import pathlib
    import re
    text = (pathlib.Path(ops.__file__).resolve().parents[2] / "csrc"
            / "ssd_scan_bwd.cu").read_text()
    found = re.search(r"constexpr int HG = (\d+);", text)
    assert found and int(found.group(1)) == ops.HEAD_GROUP


def test_bwd_scratch_at_mamba2_train_shape(fake_lib, monkeypatch):
    """The scratch ``_launch_bwd`` allocates at mamba2-780m's train shape
    (B 4, S 4096, H 48, hd 64, N 128, Q 256), on the meta device: no
    (B, S, H, N) tensor, at most 0.35 GB beside the outputs, and every
    scratch pointer handed to the C call."""
    fake_lib()
    Bb, S, H, hd, N, Q = 4, 4096, 48, 64, 128, 256
    meta = dict(dtype=torch.float32, device="meta")
    xd = torch.zeros((Bb, S, H, hd), **meta)
    la = torch.zeros((Bb, S, H), **meta)
    Bm, Cm = torch.zeros((Bb, S, N), **meta), torch.zeros((Bb, S, N), **meta)
    saved = (torch.zeros((Bb, S // Q, H, N, hd), **meta),
             torch.zeros((Bb, S // Q, H), **meta),
             torch.zeros((Bb, S // Q, Q, Q), **meta))
    dy = torch.zeros_like(xd)
    dfinal = torch.zeros((Bb, H, N, hd), **meta)

    made = []

    class Recording:
        """``torch`` as the ops module sees it, recording what its
        ``empty`` and ``empty_like`` allocate."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def empty(*args, **kwargs):
            made.append(torch.empty(*args, **kwargs))
            return made[-1]

        @staticmethod
        def empty_like(*args, **kwargs):
            made.append(torch.empty_like(*args, **kwargs))
            return made[-1]
    monkeypatch.setattr(ops, "torch", Recording())
    out = ops._launch_bwd(xd, la, Bm, Cm, saved, dy, dfinal, Q, True)
    outs = {id(t) for t in out if t is not None}
    scratch = [t for t in made if id(t) not in outs]
    assert len(out) == 5 and len(scratch) == 3       # dst, dsg, parts
    assert all(tuple(t.shape) != (Bb, S, H, N) for t in made)
    total = sum(t.numel() * t.element_size() for t in scratch)
    assert total <= 0.35e9, total
    assert total == 4 * (Bb * S // Q * H * N * hd            # dst
                         + 6 * Bb * S // Q * Q * Q           # dsg: 6 groups
                         + 9 * Bb * S * H)                   # parts


def _heads_first(xd, la, Bm, Cm, st0, dy, dfinal, chunk, tile=64, group=8):
    """Kernel F's decomposition in torch (f32): per chunk, each head's
    W = (dy xd^T) o L once; dS = sum over groups of `group` heads (in
    group order) of the group's heads' W (in head order); dC = dS B +
    sum_h diag(exp(cum_h)) dy_h prev_h^T, dB = dS^T C + sum_h
    diag(exp(total_h - cum_h)) xd_h G_h^T (heads in order); dxd per head;
    dcum from each head's row sums of W o C B^T, its column sums split by
    `tile`-row tiles and added in tile order, the dy . (C prev) terms
    split by `tile` columns of N and added in order, and the
    xd . (B G) terms; G from the reverse pass over the chunks."""
    Bb, S, H, hd = xd.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    x = xd.reshape(Bb, nc, Q, H, hd)
    y = dy.reshape(Bb, nc, Q, H, hd)
    Bc, Cc = Bm.reshape(Bb, nc, Q, N), Cm.reshape(Bb, nc, Q, N)
    cum = torch.cumsum(la.reshape(Bb, nc, Q, H), dim=2)         # (B,c,Q,H)
    total = cum[:, :, -1]                                       # (B,c,H)
    ecum = torch.exp(cum)
    erev = torch.exp(total[:, :, None] - cum)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,c,i,j,H)
    L = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              float("-inf")))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)

    # the forward's states entering each chunk
    cstate = torch.einsum("bcjh,bcjn,bcjhp->bchnp", erev, Bc, x)
    st = (torch.zeros((Bb, H, N, hd)) if st0 is None else st0)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(total[:, c])[:, :, None, None] + cstate[:, c]
    prev = torch.stack(prev, dim=1)                             # (B,c,H,N,hd)

    # the reverse pass: G_c, dinit
    u = torch.einsum("bcin,bcih,bcihp->bchnp", Cc, ecum, y)
    g = torch.zeros((Bb, H, N, hd)) if dfinal is None else dfinal
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = g
        g = g * torch.exp(total[:, c])[:, :, None, None] + u[:, c]
    G = torch.stack(G, dim=1)

    W = torch.einsum("bcihp,bcjhp->bcijh", y, x) * L            # per head
    dS = torch.zeros((Bb, nc, Q, Q))
    for g0 in range(0, H, group):
        part = torch.zeros((Bb, nc, Q, Q))
        for h in range(g0, min(H, g0 + group)):
            part = part + W[..., h]
        dS = dS + part
    dC = torch.einsum("bcij,bcjn->bcin", dS, Bc)
    dB = torch.einsum("bcij,bcin->bcjn", dS, Cc)
    hC = torch.zeros_like(dC)
    hB = torch.zeros_like(dB)
    for h in range(H):
        hC = hC + ecum[..., h, None] * torch.einsum(
            "bcip,bcnp->bcin", y[:, :, :, h], prev[:, :, h])
        hB = hB + erev[..., h, None] * torch.einsum(
            "bcjp,bcnp->bcjn", x[:, :, :, h], G[:, :, h])
    dC, dB = dC + hC, dB + hB

    BG = torch.einsum("bcjn,bchnp->bcjhp", Bc, G)
    dxd = (torch.einsum("bcij,bcijh,bcihp->bcjhp", CB, L, y)
           + erev[..., None] * BG)
    P = W * CB[..., None]                                       # (B,c,i,j,H)
    rows = P.sum(dim=3)
    cols = torch.zeros_like(rows)
    for i0 in range(0, Q, tile):
        cols = cols + P[:, :, i0:i0 + tile].sum(dim=2)
    Cprev = torch.einsum("bcin,bchnp->bcihnp", Cc, prev)
    rterm = torch.zeros_like(rows)
    for n0 in range(0, N, tile):
        rterm = rterm + ecum * torch.einsum(
            "bcihp,bcihnp->bcih", y, Cprev[:, :, :, :, n0:n0 + tile])
    sterm = erev * (x * BG).sum(-1)
    dcum = rows + rterm - cols - sterm
    dtotal = torch.exp(total) * (prev * G).sum((-2, -1)) + sterm.sum(2)
    dcum[:, :, -1] += dtotal
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    return (dxd.reshape(Bb, S, H, hd), dla.reshape(Bb, S, H),
            dB.reshape(Bb, S, N), dC.reshape(Bb, S, N),
            None if st0 is None else g)


@pytest.mark.parametrize("S,H,hd,N,chunk,init,decay,with_dfinal", [
    (256, 3, 16, 16, 128, False, "slow", True),     # 2 chunks, 2 row tiles
    (256, 2, 16, 8, 256, False, "fast", True),      # |cum| past 88
    (100, 2, 16, 8, 256, False, "slow", True),      # Q 100 < chunk
    (192, 2, 32, 16, 64, True, "slow", True),       # an initial state
    (128, 2, 16, 128, 64, True, "slow", True),      # N 128: 2 state tiles
    (128, 10, 16, 8, 64, False, "slow", False),     # 2 head groups, no dfinal
])
def test_heads_first_decomposition_matches_plain(S, H, hd, N, chunk, init,
                                                 decay, with_dfinal):
    """The algebra kernel F computes, written out in torch
    (``_heads_first``), gives ``ssd_scan_bwd_plain``'s gradients within
    1e-5 of each output's largest element (f32 both, sums in another
    order)."""
    x, dt, A_log, Bm, Cm, st0, dy, dfinal = _inputs(S, H, hd, N, init,
                                                    decay, B=1, seed=S + H)
    xd, la = ops._operands(*map(torch.tensor, (x, dt, A_log)))
    if decay == "fast":
        assert torch.cumsum(la, 1).min() < -88
    Bt, Ct, dyt = map(torch.tensor, (Bm, Cm, dy))
    st = None if st0 is None else torch.tensor(st0)
    df = torch.tensor(dfinal) if with_dfinal else None
    got = _heads_first(xd, la, Bt, Ct, st, dyt, df, chunk)
    want = ops.ssd_scan_bwd_plain(xd, la, Bt, Ct, st, dyt, df, chunk=chunk)
    assert (got[4] is None) == (want[4] is None) == (not init)
    for name, g, w in zip(("dxd", "dla", "dB", "dC", "dinit"), got, want):
        if w is not None:
            _close(g.numpy(), w.numpy(), 1e-5, name)
