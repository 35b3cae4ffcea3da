"""The Mamba2 SSD scan in its chunked form: y and the final state of
the recurrence state_t = exp(la_t) state_{t-1} + B_t (x) xd_t,
y_t = C_t . state_t, per batch element and head.

Counterpart of ``src/repro/kernels/ssd_scan/ops.py`` ``ssd_scan`` (the
Pallas kernel ``_kernel`` / ``ssd_scan_pallas`` in ``ssd_scan.py``),
the same math as ``repro.models.mamba2.ssd_chunked``.  ``ssd_scan`` is
the public entry: it forms the kernel's operands xd = x * dt and
la = dt * -exp(A_log) in f32 (plain autograd, as JAX differentiates
them), then on CUDA tensors runs ``_SSDScan``: its forward launches
``csrc/ssd_scan.cu`` (three CUDA kernels, counted as one launch of the
wrapper: chunk states and C B^T, the pass over the states, chunk
outputs), its backward ``csrc/ssd_scan_bwd.cu`` (six CUDA kernels,
counted as one launch of ``ssd_scan_bwd``), which JAX's autodiff of
``ssd_chunked`` computes in XLA.  CPU tensors run ``ssd_scan_plain``,
which autograd differentiates.  Meta tensors (the dry run,
``launch/dryrun.py``) run it too, through ``_SSDScanMeta``: one op of
``distributed/cost.py``'s count forward and one backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import count_launch
from repro_torch.distributed.cost import meta_op
from repro_torch.kernels import build

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
# the C B^T scratch's rows and columns are Q rounded up to this: the
# square tile of C B^T that the CUDA source forms at a time (its RT)
ROW_TILE = 64
# heads a block of kernel F's W kernel sums into its group's dS (the
# CUDA source's HG)
HEAD_GROUP = 8


def ssd_scan_plain(xd, la, B_, C_, chunk: int, init_state=None):
    """Plain PyTorch version, any device: ``ssd_chunked``'s chunked
    matmul form, with the scan over chunk states as a loop.

    xd (B, S, H, hd), la (B, S, H), B_ / C_ (B, S, N), all f32; the
    chunk Q = min(chunk, S) must divide S.  Returns (y (B, S, H, hd),
    final state (B, H, N, hd)), f32."""
    Bb, S, H, hd = xd.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    c = S // Q
    la_c = la.reshape(Bb, c, Q, H)
    x_c = xd.reshape(Bb, c, Q, H, hd)
    B_c = B_.reshape(Bb, c, Q, N)
    C_c = C_.reshape(Bb, c, Q, N)

    cum = torch.cumsum(la_c, dim=2)                            # (B,c,Q,H)
    total = cum[:, :, -1, :]                                   # (B,c,H)

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i-cum_j) x_j; the
    # entries j > i are masked before the exp (exp(-inf) = 0): masked
    # after it, exp(diff) overflows once diff > 88 and its gradient
    # 0 * inf is NaN, as in JAX's autodiff of ``ssd_chunked``
    CB = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,c,i,j,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xd.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  float("-inf")))
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", CB, decay, x_c)

    # end-of-chunk states: sum_j exp(total-cum_j) B_j (x) x_j
    dte = torch.exp(total[:, :, None, :] - cum)                # (B,c,Q,H)
    cstate = torch.einsum("bcjh,bcjn,bcjhp->bchnp", dte, B_c, x_c)

    st = (torch.zeros((Bb, H, N, hd), dtype=torch.float32, device=xd.device)
          if init_state is None else init_state.float())
    prev = []
    for i in range(c):
        prev.append(st)
        st = st * torch.exp(total[:, i])[:, :, None, None] + cstate[:, i]
    prev = torch.stack(prev, dim=1)                            # (B,c,H,N,hd)

    y_inter = torch.einsum("bcih,bcin,bchnp->bcihp", torch.exp(cum), C_c,
                           prev)
    y = (y_intra + y_inter).reshape(Bb, S, H, hd)
    return y, st


def _operands(x, dt, A_log):
    A = -torch.exp(A_log.float())
    la = dt.float() * A
    xd = x.float() * dt.float()[..., None]
    return xd, la


def _check(x, dt, A_log, B_, C_, chunk, init_state):
    if x.dim() != 4 or dt.dim() != 3 or B_.dim() != 3:
        raise ValueError("ssd_scan takes x (B, S, H, hd), dt (B, S, H), "
                         "A_log (H,) and B_, C_ (B, S, N)")
    Bb, S, H, hd = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bb, S, H) or A_log.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A_log "
                         f"{tuple(A_log.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if B_.shape != (Bb, S, N) or C_.shape != (Bb, S, N):
        raise ValueError(f"B_ {tuple(B_.shape)} / C_ {tuple(C_.shape)} "
                         f"must be {(Bb, S, N)}")
    if init_state is not None and init_state.shape != (Bb, H, N, hd):
        raise ValueError(f"init_state {tuple(init_state.shape)} must be "
                         f"{(Bb, H, N, hd)}")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} does not divide S={S}")
    devs = {t.device for t in (x, dt, A_log, B_, C_)
            + (() if init_state is None else (init_state,))}
    if len(devs) != 1:
        raise ValueError("ssd_scan inputs lie on different devices")


def _launch(xd, la, B_, C_, chunk, init_state, keep=False):
    """The forward kernel on xd, la (B, S, H), B_, C_ (B, S, N).  Returns
    (y, final state), and with ``keep`` also the scratch the backward
    takes: (states, the state entering each chunk; totals; C B^T)."""
    Bb, S, H, hd = xd.shape
    N = B_.shape[-1]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if N > 256:
        raise ValueError(f"the CUDA kernel takes d_state <= 256, got {N}")
    Q = min(chunk, S)
    B_ = B_.float().contiguous()
    C_ = C_.float().contiguous()
    st0 = None if init_state is None else init_state.float().contiguous()
    fn = build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    # scratch: each chunk's own end state, then (in place) the state
    # entering it; each chunk's total log decay; each chunk's C B^T, its
    # rows and columns padded to whole tiles
    states = torch.empty((Bb, S // Q, H, N, hd), dtype=torch.float32,
                         device=xd.device)
    totals = torch.empty((Bb, S // Q, H), dtype=torch.float32,
                         device=xd.device)
    QP = -(-Q // ROW_TILE) * ROW_TILE
    cb = torch.empty((Bb, S // Q, QP, QP), dtype=torch.float32,
                     device=xd.device)
    y = torch.empty_like(xd)
    final = torch.empty((Bb, H, N, hd), dtype=torch.float32,
                        device=xd.device)
    err = build.cuda_call(
        fn, xd, xd.data_ptr(), la.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), None if st0 is None else st0.data_ptr(),
        states.data_ptr(), totals.data_ptr(), cb.data_ptr(), y.data_ptr(),
        final.data_ptr(), Bb, S, H, hd, N, Q)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    count_launch(ssd_scan)
    if keep:
        return y, final, (states, totals, cb)
    return y, final


def _launch_bwd(xd, la, B_, C_, saved, dy, dfinal, chunk, need_dinit):
    """Kernel F on the forward's operands and ``saved`` scratch (states,
    totals, C B^T from ``_launch(..., keep=True)``), the cotangents dy
    (B, S, H, hd) and dfinal (B, H, N, hd; None: zero, its work skipped).
    Returns (dxd, dla, dB, dC, dinit or None).

    Scratch, f32: ``dst`` (B, S/Q, H, N, hd), each chunk's own part of
    dprev, then (in place) the cotangent of the state leaving it; ``dsg``
    (NG, B, S/Q, QP, QP), NG = ceil(H / 8), each group of 8 heads' sum of
    W = (dy xd^T) o L over its heads, QP = Q rounded up to 64; ``parts``
    (3 + QP/64 + ceil(N/64), B, S, H), per step and head: cum, the row
    sums, the xd . (B G) terms, the column sums per 64-row tile, the
    dy . (C prev) terms per 64 columns of N.  At mamba2-780m's train shape
    (B 4, S 4096, H 48, hd 64, N 128, Q 256) that is 100.7 + 100.7 + 28.3
    MB; nothing of shape (B, S, H, N)."""
    states, totals, cb = saved
    Bb, S, H, hd = xd.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    dev = xd.device
    dy = dy.float().contiguous()
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    fn = build.function("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    QP = -(-Q // ROW_TILE) * ROW_TILE
    groups = -(-H // HEAD_GROUP)
    planes = 3 + QP // ROW_TILE + -(-N // ROW_TILE)
    dst = torch.empty_like(states)
    dsg = torch.empty((groups, Bb, S // Q, QP, QP), dtype=torch.float32,
                      device=dev)
    parts = torch.empty((planes, Bb, S, H), dtype=torch.float32, device=dev)
    dxd, dla = torch.empty_like(xd), torch.empty_like(la)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    dinit = (torch.empty((Bb, H, N, hd), dtype=torch.float32, device=dev)
             if need_dinit else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.cuda_call(
        fn, xd, *map(ptr, (xd, la, B_, C_, states, totals, cb, dy, dfinal,
                           dst, dsg, parts, dxd, dla, dB, dC, dinit)),
        Bb, S, H, hd, N, Q)
    if err:
        raise RuntimeError(
            f"ssd_scan_bwd kernel launch failed: CUDA error {err}")
    count_launch(ssd_scan_bwd)
    return dxd, dla, dB, dC, dinit


class _SSDScan(torch.autograd.Function):
    """The scan over the kernel's operands (xd, la, B_, C_ f32 and
    contiguous, init_state or None): the forward kernel, and kernel F
    for the gradients.  The forward's scratch (the state entering each
    chunk, the chunk totals, C B^T) is saved, so the backward does not
    rerun the pass over the chunks."""

    @staticmethod
    def forward(ctx, xd, la, B_, C_, init_state, chunk):
        y, final, saved = _launch(xd, la, B_, C_, chunk, init_state,
                                  keep=True)
        ctx.save_for_backward(xd, la, B_, C_, *saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        xd, la, B_, C_, *saved = ctx.saved_tensors
        if dy is None and dfinal is None:
            return None, None, None, None, None, None
        if dy is None:
            dy = torch.zeros_like(xd)
        dxd, dla, dB, dC, dinit = _launch_bwd(
            xd, la, B_, C_, saved, dy, dfinal, ctx.chunk,
            ctx.needs_input_grad[4])
        return dxd, dla, dB, dC, dinit, None


class _SSDScanMeta(torch.autograd.Function):
    """The scan on meta tensors: ``ssd_scan_plain`` as one op of the dry
    run's count, and its gradient, from the graph the forward kept (as
    JAX's autodiff keeps its residuals), as one op of the backward."""

    @staticmethod
    def forward(ctx, xd, la, B_, C_, init_state, chunk):
        ins = [t.detach().requires_grad_() for t in (xd, la, B_, C_)]
        st0 = (None if init_state is None
               else init_state.detach().float().requires_grad_())

        def run():
            with torch.enable_grad():
                return ssd_scan_plain(*ins, chunk, st0)
        y, final = meta_op("ssd_scan", run, xd, la, B_, C_, init_state)
        ctx.graph = (ins + ([] if st0 is None else [st0]), y, final)
        ctx.set_materialize_grads(False)
        return y.detach(), final.detach()

    @staticmethod
    def backward(ctx, dy, dfinal):
        ins, y, final = ctx.graph
        del ctx.graph
        pairs = [(o, g) for o, g in ((y, dy), (final, dfinal))
                 if g is not None]
        if not pairs:
            return None, None, None, None, None, None
        outs, cots = zip(*pairs)
        grads = meta_op("ssd_scan_bwd", lambda: torch.autograd.grad(
            outs, ins, cots, allow_unused=True), *ins, *cots)
        return (*grads[:4], grads[4] if len(grads) > 4 else None, None)


def ssd_scan(x, dt, A_log, B_, C_, *, chunk: int, init_state=None):
    """x (B, S, H, hd); dt (B, S, H) post-softplus; A_log (H,); B_ / C_
    (B, S, N) shared by the heads; optional init_state (B, H, N, hd).
    Returns (y (B, S, H, hd), final state (B, H, N, hd)), f32.  The chunk
    Q = min(chunk, S) must divide S.  CUDA tensors launch the kernels (hd
    in 16, 32, 64, 128; d_state <= 256), forward and backward
    (``_SSDScan``); CPU tensors run ``ssd_scan_plain``, which autograd
    differentiates."""
    _check(x, dt, A_log, B_, C_, chunk, init_state)
    xd, la = _operands(x, dt, A_log)
    B_, C_ = B_.float(), C_.float()
    if x.device.type == "cpu":
        return ssd_scan_plain(xd, la, B_, C_, chunk, init_state)
    if x.device.type == "meta":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xd, la, B_, C_, init_state)):
            return _SSDScanMeta.apply(xd, la, B_, C_, init_state, chunk)
        return meta_op("ssd_scan", lambda: ssd_scan_plain(
            xd, la, B_, C_, chunk, init_state), xd, la, B_, C_, init_state)
    st0 = None if init_state is None else init_state.float().contiguous()
    return _SSDScan.apply(xd.contiguous(), la.contiguous(), B_.contiguous(),
                          C_.contiguous(), st0, chunk)


ssd_scan.launches = 0


def ssd_scan_bwd_plain(xd, la, B_, C_, init_state, dy, dfinal, *,
                       chunk: int):
    """Plain version of kernel F, any device: the gradients of
    ``ssd_scan_plain``'s (y, final state) for the cotangents dy and
    dfinal (None: zero) by ``torch.autograd.grad``.  Returns (dxd, dla,
    dB, dC, dinit or None, without init_state), f32."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_()
               for t in (xd, la, B_, C_)]
        st0 = (None if init_state is None
               else init_state.detach().float().requires_grad_())
        y, final = ssd_scan_plain(*ins, chunk, st0)
        outs, cots = [y], [dy.float()]
        if dfinal is not None:
            outs.append(final)
            cots.append(dfinal.float())
        grads = torch.autograd.grad(outs, ins + ([] if st0 is None
                                                 else [st0]), cots)
    return tuple(grads) + ((None,) if st0 is None else ())


def ssd_scan_bwd(xd, la, B_, C_, init_state, dy, dfinal, *, chunk: int,
                 saved=None):
    """Kernel F's wrapper: the gradients (dxd, dla, dB, dC, dinit or
    None) of the scan over its operands for the cotangents dy and dfinal
    (None: zero).  CPU tensors run ``ssd_scan_bwd_plain``; CUDA tensors
    launch ``csrc/ssd_scan_bwd.cu`` on ``saved``, the forward's scratch
    from ``_launch(..., keep=True)``, and raise without it."""
    if xd.device.type == "cpu":
        return ssd_scan_bwd_plain(xd, la, B_, C_, init_state, dy, dfinal,
                                  chunk=chunk)
    if saved is None:
        raise ValueError("ssd_scan_bwd on CUDA takes the forward's scratch "
                         "(saved=...) from _launch(..., keep=True)")
    return _launch_bwd(xd, la, B_, C_, saved, dy, dfinal, chunk,
                       init_state is not None)


ssd_scan_bwd.launches = 0
