"""Collectives on shards: what the JAX package's sharding constraints
mean, done explicitly, one process per card.

The JAX package states a layout (``distributed/rules.py`` ``wsc``, and
``NamedSharding`` on the parameters) and GSPMD inserts the collectives
(``src/repro/models/transformer.py:95-123``,
``src/repro/training/train_step.py:37-39``).  PyTorch has neither, so
this module holds the operations that layout implies, over a
``launch.mesh.ProcessMesh``:

- ``shard_tree`` / ``gather_tree``: a leaf cut along each dim by the mesh
  axes its spec names (a tuple of axes in its order, the first major),
  as ``NamedSharding`` cuts it, and put back together by all-gathers
  (checkpoints, ``LMBase.load_serving``);
- ``gather_data``: FSDP as GSPMD runs JAX's scanned layers, one unit at a
  time: a leaf's shard all-gathered over the data axes where it is used,
  its gradient reduce-scattered back to the shard in the backward;
  ``fsdp_counts`` counts both; ``gather_model``, the same rule over
  "model" for a block that runs whole on every rank of it;
- Megatron's f and g (``copy_to_model``: identity forward, all-reduce
  over "model" backward; ``reduce_from_model``: all-reduce forward in
  f32, cast once, identity backward) and ``matmul_f32`` / ``bmm_f32``,
  the row-parallel products whose partial outputs are f32;
- the sequence-parallel ends: all-gathers on S whose gradient is a
  reduce-scatter (``gather_seq``, Megatron-SP's f) or this rank's rows
  (``gather_seq_replicated``), and the reduce-scatter whose gradient is
  an all-gather (``scatter_seq``, Megatron-SP's g), and this rank's rows
  of a tensor whole on every rank (``keep_seq_rows``, the gradient
  all-gathered); ``TensorParallel``
  picks a model's entry and exit to a split block by its plan;
- ``rms_norm_cut``: ``models/common.py`` ``rms_norm`` over a dim cut
  over "model" (Mamba2's gated norm over its d_in);
- ``SeqCut`` / ``seq_cut``: a serving cache's sequence dim cut over mesh
  axes (the partial-softmax decode's reduction), and ``padded_rows``,
  the blocks of ceil(S/m) rows a prefill of any length takes;
- the vocab-parallel embedding lookup and cross-entropy
  (``models/common.py`` ``embed`` / ``chunked_xent`` with the vocab cut
  over "model");
- ``reduce_grads``: what the gradient rule of a sharded train step
  leaves to the end of the step, once ``gather_data``'s backward has
  cut each leaf's gradient to its shard; ``global_token_counts``, the
  masked step's token count per global microbatch (``token_reduces``
  counts its all-reduces);
- ``all_reduce_`` / ``mean_over``: the sums and means over sharded dims
  the optimizer needs.

An axis of size 1 has no process group and no collective crosses it: at
one rank every operation here is the identity or a plain local op.
Every rank must make the same collective calls in the same order, as
SPMD programs do.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.utils.params import tree_from_flat, tree_leaves

NEG_INF = -1e30


def entry_axes(entry) -> tuple:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def dim_axes(spec, ndim: int):
    """The mesh axes cutting each of ``ndim`` dims (replicated past the
    spec's end)."""
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [entry_axes(e) for e in spec] + [()] * (ndim - len(spec))


def _live(mesh, axes):
    return tuple(a for a in axes if mesh.shape[a] > 1)


def live_axes(mesh, entry) -> tuple:
    """The axes of size > 1 of a spec entry (none without a mesh)."""
    return () if mesh is None else _live(mesh, entry_axes(entry))


def spec_axes(spec, mesh) -> tuple:
    """Every axis of size > 1 that cuts some dim of a leaf of ``spec``."""
    return _live(mesh, [a for e in tuple(spec or ()) for a in entry_axes(e)])


def _index(mesh, axes) -> int:
    """Row-major index of this rank's block over ``axes``."""
    coords, i = mesh.coords, 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def block(x, dim: int, mesh, axes):
    """This rank's block of dim ``dim`` of ``x`` (a tensor or a numpy
    array; a view) cut over ``axes``."""
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axes} ({n} shards)")
    size = x.shape[dim] // n
    i = _index(mesh, axes) * size
    return x[(slice(None),) * dim + (slice(i, i + size),)]


def block_offsets(local_shape, spec, mesh) -> tuple:
    """The global index of this rank's first element along each dim of a
    leaf whose shard has ``local_shape`` (its spec ``spec``)."""
    return tuple(n * _index(mesh, _live(mesh, axes)) for n, axes in
                 zip(local_shape, dim_axes(spec, len(local_shape))))


def global_shape(local_shape, spec, mesh) -> tuple:
    """The full shape of a leaf whose shard on this rank has
    ``local_shape``."""
    return tuple(n * math.prod(mesh.shape[a] for a in axes)
                 for n, axes in zip(local_shape,
                                    dim_axes(spec, len(local_shape))))


# ------------------------------------------------------------ collectives
def all_reduce_(x, mesh, axes, op=dist.ReduceOp.SUM):
    """``x`` reduced in place over each axis of size > 1 in ``axes``."""
    for a in _live(mesh, entry_axes(axes)):
        dist.all_reduce(x, op=op, group=mesh.groups[a])
    return x


def all_gather(x, dim: int, mesh, axis: str):
    """The blocks of ``axis``'s ranks joined along dim ``dim``, in rank
    order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts, dim)


def _reduce_scatter(x, dim: int, mesh, axis: str):
    """The sum over ``axis`` of ``x``, this rank's block of dim ``dim``."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axis} ({n} shards)")
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + inp.shape[1:])
    dist.reduce_scatter_tensor(out, inp, group=mesh.groups[axis])
    return out.movedim(0, dim).contiguous()


def mean_over(x, dim: int, mesh, axes, keepdim: bool = False):
    """The mean over dim ``dim`` of the full tensor whose shard is ``x``
    (the dim cut over ``axes``): ``x.mean(dim)`` when nothing cuts it
    (``mesh`` may then be None), else the local sums all-reduced over
    the cutting axes over the full length."""
    live = _live(mesh, axes)
    if not live:
        return x.mean(dim=dim, keepdim=keepdim)
    s = x.sum(dim=dim, keepdim=keepdim)
    all_reduce_(s, mesh, live)
    return s / (x.shape[dim] * math.prod(mesh.shape[a] for a in live))


# ------------------------------------------------------------------ trees
def shard_leaf(x, spec, mesh):
    """This rank's shard of the full leaf ``x`` (a copy where cut, so the
    full tensor can be freed; ``x`` itself where nothing cuts it)."""
    out = x
    for d, axes in enumerate(dim_axes(spec, x.ndim)):
        out = block(out, d, mesh, _live(mesh, axes))
    return out if out is x else out.clone(
        memory_format=torch.contiguous_format)


def _cuts(spec, ndim, mesh, axes=None):
    """(dim, axis) of each axis of size > 1 (of ``axes`` when given) that
    cuts a dim of a leaf of ``spec``, the major axis of a dim first."""
    return [(d, a) for d, cut in enumerate(dim_axes(spec, ndim))
            for a in _live(mesh, cut) if axes is None or a in axes]


def gather_leaf(x, spec, mesh, axes=None):
    """The leaf whose shard is ``x`` gathered over the axes of size > 1
    that cut it (only those in ``axes`` when given)."""
    for d, a in reversed(_cuts(spec, x.ndim, mesh, axes)):
        x = all_gather(x, d, mesh, a)           # the minor axis first
    return x


def _specs_by_name(specs):
    return dict(tree_leaves(specs))


def shard_tree(full, specs, mesh):
    """Each leaf of ``full`` cut to this rank's shard by its spec in
    ``specs`` (a tree of the same keys)."""
    sp = _specs_by_name(specs)
    return tree_from_flat(full, {n: shard_leaf(x, sp[n], mesh)
                                 for n, x in tree_leaves(full)})


def gather_tree(local, specs, mesh, axes=None):
    """The full leaves (over ``axes`` only, when given) of a tree of
    shards: ``gather_tree(shard_tree(t, s, m), s, m)`` equals ``t``."""
    sp = _specs_by_name(specs)
    return tree_from_flat(local, {n: gather_leaf(x, sp[n], mesh, axes)
                                  for n, x in tree_leaves(local)})


# ------------------------------------------- FSDP, one unit at a time
_FSDP_KEYS = ("all_gather", "all_gather_max_bytes", "all_gather_max_numel",
              "reduce_scatter", "reduce_scatter_max_bytes")
_fsdp = dict.fromkeys(_FSDP_KEYS, 0)


def reset_fsdp_counts() -> None:
    """Zero ``fsdp_counts``."""
    _fsdp.update(dict.fromkeys(_FSDP_KEYS, 0))


def fsdp_counts() -> dict:
    """The all-gathers and reduce-scatters ``gather_data`` made over the
    data axes since ``reset_fsdp_counts``: each count, and the largest
    tensor each gathered (its bytes and elements) or reduce-scattered
    (the full tensor's bytes)."""
    return dict(_fsdp)


def _count(kind, x):
    _fsdp[kind] += 1
    nbytes = x.numel() * x.element_size()
    _fsdp[kind + "_max_bytes"] = max(_fsdp[kind + "_max_bytes"], nbytes)
    if kind == "all_gather":
        _fsdp["all_gather_max_numel"] = max(_fsdp["all_gather_max_numel"],
                                            x.numel())


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cuts, mesh, batch, count=True):
        ctx.cuts, ctx.mesh, ctx.batch = cuts, mesh, batch
        for d, a in reversed(cuts):              # the minor axis first
            x = all_gather(x, d, mesh, a)
            if count:
                _count("all_gather", x)
        return x

    @staticmethod
    def backward(ctx, g):
        for d, a in ctx.cuts:                    # the major axis first
            if a in ctx.batch:
                _count("reduce_scatter", g)
                g = _reduce_scatter(g, d, ctx.mesh, a)
            else:
                g = block(g, d, ctx.mesh, (a,)).contiguous()
        return g, None, None, None, None


def gather_data(x, spec, mesh, data_axes, batch_axes):
    """The leaf whose shard is ``x`` (its spec ``spec``) gathered over the
    axes of size > 1 of ``data_axes`` that cut it, as GSPMD gathers a
    ``NamedSharding`` leaf where a scanned layer uses it; ``x`` itself
    where none cuts it.  The backward is the first half of the gradient
    rule (``reduce_grads`` the second): along a batch axis that cuts the
    leaf, the full gradient of this rank's rows summed over the axis and
    cut to this rank's block (a reduce-scatter); along a data axis that
    is not a batch axis, this rank's block (the gradients are equal on
    its ranks).  Nothing else: the sums over "model" and over the batch
    axes that cut nothing, and the division by the batch shards, are
    ``reduce_grads``', once a step on the shard."""
    cuts = _cuts(spec, x.ndim, mesh, tuple(data_axes))
    if not cuts:
        return x
    return _GatherData.apply(x, cuts, mesh, _live(mesh, entry_axes(
        batch_axes)))


def gather_model(x, spec, mesh, axis: str = "model"):
    """The leaf whose shard is ``x`` gathered over ``axis`` where its spec
    cuts it (``x`` itself where it does not), for a block that runs
    whole on every rank of the axis: ``gather_data``'s rule along an
    axis that is not a batch axis, so the backward takes this rank's
    block of the gradient, whole and equal on every rank.  Not counted
    in ``fsdp_counts``."""
    cuts = _cuts(spec, x.ndim, mesh, (axis,))
    if not cuts:
        return x
    return _GatherData.apply(x, cuts, mesh, (), False)


# ------------------------------------------------- Megatron's f and g
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand one gradient tensor to several inputs
        s = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(s, group=ctx.mesh.groups[ctx.axis])
        return s.to(g.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dtype):
        s = x.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(s, group=mesh.groups[axis])
        ctx.in_dtype = x.dtype
        return s.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None, None


def copy_to_model(x, mesh, axis: str = "model"):
    """f: the identity forward; the gradient all-reduced over ``axis``
    (summed in f32, cast back once), where each rank's part of the
    gradient came through its own heads, columns or vocab shard."""
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x, mesh, dtype, axis: str = "model"):
    """g: a row-parallel partial output ``x`` (f32) summed over ``axis``
    in f32 and cast once to ``dtype``; the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, mesh, axis, dtype)


class _BmmF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if a.dtype == torch.float32:
            return torch.bmm(a, w)
        if a.is_cuda:
            return torch.bmm(a, w, out_dtype=torch.float32)
        return torch.bmm(a.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g.bmm(w.transpose(1, 2)), a.transpose(1, 2).bmm(g)


def bmm_f32(a, w):
    """``torch.bmm(a, w)`` (one dtype) with an f32 output, as
    ``matmul_f32``: a batch of row-parallel partial outputs whose sum
    over ranks rounds once."""
    return _BmmF32.apply(a, w)


class _MatmulF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.dtype == torch.float32:
            out = a2 @ w
        elif a.is_cuda:
            out = torch.mm(a2, w, out_dtype=torch.float32)
        else:
            out = a2.float() @ w.float()
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        a2 = a.reshape(-1, a.shape[-1])
        return (g2.mm(w.t()).reshape(a.shape), a2.t().mm(g2))


def matmul_f32(a, w):
    """``a @ w`` (a: (..., K), w: (K, N), one dtype) with an f32 output:
    the products summed in f32 and not rounded to ``a``'s dtype, so a
    sum of such partial outputs over ranks rounds once.  Its gradients
    are ``a @ w``'s, in ``a``'s dtype."""
    return _MatmulF32.apply(a, w)


# ------------------------------------------- the sequence-parallel ends
def seq_rows(S: int, mesh, axis: str = "model") -> slice:
    """This rank's block of ``S`` sequence positions cut over ``axis``."""
    n = mesh.shape[axis]
    if S % n:
        raise ValueError(f"sequence length {S} does not split over {axis} "
                         f"({n} shards)")
    r = mesh.coords[axis] * (S // n)
    return slice(r, r + S // n)


def padded_rows(S: int, mesh, axis: str = "model"):
    """(first row, rows a rank) of this rank's block of ``S`` positions
    cut over ``axis`` into blocks of ceil(S / n), as GSPMD pads an
    uneven dim: the last blocks may run past S (their rows are padding,
    trimmed after ``all_gather``)."""
    c = -(-S // mesh.shape[axis])
    return mesh.coords[axis] * c, c


class SeqCut:
    """A cache's sequence dim cut over mesh axes (a spec entry, its axes
    of size > 1 in order, the first major): this rank's block is number
    ``index`` of ``n``, its positions [index * Sl, (index + 1) * Sl)
    for a local length Sl.  The partial-softmax decode reduces over
    ``axes`` (``all_reduce_``)."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, tuple(axes)
        self.n = math.prod(mesh.shape[a] for a in self.axes)
        self.index = _index(mesh, self.axes)

    def owner(self, pos: int, local_len: int):
        """(block, local index) of global position ``pos``."""
        return divmod(pos, local_len)


def seq_cut(mesh, entry):
    """The ``SeqCut`` of a spec entry, None where no axis of size > 1
    cuts the dim."""
    axes = live_axes(mesh, entry)
    return SeqCut(mesh, axes) if axes else None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, partial_grad):
        ctx.mesh, ctx.axis, ctx.partial = mesh, axis, partial_grad
        return all_gather(x, 1, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if not ctx.partial:
            return g[:, seq_rows(g.shape[1], ctx.mesh, ctx.axis)], None, \
                None, None
        s = _reduce_scatter(g.to(torch.float32), 1, ctx.mesh, ctx.axis)
        return s.to(g.dtype), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dtype):
        ctx.mesh, ctx.axis, ctx.in_dtype = mesh, axis, x.dtype
        return _reduce_scatter(x.to(torch.float32), 1, mesh, axis).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, 1, ctx.mesh, ctx.axis).to(ctx.in_dtype), None,
                None, None)


def gather_seq(x, mesh, axis: str = "model"):
    """Megatron-SP's entry to a block (in place of f): this rank's rows
    (B, S/m, ...) all-gathered on S; the gradient, each rank's part over
    all S (it went through its own heads, columns or experts), summed in
    f32 over ``axis`` and cut to this rank's rows (a reduce-scatter)."""
    return _GatherSeq.apply(x, mesh, axis, True)


def gather_seq_replicated(x, mesh, axis: str = "model"):
    """The rows each rank computed of a replicated tensor (B, S/m, ...)
    all-gathered on S; the gradient, whole and equal on every rank, cut
    to this rank's rows.  The sequence-parallel attention's exit."""
    return _GatherSeq.apply(x, mesh, axis, False)


class _KeepSeqRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x[:, seq_rows(x.shape[1], mesh, axis)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 1, ctx.mesh, ctx.axis), None, None


def keep_seq_rows(x, mesh, axis: str = "model"):
    """This rank's rows (B, S/m, ...) of a tensor (B, S, ...) whole and
    equal on every rank of ``axis`` (a block run whole); the gradient,
    each rank's rows', all-gathered on S, so the block's backward runs
    whole on every rank too.  The exit matching
    ``gather_seq_replicated``."""
    return _KeepSeqRows.apply(x, mesh, axis)


def scatter_seq(x, mesh, dtype, axis: str = "model"):
    """Megatron-SP's exit from a block (in place of g): a partial output
    ``x`` (B, S, ...) summed over ``axis`` in f32, this rank's rows cast
    once to ``dtype`` (a reduce-scatter); the gradient of those rows
    all-gathered on S."""
    return _ScatterSeq.apply(x, mesh, axis, dtype)


class TensorParallel:
    """A model's work split over the "model" axis of a plan: the entry
    to a head-, column- or expert-parallel block and its exit, over a
    replicated residual stream (f and g) or, with ``plan.resid_seq``
    (Megatron-SP) unless ``seq`` is False, one cut on S (``gather_seq``
    and ``scatter_seq``)."""

    def __init__(self, plan, axis: str = "model", seq=None):
        self.plan, self.mesh, self.axis = plan, plan.mesh, axis
        # seq=False: the stream whole whatever the plan (a decode step)
        self.seq = plan.resid_seq is not None if seq is None else seq
        self.size = plan.mesh.shape[axis]

    @property
    def rank(self) -> int:
        """This process's coordinate on the axis (a process mesh's)."""
        return self.mesh.coords[self.axis]

    def enter(self, h):
        """A block's input (the normed residual stream) -> what every
        rank of the axis computes on: the whole sequence."""
        if self.seq:
            return gather_seq(h, self.mesh, self.axis)
        return copy_to_model(h, self.mesh, self.axis)

    def exit(self, partial, dtype):
        """A block's f32 partial output (B, S, D) -> its sum over the
        axis in the residual stream's layout, cast once to ``dtype``."""
        if self.seq:
            return scatter_seq(partial, self.mesh, dtype, self.axis)
        return reduce_from_model(partial, self.mesh, dtype, self.axis)

    def row_parallel(self, a, w):
        """``exit(a @ w)``: this rank's rows of w times its columns of a,
        the partial outputs summed in f32."""
        return self.exit(matmul_f32(a, w.to(a.dtype)), a.dtype)


# --------------------------------------------- a norm over a cut dim
class _RMSNormCut(torch.autograd.Function):
    """``models/common.py`` ``rms_norm`` of x whose last dim is cut over
    an axis (x (..., d/m) and scale (d/m,) this rank's columns): the sum
    of squares and, in the backward, the row sums of g * scale * x
    summed over the axis in f32; the mean over the full d."""

    @staticmethod
    def _inv(x, eps, d, mesh, axis):
        xf = x.float()
        ss = (xf * xf).sum(-1)
        dist.all_reduce(ss, group=mesh.groups[axis])
        return torch.rsqrt(ss / d + eps)[..., None]

    @staticmethod
    def forward(ctx, x, scale, eps, mesh, axis):
        d = x.shape[-1] * mesh.shape[axis]
        inv = _RMSNormCut._inv(x, eps, d, mesh, axis)
        ctx.save_for_backward(x, scale, inv)
        ctx.d, ctx.mesh, ctx.axis = d, mesh, axis
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        gs = g * scale.to(x.dtype)
        t = (gs.float() * x.float()).sum(-1, keepdim=True)
        dist.all_reduce(t, group=ctx.mesh.groups[ctx.axis])
        coeff = inv ** 3 * (t / ctx.d)
        dx = gs * inv.to(x.dtype) - x * coeff.to(x.dtype)
        xin = x * inv.to(x.dtype)
        dscale = (g.float() * xin.float()).reshape(-1, g.shape[-1]).sum(0)
        return dx, dscale.to(scale.dtype), None, None, None


def rms_norm_cut(x, scale, eps: float, mesh, axis: str = "model"):
    """``rms_norm`` over a last dim cut over ``axis``: this rank's columns
    of the full norm, the mean of squares over all of them (f32, one
    all-reduce), and one more all-reduce in the backward."""
    return _RMSNormCut.apply(x, scale, eps, mesh, axis)


# ------------------------------------------------ the vocab-parallel ends
def vocab_embed(table, tokens, mesh, dtype, axis: str = "model",
                seq: bool = False):
    """``table[tokens]`` cast to ``dtype`` with the table's rows cut over
    ``axis``: each rank looks up the rows it owns, writes 0 elsewhere,
    and g sums the f32 rows (one nonzero term each: exact); with
    ``seq``, a reduce-scatter gives this rank's positions alone (the
    Megatron-SP residual stream)."""
    n = table.shape[0]
    local = tokens - mesh.coords[axis] * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    if seq:
        return scatter_seq(rows, mesh, dtype, axis)
    return reduce_from_model(rows, mesh, dtype, axis)


class _VocabNLL(torch.autograd.Function):
    """Summed masked NLL of one chunk with the vocab cut over an axis:
    hc (B, c, D) f32, w (D, V/m) f32, tc (B, c) targets, mc (B, c) f32
    mask.  The logits are recomputed in the backward, whose gradient in
    hc is this rank's part (the caller's f sums it)."""

    @staticmethod
    def _logits(hc, w, off, vocab_size):
        logits = hc @ w
        if off + w.shape[1] > vocab_size:
            col = off + torch.arange(w.shape[1], device=w.device)
            logits = torch.where(col >= vocab_size, NEG_INF, logits)
        return logits

    @staticmethod
    def forward(ctx, hc, w, tc, mc, off, vocab_size, mesh, axis):
        logits = _VocabNLL._logits(hc, w, off, vocab_size)
        g = mesh.groups[axis]
        mx = logits.amax(dim=-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        se = torch.exp(logits - mx[..., None]).sum(dim=-1)
        dist.all_reduce(se, group=g)
        lse = mx + torch.log(se)
        local = tc.long() - off
        own = (local >= 0) & (local < w.shape[1])
        idx = local.clamp(0, w.shape[1] - 1)[..., None]
        gold = torch.gather(logits, -1, idx)[..., 0]
        gold = torch.where(own, gold, 0.0)
        dist.all_reduce(gold, group=g)
        ctx.save_for_backward(hc, w, local, own, mc, lse)
        ctx.off, ctx.vocab_size = off, vocab_size
        return ((lse - gold) * mc).sum()

    @staticmethod
    def backward(ctx, gs):
        hc, w, local, own, mc, lse = ctx.saved_tensors
        p = torch.exp(_VocabNLL._logits(hc, w, ctx.off, ctx.vocab_size)
                      - lse[..., None])
        hit = torch.zeros_like(p).scatter_(
            -1, local.clamp(0, w.shape[1] - 1)[..., None],
            own[..., None].to(p.dtype))
        dl = (p - hit) * (gs * mc)[..., None]
        dh = dl @ w.t()
        dw = hc.reshape(-1, hc.shape[-1]).t() @ dl.reshape(-1, dl.shape[-1])
        return dh, dw, None, None, None, None, None, None


def vocab_xent(w, h, targets, cfg, mesh, mask=None, axis: str = "model",
               seq: bool = False):
    """``models/common.py`` ``chunked_xent`` with the unembedding's vocab
    columns cut over ``axis``: w (D, V/m) this rank's columns, h (B, S,
    D) replicated (with ``seq``, h (B, S/m, D) this rank's positions,
    gathered on S first).  Per ``cfg.logit_chunk`` tokens: the local f32
    logits, the global max and sum of exponentials by all-reduce, the
    gold logit from the rank that owns it, the padded vocab masked; the
    backward recomputes the chunk (softmax minus the one-hot on the
    local columns).  Returns (mean loss over unmasked tokens, token
    count)."""
    if seq:
        h = gather_seq(h, mesh, axis)
    B, S, D = h.shape
    c = min(cfg.logit_chunk, S)
    if S % c:
        raise ValueError(f"logit_chunk {c} does not divide S={S}")
    w = w.to(h.dtype).float()
    hf = h.float() if seq else copy_to_model(h.float(), mesh, axis)
    off = mesh.coords[axis] * w.shape[1]
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        mc = (torch.ones((B, c), device=h.device) if mask is None
              else mask[:, sl].float())
        tot = tot + _VocabNLL.apply(hf[:, sl], w, targets[:, sl], mc, off,
                                    cfg.vocab_size, mesh, axis)
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0), cnt


# -------------------------------------------- a masked step's token counts
_token_reduces = [0]


def reset_token_reduces() -> None:
    """Zero ``token_reduces``."""
    _token_reduces[0] = 0


def token_reduces() -> int:
    """The all-reduces ``global_token_counts`` made since
    ``reset_token_reduces``: one per batch axis of size > 1 a masked
    sharded step, none an unmasked one."""
    return _token_reduces[0]


def global_token_counts(mask, n_micro: int, mesh, batch_axes):
    """The sum of the mask over each of ``n_micro`` equal microbatches of
    the global batch, rows in order (JAX's ``C_i``), from this rank's
    block of rows ``mask`` (R, ...) cut over ``batch_axes`` as ``block``
    cuts it: (n_micro,) f32, equal on every rank, by one all-reduce over
    each batch axis of size > 1."""
    R = mask.shape[0]
    B = global_shape((R,), (batch_axes,), mesh)[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    first = block_offsets((R,), (batch_axes,), mesh)[0]
    micro = (first + torch.arange(R, device=mask.device)) // (B // n_micro)
    counts = torch.zeros(n_micro, device=mask.device).index_add_(
        0, micro, mask.reshape(R, -1).float().sum(dim=1))
    for a in _live(mesh, entry_axes(batch_axes)):
        dist.all_reduce(counts, group=mesh.groups[a])
        _token_reduces[0] += 1
    return counts


# -------------------------------------------------------- the gradients
def reduce_grads(grads, specs, mesh, batch_axes, model_partial=(),
                 model_axis: str = "model"):
    """The gradient rule of a sharded step, its second half.  ``grads``
    are this rank's gradients of its rows' mean loss, already in the
    shards' layout (``specs``): ``gather_data``'s backward reduce-scattered
    each leaf over the batch axes that cut it, or took this rank's block
    along a data axis that is not a batch axis, unit by unit.  What is
    left, once a step on the shard, and nothing of that:
    - the sum over ``model_axis`` of the leaves in ``model_partial``:
      replicated over it but used inside a head-partitioned region, so
      each rank holds its heads' part;
    - along a batch axis that cuts nothing of the leaf, an all-reduce;
    - the division by the number of batch shards.
    The two halves together are the whole rule: along every batch axis
    the leaf's gradient is summed once, by a reduce-scatter where the
    axis cuts it and an all-reduce where it does not."""
    batch = _live(mesh, entry_axes(batch_axes))
    n = math.prod(mesh.shape[a] for a in batch)
    sp = _specs_by_name(specs)
    out = {}
    for name, g in tree_leaves(grads):
        cuts = dim_axes(sp[name], g.ndim)
        uncut = [a for a in batch if not any(a in axes for axes in cuts)]
        if name in model_partial or uncut:
            # a copy before reducing in place: autograd may alias gradients
            g = g.clone(memory_format=torch.contiguous_format)
            if name in model_partial:
                all_reduce_(g, mesh, (model_axis,))
            all_reduce_(g, mesh, tuple(uncut))
        out[name] = g / n if n > 1 else g
    return tree_from_flat(grads, out)
