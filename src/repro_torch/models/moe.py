"""Mixture-of-Experts with sort-based capacity dispatch (dropping).

Copied from ``src/repro/models/moe.py``.  No (T, E) one-hot or (T, E, C)
dispatch tensor is formed: a row's token choices are sorted by expert
id (stable), the position within an expert comes from ``searchsorted``
on the sorted ids, and choices past the capacity C are dropped.
Dispatch is per batch row with a per-row capacity, as the JAX code's
``vmap`` over rows; the rows run in one batched call here.

Where the JAX code scatters (the tokens into the (E, C, D) buffer, the
experts' outputs back onto the tokens with ``.at[].add``), the port
gathers both ways (``_Route``): a token's k contributions and the
gradients of its k slots are summed over k in one fixed order, never by
atomic adds, so two runs on the card give the same bits.  ``routes``
(B, S, k) expert ids, when given, replace the router's top-k (the gate
weights still come from the router's probabilities): the seam through
which a test or a check on the card hands one run's routes to another,
as ``core/ea.py`` takes its draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.parallel import bmm_f32, matmul_f32
from repro_torch.models.common import mlp, mlp_defs
from repro_torch.utils.params import ParamDef


def moe_defs(cfg: ModelConfig):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    d = {
        "router": ParamDef((D, E), ("embed", None), "scaled"),
        "w_gate": ParamDef((E, D, Fe), ("expert", "embed", "mlp_exp"), "scaled", fan_in_axes=(1,)),
        "w_up": ParamDef((E, D, Fe), ("expert", "embed", "mlp_exp"), "scaled", fan_in_axes=(1,)),
        "w_down": ParamDef((E, Fe, D), ("expert", "mlp_exp", "embed"), "scaled", fan_in_axes=(1,)),
    }
    if m.shared_expert_ff:
        d["shared"] = mlp_defs(cfg, m.shared_expert_ff)
    return d


def _capacity(T: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(T * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _rows(src, idx):
    """src (B, N, D), idx (B, J) in [0, N] -> (B, J, D): row idx[b, j] of
    src[b], index N a zero row.  A gather (index_select), no scatter."""
    B, N, D = src.shape
    pad = torch.cat([src, src.new_zeros(B, 1, D)], 1)
    base = torch.arange(B, device=src.device)[:, None] * (N + 1)
    flat = (idx + base).reshape(-1)
    return pad.reshape(B * (N + 1), D).index_select(0, flat).view(
        B, idx.shape[1], D)


class _Route(torch.autograd.Function):
    """``_rows(src, take)`` whose gradient is a gather too: row n of
    dsrc sums the rows of the cotangent that ``give[b, n]`` (B, N, m)
    names (index J a zero row), over m in order.  ``give`` must name
    exactly the rows of the output that read row n of src."""

    @staticmethod
    def forward(ctx, src, take, give):
        ctx.save_for_backward(give)
        return _rows(src, take)

    @staticmethod
    def backward(ctx, g):
        (give,) = ctx.saved_tensors
        B, N, m = give.shape
        dsrc = _rows(g.contiguous(), give.reshape(B, N * m))
        return dsrc.view(B, N, m, -1).sum(2), None, None


def route(p, x, cfg: ModelConfig, routes=None):
    """The router and the dispatch plan of x (B, S, D), per row.

    Returns a dict: ``experts`` (B, S*k) the chosen expert ids and
    ``gate`` (B, S*k) their renormalised f32 weights, in token order
    (token t's choice i at t*k + i); ``keep`` (B, S*k) whether the
    choice fits its expert's capacity; ``tok_slot`` (B, S, k) the slot
    e*C + pos of each choice (E*C when dropped); ``slot_tok`` (B, E*C)
    the token in each slot (S when empty) and ``slot_choice`` (B, E*C)
    the choice t*k + i that reads it (S*k when empty); ``aux`` (B,) the
    Switch load-balance loss of each row; ``capacity`` C."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    dev = x.device
    logits = x.float() @ p["router"].float()                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    if routes is None:
        gate_w, e_idx = torch.topk(probs, k, dim=-1)
    else:
        e_idx = routes.to(device=dev, dtype=torch.long).reshape(B, S, k)
        gate_w = probs.gather(-1, e_idx)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style), per row
    me = probs.mean(dim=1)                                    # (B,E)
    flat_e = e_idx.reshape(B, S * k)
    rows = torch.arange(B, device=dev)[:, None] * E
    # a fixed-size count (bincount's length depends on the data, which a
    # meta tensor of the dry run does not hold); integer sums: exact
    slot = (flat_e + rows).reshape(-1)
    counts = torch.zeros(B * E, dtype=torch.long, device=dev).scatter_add_(
        0, slot, torch.ones_like(slot))
    ce = counts.view(B, E).float() / (S * k)
    aux = m.aux_loss_weight * E * torch.sum(me * ce, dim=-1)

    # sort-based dispatch: stable by expert id, position within expert
    perm = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, perm)
    pos = (torch.arange(S * k, device=dev)
           - torch.searchsorted(se, se, side="left"))
    C = _capacity(S, cfg)
    keep_s = pos < C
    dst = torch.where(keep_s, se * C + pos, E * C)            # sorted order
    # token order: choice perm[j] went to slot dst[j]
    tok_slot = torch.empty_like(dst).scatter_(1, perm, dst)
    # slot order: slot dst[j] holds token perm[j] // k, read by choice
    # perm[j]; every drop lands in the extra slot E*C, cut off
    slot_choice = torch.full((B, E * C + 1), S * k, dtype=torch.long,
                             device=dev).scatter_(1, dst, perm)[:, :E * C]
    slot_tok = torch.where(slot_choice < S * k,
                           torch.div(slot_choice, k, rounding_mode="floor"),
                           S)
    return {"experts": flat_e, "gate": gate_w.reshape(B, S * k),
            "keep": tok_slot < E * C, "tok_slot": tok_slot.view(B, S, k),
            "slot_tok": slot_tok, "slot_choice": slot_choice, "aux": aux,
            "capacity": C}


def moe_block(p, x, cfg: ModelConfig, routes=None, record=None, tp=None):
    """x: (B,S,D) -> (out (B,S,D), aux loss f32 scalar, the mean over
    rows).  ``routes``: optional (B, S, k) expert ids in place of the
    router's top-k.  ``record``, if given, is filled with ``route``'s
    dict (tests and checks read the routes and the kept choices from
    it).  ``tp``: the model's split over "model"
    (``parallel.TensorParallel``), or None (``_moe_split``)."""
    if tp is not None:
        return _moe_split(p, x, cfg, routes, record, tp)
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    r = route(p, x, cfg, routes)
    if record is not None:
        record.update(r)
    C = r["capacity"]
    # dispatch: slot s takes its token's row; a token's gradient sums
    # its k slots' in choice order
    buf = _Route.apply(x, r["slot_tok"], r["tok_slot"])       # (B,E*C,D)

    dt = x.dtype
    xe = buf.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dt)))
    h = h * torch.bmm(xe, p["w_up"].to(dt))
    eo = torch.bmm(h, p["w_down"].to(dt))                     # (E,B*C,D)
    eo = eo.view(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine: each choice reads its slot (a dropped one the zero row);
    # a token sums its k weighted contributions in choice order
    got = _Route.apply(eo, r["tok_slot"].reshape(B, S * k),
                       r["slot_choice"][..., None])           # (B,S*k,D)
    w = (r["gate"] * r["keep"]).to(dt)
    out = (got * w[..., None]).view(B, S, k, D).sum(2)
    if m.shared_expert_ff:
        out = out + mlp(p["shared"], x)
    return out, r["aux"].mean()


def _moe_split(p, x, cfg: ModelConfig, routes, record, tp):
    """``moe_block`` split over "model" as JAX ``moe_defs`` cuts the
    experts' weights.  The normed tokens enter the split whole (f, or
    the gather on S under Megatron-SP), so every rank routes every token
    of its rows as one card does: the same top-k, capacity (per row and
    expert) and drops.
    - Expert parallelism (``rules["expert"]`` "model": w_gate, w_up,
      w_down cut on E): each rank runs the capacity slots of its E/m
      experts, each expert's output whole.
    - Where the experts do not divide the axis ("expert" None,
      "mlp_exp" "model"): each rank holds every expert's d_ff_expert/m
      columns of w_gate and w_up and those rows of w_down, runs every
      slot through its columns' SwiGLU, and its w_down product is a
      partial output, kept in f32 (``bmm_f32``).
    A rank's combine is its choices' weighted outputs in choice order
    (under expert parallelism the others' read the zero row), summed in
    f32; the shared expert's row-parallel partial (``rules["mlp"]``
    "model") joins it, and one exit sums them over "model" and casts
    once.  A shared expert that is not split runs whole on the block's
    input.  The router's gradient is each rank's part (its experts' or
    columns' gates): a model-partial leaf; the aux loss's gradient is
    rank 0's alone."""
    m = cfg.moe
    k = m.top_k
    dt = x.dtype
    h = tp.enter(x)
    B, S, D = h.shape
    r = route(p, h, cfg, routes)
    if record is not None:
        record.update(r)
    C = r["capacity"]
    El = p["w_gate"].shape[0]
    ep = tp.plan.rules["expert"] is not None
    lo = tp.rank * El * C if ep else 0
    hi = lo + El * C
    tok_slot = r["tok_slot"]
    mine = torch.where((tok_slot >= lo) & (tok_slot < hi), tok_slot - lo,
                       El * C)
    buf = _Route.apply(h, r["slot_tok"][:, lo:hi], mine)     # (B,El*C,D)
    xe = buf.view(B, El, C, D).transpose(0, 1).reshape(El, B * C, D)
    a = F.silu(torch.bmm(xe, p["w_gate"].to(dt)))
    a = a * torch.bmm(xe, p["w_up"].to(dt))
    if ep:
        eo = torch.bmm(a, p["w_down"].to(dt))
        w = (r["gate"] * r["keep"]).to(dt)
    else:
        eo = bmm_f32(a, p["w_down"].to(dt))
        w = r["gate"] * r["keep"]
    eo = eo.view(El, B, C, D).transpose(0, 1).reshape(B, El * C, D)
    got = _Route.apply(eo, mine.reshape(B, S * k),
                       r["slot_choice"][:, lo:hi, None])      # (B,S*k,D)
    part = (got * w[..., None]).float().view(B, S, k, D).sum(2)
    whole_shared = m.shared_expert_ff and tp.plan.rules["mlp"] != "model"
    if m.shared_expert_ff and not whole_shared:
        sp = p["shared"]
        s = F.silu(h @ sp["w_gate"].to(dt)) * (h @ sp["w_up"].to(dt))
        part = part + matmul_f32(s, sp["w_down"].to(dt))
    out = tp.exit(part, dt)
    if whole_shared:
        out = out + mlp(p["shared"], x)
    aux = r["aux"].mean()
    return out, aux if tp.rank == 0 else aux.detach()
