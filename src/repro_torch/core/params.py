"""Flat parameter layouts of the Graph U-Net policy and the SAC critic.

The JAX package evolves each GNN genome as one flat vector in
``jax.tree.leaves`` order of its parameter dict (``gnn.flatten_params``),
which sorts dict keys.  ``SPEC`` lists the same leaves in the same
order, so a genome moves between the two packages unchanged.
``critic_spec`` does the same for the double-Q critic of
``src/repro/core/sac.py`` (``critic_defs``), which the port also keeps
as one flat vector.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

HIDDEN = 128
DEPTH = 4
HEADS = 4
N_SUB = 2    # weight / activation sub-actions
N_TIER = 3
N_FEATURES = 19


Spec = List[Tuple[str, Tuple[int, ...], str]]


def _gat_spec(level: int) -> Spec:
    return [(f"gat{level}.a_dst", (HEADS, HIDDEN // HEADS), "scaled"),
            (f"gat{level}.a_src", (HEADS, HIDDEN // HEADS), "scaled"),
            (f"gat{level}.b", (HIDDEN,), "zeros"),
            (f"gat{level}.w", (HIDDEN, HIDDEN), "scaled")]


def gnn_spec(n_features: int = N_FEATURES) -> Spec:
    """(name, shape, init) per leaf, in JAX leaf order.  init is
    "scaled" (normal, std 1/sqrt(fan_in), fan_in = all dims but the last)
    or "zeros", as ``src/repro/utils/params.py`` defines them."""
    spec = []
    for i in range(DEPTH):
        spec += _gat_spec(i)
    spec += [("inp", (n_features, HIDDEN), "scaled"),
             ("out1", (HIDDEN, HIDDEN), "scaled"),
             ("out2", (HIDDEN, N_SUB * N_TIER), "scaled"),
             ("out_b1", (HIDDEN,), "zeros"),
             ("pool1", (HIDDEN,), "scaled"),
             ("pool2", (HIDDEN,), "scaled")]
    return spec


SPEC = gnn_spec()


def genome_size(spec=SPEC) -> int:
    return sum(math.prod(shape) for _, shape, _ in spec)


V = genome_size()   # 87,040 at the published widths


def unflatten(pop: torch.Tensor, spec=SPEC) -> Dict[str, torch.Tensor]:
    """(P, V) population -> {name: (P, *shape)} views of ``pop`` (no
    copy)."""
    if pop.dim() != 2 or pop.shape[1] != genome_size(spec):
        raise ValueError(f"population {tuple(pop.shape)} is not "
                         f"(P, {genome_size(spec)})")
    out, off = {}, 0
    for name, shape, _ in spec:
        n = math.prod(shape)
        out[name] = pop[:, off:off + n].view(pop.shape[0], *shape)
        off += n
    return out


def critic_spec(n_features: int = N_FEATURES) -> Spec:
    """The critic's leaves in JAX leaf order (``critic_defs`` sorted by
    key): two Q heads (b, h, q), two GAT levels and the input layer over
    the node features and the 6-wide action one-hot."""
    return ([("b1", (HIDDEN,), "zeros"), ("b2", (HIDDEN,), "zeros")]
            + _gat_spec(0) + _gat_spec(1)
            + [("h1", (HIDDEN, HIDDEN), "scaled"),
               ("h2", (HIDDEN, HIDDEN), "scaled"),
               ("inp", (n_features + N_SUB * N_TIER, HIDDEN), "scaled"),
               ("q1", (HIDDEN, 1), "scaled"),
               ("q2", (HIDDEN, 1), "scaled")])


def init_gnn(generator: torch.Generator,
             n_features: int = N_FEATURES) -> torch.Tensor:
    """One flat (V,) genome on the generator's device, with the JAX
    package's "scaled" init: every "scaled" leaf is normal with std
    1/sqrt(fan_in), biases are 0."""
    return _init(generator, gnn_spec(n_features))


def init_critic(generator: torch.Generator,
                n_features: int = N_FEATURES) -> torch.Tensor:
    """One flat critic on the generator's device, initialised as
    ``init_gnn`` initialises a genome."""
    return _init(generator, critic_spec(n_features))


def _init(generator: torch.Generator, spec: Spec) -> torch.Tensor:
    device = generator.device
    parts = []
    for _, shape, init in spec:
        n = math.prod(shape)
        if init == "zeros":
            parts.append(torch.zeros(n, device=device))
            continue
        fan_in = max(1, math.prod(shape[:-1]))
        parts.append(torch.randn(n, generator=generator, device=device)
                     * (1.0 / math.sqrt(fan_in)))
    return torch.cat(parts)
