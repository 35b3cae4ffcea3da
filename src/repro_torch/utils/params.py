"""Parameter declarations and their initialisation.

Copied from ``src/repro/utils/params.py`` without the sharding part
(``make_specs``; the port serves on one card).  A model declares its
parameters as a nested dict of :class:`ParamDef`; ``init_params``
draws them from an explicit ``torch.Generator`` (the JAX package draws
from a PRNG key: the two give different numbers from one seed, with the
same initialiser kinds and scales).  ``to_parameter_dict`` holds such a
tree in a nested ``nn.ParameterDict`` with the same keys and stacked
axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim
    init: str = "normal"  # normal | zeros | ones | embed | scaled
    dtype: Any = torch.float32
    fan_in_axes: tuple = ()  # dims counted as fan-in for "scaled"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_node(x) -> bool:
    """An inner node of a parameter tree: a mapping or an
    ``nn.ParameterDict`` (which is not a ``Mapping``)."""
    return isinstance(x, (Mapping, nn.ParameterDict))


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a nested mapping, keys kept; with ``rest``,
    trees of the same keys whose leaves are passed alongside."""
    if is_node(tree):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = ""):
    """(dotted name, leaf) pairs in sorted key order, as ``jax.tree.leaves``
    orders a dict."""
    if is_node(tree):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def tree_from_flat(like, flat, prefix: str = ""):
    """The nested dict of ``flat`` (dotted name -> value, as
    ``tree_leaves`` names the leaves) shaped like the tree ``like``."""
    if is_node(like):
        return {k: tree_from_flat(v, flat, f"{prefix}{k}.")
                for k, v in like.items()}
    return flat[prefix[:-1]]


def _draw(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    x = torch.randn(d.shape, generator=gen, device=dev)
    if d.init == "embed":
        return x.to(d.dtype)
    if d.init == "scaled":
        fan_dims = d.fan_in_axes or tuple(range(len(d.shape) - 1))
        fan_in = max(1, math.prod(d.shape[i] for i in fan_dims))
        return (x * (1.0 / math.sqrt(fan_in))).to(d.dtype)
    if d.init == "normal":
        return (x * 0.02).to(d.dtype)
    raise ValueError(f"unknown init {d.init}")


def init_params(defs, generator: torch.Generator):
    """Materialise a nested dict of ParamDef as tensors on the
    generator's device, drawn leaf by leaf in sorted key order."""
    vals = {name: _draw(d, generator) for name, d in tree_leaves(defs)}

    def build(tree, prefix=""):
        return {k: (build(v, f"{prefix}{k}.") if is_node(v)
                    else vals[f"{prefix}{k}"]) for k, v in tree.items()}
    return build(defs)


def with_dtype(defs, dtype):
    """Set the storage dtype of all float params (cfg.param_dtype)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def one(d: ParamDef) -> ParamDef:
        if d.dtype.is_floating_point:
            return dataclasses.replace(d, dtype=dt)
        return d

    return tree_map(one, defs)


def param_count(tree) -> int:
    """Number of elements over the leaves of a parameter tree."""
    return sum(math.prod(x.shape) for _, x in tree_leaves(tree))


def to_parameter_dict(tree) -> nn.ParameterDict:
    """A nested mapping of tensors as a nested ``nn.ParameterDict``
    (same keys; no gradient until a trainer asks for one)."""
    return nn.ParameterDict({
        k: (to_parameter_dict(v) if is_node(v)
            else nn.Parameter(v, requires_grad=False))
        for k, v in tree.items()})
