"""Parameter declarations and their initialisation.

Copied from ``src/repro/utils/params.py``.  A model declares its
parameters as a nested dict of :class:`ParamDef`; ``init_params``
draws them from an explicit ``torch.Generator`` (the JAX package draws
from a PRNG key: the two give different numbers from one seed, with the
same initialiser kinds and scales).  ``to_parameter_dict`` holds such a
tree in a nested ``nn.ParameterDict`` with the same keys and stacked
axes.  ``make_specs`` maps each leaf's logical axes to mesh axes through
a rules table (``distributed/rules.py``), giving a tree of
:class:`PartitionSpec`: the layout ``distributed/parallel.py`` cuts and
gathers the leaves by (JAX: ``make_specs`` ``:76``,
``validate_divisibility`` ``:105``).
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


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or
    a tuple of axis names (the dim cut over their product, the first
    axis major), as ``jax.sharding.PartitionSpec``; ``tuple(spec)``
    equals ``tuple(P(...))`` of the same entries (a tuple of one axis is
    that axis, an empty one None, as JAX normalises them).  Dims past the
    end of the spec are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple)
            else p for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


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


def _flat_axes(m) -> tuple:
    """A rules entry (None, an axis name or a tuple of them) as a tuple."""
    return (m,) if isinstance(m, str) else tuple(m or ())


def make_specs(defs, rules: Mapping[str, Any]):
    """logical axes -> PartitionSpec through a rules table.

    rules maps logical axis name -> mesh axis (str), tuple of mesh axes,
    or None.  Unknown axis names are an error (catches typos early).
    Two tensor dims never map onto one mesh axis: the later dim stays
    replicated."""

    def one(d: ParamDef) -> PartitionSpec:
        parts, used = [], set()
        for ax in d.axes:
            if ax is None:
                parts.append(None)
                continue
            if ax not in rules:
                raise KeyError(f"logical axis {ax!r} missing from rules")
            m = rules[ax]
            flat = _flat_axes(m)
            if any(f in used for f in flat):
                parts.append(None)
                continue
            used.update(flat)
            parts.append(m)
        return PartitionSpec(*parts)

    return tree_map(one, defs)


def _keystr(name: str) -> str:
    """A dotted leaf name as ``jax.tree_util.keystr`` prints a dict
    path: ``['layers']['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in name.split("."))


def validate_divisibility(defs, rules, mesh_shape: Mapping[str, int]):
    """(path, dim, logical axis, shard count) of every sharded dim that
    its mesh axes do not divide, in JAX's leaf order and path format."""
    problems = []
    for name, d in tree_leaves(defs):
        for dim, ax in zip(d.shape, d.axes):
            if ax is None or ax not in rules or rules[ax] is None:
                continue
            n = math.prod(mesh_shape[f] for f in _flat_axes(rules[ax]))
            if dim % n:
                problems.append((_keystr(name), dim, ax, n))
    return problems


def to_parameter_dict(tree) -> nn.ParameterDict:
    """A nested mapping of tensors as a nested ``nn.ParameterDict``
    (same keys; no gradient until a trainer asks for one)."""
    return nn.ParameterDict({
        k: (to_parameter_dict(v) if is_node(v)
            else nn.Parameter(v, requires_grad=False))
        for k, v in tree.items()})
