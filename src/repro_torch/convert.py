"""Carry parameters between the JAX package and the port.

The JAX side hands over numpy arrays (``np.asarray`` of its jax
arrays); the port side is torch tensors.  GNN genomes share one flat
layout (``core.params.SPEC``, JAX leaf order) and Boltzmann genomes one
flat encoding (``core.boltzmann``), so a conversion is a layout check
plus a copy, never a reordering of values.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import boltzmann as bz
from repro_torch.core import params as P_


def _leaves(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_leaves(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def gnn_from_jax(x, spec=P_.SPEC, device="cpu") -> torch.Tensor:
    """A JAX GNN genome as the port's flat tensor: a flat (V,) vector, a
    stacked (P, V) population (``gnn.flatten_params`` layout), or a
    params pytree (nested dict of arrays, exported with ``np.asarray``)
    -> (V,) or (P, V) f32."""
    if isinstance(x, Mapping):
        leaves = _leaves(x)
        if set(leaves) != {name for name, _, _ in spec}:
            raise ValueError(f"params tree leaves {sorted(leaves)} do not "
                             f"match the GNN spec")
        parts = []
        for name, shape, _ in spec:
            if leaves[name].shape != shape:
                raise ValueError(f"{name}: shape {leaves[name].shape}, "
                                 f"expected {shape}")
            parts.append(leaves[name].reshape(-1))
        flat = np.concatenate(parts)
    else:
        flat = np.asarray(x)
        if flat.shape[-1] != P_.genome_size(spec) or flat.ndim > 2:
            raise ValueError(f"genome shape {flat.shape}, expected (V,) or "
                             f"(P, V) with V = {P_.genome_size(spec)}")
    return torch.tensor(flat, dtype=torch.float32, device=device)


def gnn_to_jax(vec: torch.Tensor, spec=P_.SPEC, tree: bool = False):
    """The port's flat genome (V,) or (P, V) as numpy: the same flat
    layout, or with ``tree=True`` (one genome) the JAX params pytree of
    numpy arrays, ready for ``jnp.asarray``."""
    flat = vec.detach().cpu().numpy().astype(np.float32)
    if not tree:
        return flat
    if flat.ndim != 1:
        raise ValueError("a params tree holds one genome")
    out: Dict = {}
    off = 0
    for name, shape, _ in spec:
        n = math.prod(shape)
        node = out
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[off:off + n].reshape(shape)
        off += n
    return out


def boltzmann_from_jax(flat, n_nodes: int, device="cpu") -> torch.Tensor:
    """JAX Boltzmann flats ((F,) or (P, F), ``boltzmann.to_flat`` layout)
    as the port's tensor."""
    flat = np.asarray(flat)
    if flat.shape[-1] != bz.flat_size(n_nodes):
        raise ValueError(f"Boltzmann flat width {flat.shape[-1]}, expected "
                         f"{bz.flat_size(n_nodes)} for {n_nodes} nodes")
    return torch.tensor(flat, dtype=torch.float32, device=device)


def boltzmann_to_jax(flat: torch.Tensor) -> np.ndarray:
    return flat.detach().cpu().numpy().astype(np.float32)
