"""Carry parameters between the JAX package and the port.

The JAX side hands over numpy arrays (``np.asarray`` of its jax
arrays); the port side is torch tensors.  GNN genomes and SAC critics
share one flat layout each (``core.params.SPEC`` / ``critic_spec``, JAX
leaf order) and Boltzmann genomes one flat encoding
(``core.boltzmann``), so a conversion is a layout check plus a copy,
never a reordering of values.  Language-model parameters and caches
keep the JAX pytree's keys and stacked axes in the port
(``nn.ParameterDict`` / dicts of tensors), so they convert key for key.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import boltzmann as bz
from repro_torch.core import params as P_
from repro_torch.utils.params import to_parameter_dict, tree_map


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
    -> (V,) or (P, V) f32.  Any other ``spec`` (the critic's) works the
    same way."""
    if isinstance(x, Mapping):
        leaves = _leaves(x)
        if set(leaves) != {name for name, _, _ in spec}:
            raise ValueError(f"params tree leaves {sorted(leaves)} do not "
                             f"match the spec")
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
            raise ValueError(f"flat shape {flat.shape}, expected (V,) or "
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
        raise ValueError("a params tree holds one parameter vector")
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


def critic_from_jax(x, n_features: int = P_.N_FEATURES,
                    device="cpu") -> torch.Tensor:
    """A JAX critic (params pytree of ``critic_defs``, or its flat
    ``jax.tree.leaves`` concatenation) as the port's flat critic."""
    return gnn_from_jax(x, P_.critic_spec(n_features), device)


def critic_to_jax(vec: torch.Tensor, n_features: int = P_.N_FEATURES,
                  tree: bool = True):
    """The port's flat critic as the JAX params pytree of numpy arrays
    (or, with ``tree=False``, the flat vector)."""
    return gnn_to_jax(vec, P_.critic_spec(n_features), tree)


def sac_state_from_jax(learner, device="cpu") -> Dict:
    """The whole state of a JAX ``SACLearner`` (its ``actor``,
    ``critic``, ``opt_a`` and ``opt_c`` attributes; each Adam state is
    ``{"m": tree, "v": tree, "t": int32}``) as the port learner's
    ``load_state`` input: flat tensors and an int step count."""
    n_features = np.asarray(learner.actor["inp"]).shape[0]
    specs = {"a": P_.gnn_spec(n_features), "c": P_.critic_spec(n_features)}
    state = {"actor": gnn_from_jax(learner.actor, specs["a"], device),
             "critic": gnn_from_jax(learner.critic, specs["c"], device)}
    for k in ("a", "c"):
        opt = getattr(learner, f"opt_{k}")
        state[f"opt_{k}"] = {
            "m": gnn_from_jax(opt["m"], specs[k], device),
            "v": gnn_from_jax(opt["v"], specs[k], device),
            "t": int(np.asarray(opt["t"]))}
    return state


def sac_state_to_jax(state: Mapping) -> Dict:
    """The port learner's ``state()`` as the JAX ``SACLearner``'s
    attributes: {"actor", "critic", "opt_a", "opt_c"} of numpy pytrees,
    each to be mapped through ``jnp.asarray`` and assigned."""
    # the input layer is the only leaf whose size depends on F
    n_features = ((state["actor"].numel() - P_.genome_size(P_.gnn_spec(0)))
                  // P_.HIDDEN)
    specs = {"a": P_.gnn_spec(n_features), "c": P_.critic_spec(n_features)}
    out = {"actor": gnn_to_jax(state["actor"], specs["a"], True),
           "critic": gnn_to_jax(state["critic"], specs["c"], True)}
    for k in ("a", "c"):
        opt = state[f"opt_{k}"]
        out[f"opt_{k}"] = {"m": gnn_to_jax(opt["m"], specs[k], True),
                           "v": gnn_to_jax(opt["v"], specs[k], True),
                           "t": np.int32(opt["t"])}
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


# ------------------------------------------------------- language models
def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: no torch view
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def lm_params_from_jax(tree: Mapping, device="cpu"):
    """A JAX language model's parameter pytree (nested dicts of arrays,
    stacked axes ``layers``, ``groups`` (G, k, ...) and ``tail`` kept) as
    the port model's nested ``nn.ParameterDict``: a key-for-key copy."""
    return to_parameter_dict(tree_map(lambda a: _tensor(a, device), tree))


def lm_params_to_jax(params: Mapping) -> Dict:
    """The port model's parameters as the JAX pytree of numpy arrays
    (bfloat16 tensors come back as float32)."""
    return tree_map(_numpy, params)


def opt_state_from_jax(state: Mapping, device="cpu") -> Dict:
    """A JAX optimizer state (``adamw_init`` {"m", "v", "step"} or
    ``adafactor_init`` {"f": {... {"vr", "vc"} or {"v"}}, "step"}; numpy
    arrays) as the port's: the same nested dicts of tensors, ``step`` an
    int32 scalar tensor."""
    return tree_map(lambda a: _tensor(a, device), state)


def opt_state_to_jax(state: Mapping) -> Dict:
    """The port's optimizer state as the JAX pytree of numpy arrays."""
    return tree_map(_numpy, state)


def lm_cache_from_jax(cache: Mapping, device="cpu") -> Dict:
    """A JAX model's cache dict (``init_cache`` / ``prefill`` layout) as
    the port's cache: the same keys and shapes, as tensors."""
    return {k: _tensor(v, device) for k, v in cache.items()}
