"""Checkpointing: atomic, content-checksummed, keep-N.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json   (tmp dir + os.rename
for atomicity).

Counterpart of ``src/repro/checkpoint/manager.py`` with the same on-disk
format: the same ``SEP``-joined key paths, the same sha256 checksum and
the same manifest, so a directory either package writes verifies and
restores in the other.  A tree is nested dicts, lists and tuples whose
leaves are tensors or numpy arrays; it is flattened in the order
``jax.tree_util`` flattens it (dict keys sorted, sequences by index,
``None`` an empty subtree).

On a process mesh (``mesh`` and a tree of ``specs`` shaped like the
tree), ``save`` gathers each sharded leaf, rank 0 writes the full arrays
in the same format and every rank waits for it; ``restore`` reads the
file on every rank and keeps this rank's shard (JAX ``:98``), which may
be another layout than the one that saved it (elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import parallel as par
from repro_torch.utils.params import PartitionSpec

SEP = "//"


def _leaves(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, object]]:
    """(key path, leaf) pairs in jax.tree_util's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _leaves(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [kv for i, x in enumerate(tree) for kv in
                _leaves(x, path + (str(i),))]
    return [(SEP.join(path), tree)]


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _numpy(leaf) for k, leaf in _leaves(tree)}


def _checksum(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over (key, array bytes in C order) in sorted key order, the
    JAX manager's checksum; hashed from the arrays' buffers, without the
    copy ``tobytes`` makes (a training state is gigabytes)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).reshape(-1).view(np.uint8))
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep: int = 3, mesh=None, specs=None) -> str:
    """Write ``tree`` as step ``step``; on a mesh, its leaves are this
    rank's shards of ``specs``: every rank gathers, rank 0 writes, and
    every rank returns once the checkpoint is in place."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        full = par.gather_tree(tree, specs, mesh)
        if mesh.rank == 0:
            save(ckpt_dir, step, full, extra, keep)
        del full
        if math.prod(mesh.devices.shape) > 1:
            dist.barrier()
        return final
    arrays = _flatten(tree)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "checksum": _checksum(arrays),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_checked(path: str):
    """The arrays of checkpoint ``path`` read once, with whether their
    checksum matches the manifest (False for a truncated zip, a missing
    manifest, a bad array...)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        return arrays, _checksum(arrays) == manifest["checksum"]
    except Exception:  # truncated zip, missing manifest, bad array...
        return None, False


def verify(path: str) -> bool:
    return _load_checked(path)[1]


def _rebuild(template, data, cut, path: Tuple[str, ...] = ()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, data, cut, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(x, data, cut, path + (str(i),))
               for i, x in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    key = SEP.join(path)
    arr = cut(key, data[key])
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: checkpoint shard {arr.shape}, "
                             f"template {tuple(template.shape)}")
        # a cut leaf is a strided view: copied before it becomes a tensor
        return torch.as_tensor(arr if arr.flags.c_contiguous else arr.copy(),
                               device=template.device)
    return arr


def restore(ckpt_dir: str, step: int, template, mesh=None, specs=None,
            check: bool = True):
    """Load ``step`` into the structure of ``template``: a tensor leaf
    comes back as a tensor on that leaf's device, any other leaf as a
    numpy array.  With ``mesh`` and ``specs`` (a tree of PartitionSpecs
    shaped like ``template``), each leaf is this rank's shard of the
    saved array, whatever layout saved it."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if check:
        arrays, ok = _load_checked(path)
        if not ok:
            raise IOError(f"checksum mismatch in {path}")
    else:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
    if mesh is None:
        return _rebuild(template, arrays, lambda key, a: a)
    sp = {key: spec for key, spec in _leaves(specs)}

    def cut(key, a):
        for d, axes in enumerate(par.dim_axes(sp[key], a.ndim)):
            a = par.block(a, d, mesh, axes)
        return a
    return _rebuild(template, arrays, cut)


def load_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)
