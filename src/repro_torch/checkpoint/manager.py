"""Checkpointing: atomic, content-checksummed, keep-N.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json   (tmp dir + os.rename
for atomicity).

Counterpart of ``src/repro/checkpoint/manager.py`` with the same on-disk
format: the same ``SEP``-joined key paths, the same sha256 checksum and
the same manifest, so a directory either package writes verifies and
restores in the other.  A tree is nested dicts, lists and tuples whose
leaves are tensors or numpy arrays; it is flattened in the order
``jax.tree_util`` flattens it (dict keys sorted, sequences by index,
``None`` an empty subtree).  ``restore`` takes no mesh: re-sharding onto
another device layout waits for the multi-GPU port (ROADMAP.md item 8).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "//"


def _leaves(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, object]]:
    """(key path, leaf) pairs in jax.tree_util's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _leaves(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
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
         keep: int = 3) -> str:
    arrays = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
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


def _rebuild(template, data, path: Tuple[str, ...] = ()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, data, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(x, data, path + (str(i),))
               for i, x in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    arr = data[SEP.join(path)]
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr, device=template.device)
    return arr


def restore(ckpt_dir: str, step: int, template, check: bool = True):
    """Load ``step`` into the structure of ``template``: a tensor leaf
    comes back as a tensor on that leaf's device, any other leaf as a
    numpy array."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if check:
        arrays, ok = _load_checked(path)
        if not ok:
            raise IOError(f"checksum mismatch in {path}")
    else:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
    return _rebuild(template, arrays)


def load_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)
