"""Sharding plans: logical axes -> mesh axes, decided per (arch, shape, mesh).

Copied from ``src/repro/distributed/rules.py`` (``ShardingPlan`` ``:28``,
``make_plan`` ``:62``).  Strategy:
- batch over ("pod","data") when divisible (DP), params' embed dim over
  "data" (FSDP), heads/mlp/vocab/expert over "model" (TP/EP);
- attention falls back to sequence-parallel (SP) when head counts do not
  divide the model axis (qwen2.5's 40 heads on a 16-way axis);
- decode KV caches shard kv-heads over "model" when divisible, otherwise
  the cache *sequence* dim is sharded (partial-softmax decode); for
  global_batch=1 long-context decode the sequence dim also absorbs the
  unused data axes.

``make_plan`` reads only ``mesh.axis_names`` and ``mesh.devices.shape``,
so it takes the one-process ``launch.mesh.Mesh``, the process mesh of
``launch.mesh.make_process_mesh`` and JAX's tests' fake meshes alike.
JAX's ``wsc`` (``:53``, ``with_sharding_constraint``) has no
counterpart: eager PyTorch has no GSPMD to insert collectives, so the
port does what each constraint means with the explicit operations of
``distributed/parallel.py`` (Megatron's f and g, the vocab-parallel
embedding and loss, the gradient rule), called where the JAX models
constrain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.utils.params import PartitionSpec as P


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    rules: dict                 # param logical axis -> mesh axes
    batch_axes: Any             # mesh axes for the batch dim of activations
    seq_axes: Any               # mesh axes for seq dim (SP) or None
    shard_heads: bool           # attention computed head-parallel?
    kv_ok: bool                 # kv heads divisible by model axis?
    cache_batch: Any
    cache_seq: Any
    cache_kv: Any
    data_axes: Tuple[str, ...]  # all non-model axes
    resid_seq: Any = None       # seq axes of the residual stream (Megatron-SP)
    mesh: Optional[Any] = None
    model_axis: str = "model"

    def batch_spec(self, *trailing) -> P:
        return P(self.batch_axes, *trailing)

    def act_spec(self) -> P:  # (B, S, D) activations
        return P(self.batch_axes, self.seq_axes or self.resid_seq, None)

    def cache_spec(self) -> P:  # (L, B, S, K, h) stacked KV cache
        return P(None, self.cache_batch, self.cache_seq, self.cache_kv, None)

    @property
    def model_size(self) -> int:
        """Devices on the "model" axis (1 without a mesh)."""
        return 1 if self.mesh is None else _axis_size(self.mesh,
                                                      self.model_axis)


def make_plan(cfg: ModelConfig, mesh, shape: ShapeCfg) -> ShardingPlan:
    model = _axis_size(mesh, "model")
    data_axes = tuple(a for a in mesh.axis_names if a != "model")

    # ---- batch dim: greedily absorb data-like axes while divisible
    b_axes, prod = [], 1
    for a in data_axes:
        n = _axis_size(mesh, a)
        if shape.global_batch % (prod * n) == 0:
            b_axes.append(a)
            prod *= n
    batch_axes = tuple(b_axes) or None
    spare_data = tuple(a for a in data_axes if a not in b_axes)

    # ---- attention: head-parallel (kv replicated+expanded when kv doesn't
    # divide) vs sequence-parallel when even q-heads don't divide (qwen2.5)
    heads_ok = cfg.n_heads > 0 and cfg.n_heads % model == 0
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model == 0
    shard_heads = heads_ok
    seq_axes = None if (shard_heads or cfg.n_heads == 0) else "model"
    resid_seq = ("model" if (cfg.seq_shard_activations
                             and shape.kind != "decode"
                             and shape.seq_len % model == 0) else None)

    # ---- decode KV cache
    cache_kv = "model" if kv_ok else None
    cache_seq_axes = [] if kv_ok else ["model"]
    cache_seq_axes += list(spare_data)  # B=1 long-context: seq over data too
    cache_seq = tuple(cache_seq_axes) or None

    ssm_heads = 0
    if cfg.ssm is not None:
        d_inner = cfg.d_model * cfg.ssm.expand
        ssm_heads = d_inner // cfg.ssm.head_dim

    rules = {
        "layer": None,
        "stage": None,
        "embed": "data",  # FSDP dim for weights
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "head_dim": None,
        "mlp": "model" if cfg.d_ff % model == 0 or cfg.d_ff == 0 else None,
        "mlp_exp": "model",
        "vocab": "model",
        "expert": "model" if (cfg.moe and cfg.moe.n_experts % model == 0) else None,
        "ssm_inner": "model" if cfg.ssm and (cfg.d_model * cfg.ssm.expand) % model == 0 else None,
        "ssm_head": "model" if ssm_heads and ssm_heads % model == 0 else None,
        "ssm_state": None,
        "conv": None,
        None: None,
    }
    return ShardingPlan(
        rules=rules,
        batch_axes=batch_axes,
        seq_axes=seq_axes,
        shard_heads=shard_heads,
        kv_ok=kv_ok,
        resid_seq=resid_seq,
        cache_batch=batch_axes,
        cache_seq=cache_seq,
        cache_kv=cache_kv,
        data_axes=data_axes,
        mesh=mesh,
    )
