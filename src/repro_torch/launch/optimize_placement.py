"""EGRL placement entry point on the port: --arch x --shape -> placement
plan JSON.

Counterpart of ``src/repro/launch/optimize_placement.py``, with the
same plan schema (``plan_from_mapping``).  ``--arch`` is a registry id
(its graph extracted at ``--shape`` by ``graphs/extract.py``) or a
workload of ``graphs.zoo.WORKLOADS`` (which carries its own shape).

    python -m repro_torch.launch.optimize_placement --arch bert
    python -m repro_torch.launch.optimize_placement --arch granite-3-8b \
        --shape decode_32k [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.egrl import EGRL, EGRLConfig
from repro_torch.device import resolve_device
from repro_torch.graphs.extract import extract_for
from repro_torch.graphs.zoo import WORKLOADS
from repro_torch.memsim import tiers as T
from repro_torch.memsim.simulator import evaluate


def make_graph(arch: str, shape_name: str):
    """A zoo workload by name, else ``extract_for(arch, shape_name)``
    (raises ``KeyError`` for an unknown id or unsupported shape)."""
    if arch in WORKLOADS:
        return WORKLOADS[arch]()
    return extract_for(arch, shape_name)


def plan_from_mapping(graph, mapping: np.ndarray, meta: dict) -> dict:
    tiers = [t.name for t in T.TIERS]
    ops = []
    for i, nd in enumerate(graph.nodes):
        ops.append({
            "index": i, "op": nd.op,
            "weight_tier": tiers[int(mapping[i, 0])],
            "act_tier": tiers[int(mapping[i, 1])],
            "weight_bytes": nd.weight_bytes, "act_bytes": nd.ofm_bytes,
        })
    # framework knobs: fraction of activations the plan wants resident
    resident = np.mean(mapping[:, 1] != T.HBM_IDX)
    remat = "none" if resident > 0.85 else ("dots" if resident > 0.4 else "full")
    return {**meta, "ops": ops,
            "derived": {"act_resident_frac": float(resident),
                        "suggested_remat": remat}}


def optimize(arch: str, shape_name: str, steps: int, mode: str = "egrl",
             seed: int = 0, device="cuda", log=print):
    """Search a placement for ``arch`` at ``shape_name``; returns (plan
    dict, driver).  Zoo workloads carry their own fixed shapes."""
    dev = resolve_device(device)
    g = make_graph(arch, shape_name)
    algo = EGRL(g, EGRLConfig(total_steps=steps, seed=seed), mode=mode,
                device=dev)
    algo.train(log=log)
    clat = algo.ref_latency
    res = evaluate(algo.sg, torch.as_tensor(algo.best_mapping, device=dev),
                   clat)
    meta = {
        "arch": arch, "shape": shape_name, "graph_nodes": g.n,
        "mode": mode, "env_steps": algo.steps,
        "speedup_vs_compiler": float(res["speedup"]),
        "latency_ms": float(res["latency"]) * 1e3,
        "compiler_latency_ms": clat * 1e3,
    }
    return plan_from_mapping(g, algo.best_mapping, meta), algo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=list(ARCH_IDS) + list(WORKLOADS))
    ap.add_argument("--shape", default="decode_32k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--mode", default="egrl", choices=["egrl", "ea", "pg"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/plans")
    args = ap.parse_args()

    plan, _ = optimize(args.arch, args.shape, args.steps, args.mode,
                       args.seed, args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}.json")
    with open(path, "w") as f:
        json.dump(plan, f, indent=1)
    print(f"speedup vs compiler: {plan['speedup_vs_compiler']:.3f} "
          f"({plan['compiler_latency_ms']:.3f} -> {plan['latency_ms']:.3f} ms)")
    print(f"plan written to {path}")


if __name__ == "__main__":
    main()
