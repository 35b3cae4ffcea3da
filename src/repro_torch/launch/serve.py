"""Serving launcher: the continuous-batching engine over a (reduced or
published) architecture with synthetic requests, reporting latency and
throughput.

Counterpart of ``src/repro/launch/serve.py``, with the same flags plus
``--device``.  ``--smoke`` (the default) serves the reduced config;
``--no-smoke`` serves the published one.

    python -m repro_torch.launch.serve --arch zamba2-1.2b [--no-smoke] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.zoo import get_model
from repro_torch.serving.engine import Engine, Request


def serve(arch: str, *, smoke: bool = True, requests: int = 8,
          slots: int = 4, max_len: int = 96, max_new: int = 16,
          seed: int = 0, device="cuda",
          prompt_lens: Optional[Sequence[int]] = None,
          layers: Optional[int] = None):
    """Serve ``requests`` synthetic requests and return a dict with the
    engine, the finished requests, ``stats()`` and the wall seconds.
    Prompts are drawn from ``np.random.default_rng(seed)`` as the JAX
    launcher draws them (lengths 4..15), unless ``prompt_lens`` gives
    the length of request i as ``prompt_lens[i % len(prompt_lens)]``.
    Parameters are drawn from ``torch.Generator(device)`` seeded with
    ``seed``.  ``layers`` cuts the depth (widths stay), for a model
    whose parameters do not fit on the card at full depth.  The encdec
    family raises ``NotImplementedError``: the engine takes token
    prompts, as the JAX engine does, and it takes frame embeddings."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{arch}: the engine takes token prompts and the encdec family "
            f"takes frame embeddings (as in the JAX engine); drive its "
            f"prefill / decode_step directly")
    if smoke:
        cfg = smoke_config(cfg)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = get_model(cfg)
    model.init(torch.Generator(dev).manual_seed(seed))
    eng = Engine(model, model.params, slots=slots, max_len=max_len)

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    for i in range(requests):
        n = (int(rng.integers(4, 16)) if prompt_lens is None
             else prompt_lens[i % len(prompt_lens)])
        prompt = rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    done = eng.run_until_drained()
    return {"cfg": cfg, "model": model, "engine": eng, "done": done,
            "stats": eng.stats(), "wall_s": time.monotonic() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = serve(args.arch, smoke=args.smoke, requests=args.requests,
                slots=args.slots, max_len=args.max_len, max_new=args.max_new,
                seed=args.seed, device=args.device)
    print(f"arch={out['cfg'].name} served {len(out['done'])} requests in "
          f"{out['wall_s']:.1f}s")
    for k, v in out["stats"].items():
        print(f"  {k}: {v:.2f}")
    return out


if __name__ == "__main__":
    main()
