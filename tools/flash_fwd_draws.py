#!/usr/bin/env python3
"""Hold the bf16 attention forward kernel and its plain version against
an f64 reference on many random draws, in the rows of the first key tile.

    python3 tools/flash_fwd_draws.py [--draws 40] [--B 4] [--S 4096]

Inputs: standard normal q, k, v in bf16 (torch.Generator on the card,
seeds 0..draws-1), qwen3-0.6b's heads (8 KV heads x 2 queries of 128),
causal. For each draw it runs ``flash_attention`` (the tensor-core
kernel) and ``flash_attention_plain`` (chunks of min(1024, S) keys), and
for query rows 0..63 the f64 softmax(bf(q * scale) k^T) v. It prints per
draw the flash phases' bf16 gate on the kernel against the plain version
(the largest excess over 2**-7 |want| + 2e-3, and how many elements
exceed it), and at the first tile's worst element: its row and number of
visible keys, the kernel's and the plain version's distance from the f64
value, the bf16 spacing at the value and the largest |v| among the row's
keys. A kernel at fault lies farther from the f64 value than the plain
version does; two correct roundings lie about equally far. Then the
card's name and power limit.
"""
import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 64   # the first key tile of the flash phases' gate (FLASH_TILE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=40)
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--S", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_draws: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import ops

    B, S, K, G, h = args.B, args.S, 8, 2, 128
    scale = ops.softmax_scale(h, torch.bfloat16)
    for seed in range(args.draws):
        gen = torch.Generator("cuda").manual_seed(seed)

        def draw(*shape):
            return torch.randn(shape, generator=gen,
                               device="cuda").bfloat16()
        q, k, v = draw(B, S, K, G, h), draw(B, S, K, h), draw(B, S, K, h)
        got = ops.flash_attention(q, k, v, causal=True).float()
        want = ops.flash_attention_plain(q, k, v, chunk=min(1024, S),
                                         causal=True).float()
        over = (got - want).abs() - (2.0 ** -7 * want.abs() + 2e-3)
        # f64 reference of the first tile's rows
        qs = (q[:, :ROWS] * torch.tensor(scale, dtype=q.dtype)).double()
        s = torch.einsum("bqkgh,bckh->bkgqc", qs, k[:, :ROWS].double())
        mask = torch.arange(ROWS)[:, None] >= torch.arange(ROWS)[None, :]
        s = torch.where(mask.cuda(), s, float("-inf"))
        exact = torch.einsum("bkgqc,bckh->bqkgh", torch.softmax(s, -1),
                             v[:, :ROWS].double())
        first = over[:, :ROWS]
        b, i, kh, g, d = (int(x) for x in torch.unravel_index(
            first.argmax(), first.shape))
        x = exact[b, i, kh, g, d].item()
        row = {"seed": seed, "B": B, "S": S,
               "worst_over_limit": over.max().item(),
               "elements_over_limit": int((over > 0).sum()),
               "worst_over_limit_first_tile": first.max().item(),
               "at": {"row": i, "keys": i + 1, "exact": x,
                      "kernel_err": abs(got[b, i, kh, g, d].item() - x),
                      "plain_err": abs(want[b, i, kh, g, d].item() - x),
                      "bf16_spacing": 2.0 ** (math.floor(math.log2(
                          max(abs(x), 1e-30))) - 7),
                      "max_abs_v_of_row": v[b, :i + 1, kh].float().abs()
                      .max().item()},
               "first_tile_kernel_err_max":
                   (got[:, :ROWS].double() - exact).abs().max().item(),
               "first_tile_plain_err_max":
                   (want[:, :ROWS].double() - exact).abs().max().item()}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
