#!/usr/bin/env python3
"""Instructions and scheduled stall cycles in a range of a kernel's SASS.

    python3 tools/sass_stalls.py LIB_OR_SASS [START END] [--list]

Reads ``cuobjdump -sass`` of a built library (or a saved listing) and
decodes each instruction's control bits (sm_70 and later: the stall
count is bits 41-44 of its second 64-bit word, the cycles the compiler
makes the warp wait before its next instruction, on top of any wait on a
load).  With START and END (hex addresses) it prints the number of
instructions in [START, END) and the sum of their stall counts, and with
``--list`` each of them; without, each backward branch, to find loops.
"""
import argparse
import re
import subprocess
import sys

LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*/\* (0x[0-9a-f]+) \*/")
HI = re.compile(r"^\s*/\* (0x[0-9a-f]+) \*/")


def instructions(text):
    """[(address, instruction, stall cycles)] of a SASS listing."""
    out, lines = [], text.splitlines()
    for k, ln in enumerate(lines[:-1]):
        m = LINE.match(ln)
        hi = HI.match(lines[k + 1]) if m else None
        if m and hi:
            out.append((int(m.group(1), 16), m.group(2),
                        (int(hi.group(1), 16) >> 41) & 0xF))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("range", nargs="*", help="START END, hex")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.path.endswith(".so"):
        text = subprocess.run(["cuobjdump", "-sass", args.path],
                              capture_output=True, text=True,
                              check=True).stdout
    else:
        with open(args.path) as f:
            text = f.read()
    ins = instructions(text)
    if not args.range:
        for addr, op, _ in ins:
            m = re.search(r"BRA (0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                print(f"{addr:05x} {op}")
        return
    if len(args.range) != 2:
        sys.exit("sass_stalls: give START and END")
    lo, hi = (int(a, 16) for a in args.range)
    sel = [x for x in ins if lo <= x[0] < hi]
    if args.list:
        for addr, op, stall in sel:
            print(f"{addr:05x} stall={stall:2d}  {op}")
    print(f"{len(sel)} instructions, {sum(s for *_, s in sel)} cycles of "
          f"scheduled stalls in [{lo:x}, {hi:x})")


if __name__ == "__main__":
    main()
