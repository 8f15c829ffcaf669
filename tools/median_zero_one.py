#!/usr/bin/env python3
"""Exhaustive check of K-C's generated median schedule by the 0-1
principle: a network of min and max operations selects the median of its
inputs for every input if it does so for every input of zeros and ones.

    python3 tools/median_zero_one.py [--k 3 5]

For each output of ``ops/median.separable_median_schedule(k)`` (a thread's
column of outputs in csrc/median.cu) it takes the operations that output
depends on, checks that they read exactly its k x k window, and runs them
on all 2^(k*k) 0-1 assignments of the window, bit-packed (k = 5: 32 Mi
assignments, about half a minute and under 0.5 GB on one CPU core).
Exits non-zero on the first output that does not give the median.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_analytics_tpu_torch.ops.median import (  # noqa: E402
    MEDIAN_TILE, separable_median_schedule)


def check(k: int) -> None:
    rows, cols, ops, outputs = separable_median_schedule(k)
    n_in = rows * cols
    tile_cols = MEDIAN_TILE[1]
    for idx, out in enumerate(outputs):
        needed, cone = {out}, []
        for op in reversed(ops):
            if op[1] in needed:
                cone.append(op)
                needed.update(op[2:])
        cone.reverse()
        inputs = sorted(w for w in needed if w < n_in)
        r0, c0 = divmod(idx, tile_cols)
        window = sorted((r0 + a) * cols + c0 + b
                        for a in range(k) for b in range(k))
        if inputs != window:
            raise SystemExit(f"k={k} output {idx}: reads {inputs}, its "
                             f"window is {window}")
        patterns = np.arange(1 << len(inputs), dtype=np.uint32)
        ones = np.zeros(patterns.shape, np.uint8)
        wires = {}
        for j, w in enumerate(inputs):
            bit = ((patterns >> np.uint32(j)) & np.uint32(1)).astype(np.uint8)
            ones += bit
            wires[w] = np.packbits(bit)
        del patterns
        last = {}
        for t, op in enumerate(cone):
            last[op[2]] = last[op[3]] = t
        for t, (kind, o, a, b) in enumerate(cone):
            wires[o] = (wires[a] & wires[b]) if kind == "min" \
                else (wires[a] | wires[b])
            for w in (a, b):
                if last.get(w) == t:
                    wires.pop(w, None)
        want = np.packbits((ones > len(inputs) // 2).astype(np.uint8))
        if not np.array_equal(wires[out], want):
            raise SystemExit(f"k={k} output {idx}: not the median")
        print(f"k={k} output {idx}: the median on all 2^{len(inputs)} 0-1 "
              f"inputs ({len(cone)} min/max)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[3, 5])
    for k in ap.parse_args().k:
        check(k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
