"""Median filtering of flow fields (TV-L1 uses 3x3/5x5 medians between
warps to reject outliers), in PyTorch.

Port of ``video_analytics_tpu/ops/median.py``: stack the k² shifted
neighbourhoods (replicate border, cv2.medianBlur semantics) and reduce
with the same pruned Batcher median-selection network.  This is the
plain version of the CUDA median kernel (``ops/cuda/tvl1_solve.median5``),
whose compare-exchange list is generated from ``_median_network`` at
build time (``ops/cuda/_build.py``).  The median of k² values does not
depend on the network, so the two agree bit for bit.

``separable_median_schedule`` is the other network the build generates:
the one the CUDA median runs, which makes a small tile of outputs a
thread and shares the sorting of their common neighbourhood.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Batcher odd-even mergesort compare-exchange pairs for n wires
    (n a power of two), in execution order; each (i, j) has i < j and
    sorts ascending (wire i gets min)."""
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


@functools.lru_cache(maxsize=8)
def _median_network(k2: int) -> Tuple[Tuple[Tuple[int, int], ...], int]:
    """(compare-exchange pairs, median wire) computing the median of k2
    (odd) values, derived from a padded Batcher sort by (a) dropping
    exchanges that only move +inf padding (wires >= k2 start at +inf;
    an exchange with one such wire just renames, recorded as a move
    (i, -1 - src)) and (b) backward-pruning exchanges that cannot reach
    the median wire."""
    n = 1
    while n < k2:
        n *= 2
    median_wire = k2 // 2
    inf = [w >= k2 for w in range(n)]
    kept: List[Tuple[int, int]] = []
    for (i, j) in _batcher_pairs(n):
        if inf[i] and inf[j]:
            continue
        if inf[i] or inf[j]:
            src = j if inf[i] else i
            if src != i:
                kept.append((i, -1 - src))
            inf[i], inf[j] = False, True
            continue
        kept.append((i, j))
    needed = {median_wire}
    pruned: List[Tuple[int, int]] = []
    for (i, j) in reversed(kept):
        if j < 0:
            if i in needed:
                pruned.append((i, j))
                needed.discard(i)
                needed.add(-1 - j)
            continue
        if i in needed or j in needed:
            pruned.append((i, j))
            needed.add(i)
            needed.add(j)
    return tuple(reversed(pruned)), median_wire


def _median_select(wires: List[torch.Tensor]) -> torch.Tensor:
    """Median of the k² same-shaped tensors via the pruned network."""
    network, median_wire = _median_network(len(wires))
    wires = list(wires)
    for (i, j) in network:
        if j < 0:
            wires[i] = wires[-1 - j]
        else:
            wires[i], wires[j] = (torch.minimum(wires[i], wires[j]),
                                  torch.maximum(wires[i], wires[j]))
    return wires[median_wire]


def median_filter2d(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Median filter (B, H, W) with a ksize×ksize window, replicate
    border — matches cv2.medianBlur for interior pixels and border
    convention BORDER_REPLICATE."""
    if ksize <= 1:
        return x
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, got {ksize}")
    n = ksize // 2
    xp = F.pad(x[:, None], [n, n, n, n], mode="replicate")[:, 0]
    H, W = x.shape[1], x.shape[2]
    windows = [xp[:, i:i + H, j:j + W]
               for i in range(ksize) for j in range(ksize)]
    return _median_select(windows)


# -- the tile schedule of the CUDA median (csrc/median.cu) -------------------

# Outputs a thread of the CUDA median makes: a column of 8 rows.  Picked by
# the min/max operations per output of ``separable_median_schedule`` (k = 5:
# 1x1 214, 2x2 77, 4x2 69.2, 8x1 71.2, 8x2 64.9; k = 3: 8x1 18.5, against
# 226 and 48 for the pruned Batcher networks) and by what the thread holds:
# a column keeps a warp's shared-memory reads and stores on consecutive
# addresses, and its 12 x 5 inputs stay in registers (8x2 needs 72).
MEDIAN_TILE = (8, 1)


class _Network:
    """A comparator network in single-assignment form: wires 0..n_in - 1
    are the inputs, each compare-exchange adds a min wire and a max wire."""

    def __init__(self, n_in: int):
        self.n = n_in
        self.ops: List[Tuple[str, int, int, int]] = []

    def exchange(self, a: int, b: int) -> Tuple[int, int]:
        lo, hi = self.n, self.n + 1
        self.n += 2
        self.ops += [("min", lo, a, b), ("max", hi, a, b)]
        return lo, hi

    def merge(self, a: List[int], b: List[int]) -> List[int]:
        """Batcher's odd-even merge of two sorted wire lists of any
        lengths: merge the even-indexed and the odd-indexed elements
        apart, then one exchange between neighbours of the interleave."""
        if not a or not b:
            return list(a or b)
        if len(a) == 1 and len(b) == 1:
            return list(self.exchange(a[0], b[0]))
        v = self.merge(a[0::2], b[0::2])
        w = self.merge(a[1::2], b[1::2])
        out, i = [v[0]], 0
        while i < len(w) and i + 1 < len(v):
            out += self.exchange(w[i], v[i + 1])
            i += 1
        return out + w[i:] + v[i + 1:]


@functools.lru_cache(maxsize=8)
def separable_median_schedule(k: int, tile: Tuple[int, int] = MEDIAN_TILE):
    """The min/max schedule that gives the k×k medians of a tile of outputs
    from the tile's (th + k - 1) × (tw + k - 1) input neighbourhood.

    The separable, forgetful scheme of A. Adams, "Fast median filters using
    separable sorting networks" (ACM TOG 40(4), 2021): the part of the
    neighbourhood that every window of the tile covers (its core) is sorted
    once; the tile is halved, along its longer side, and each half merges
    the strip its windows add to the core, down to single outputs.  Sorted
    lists are made by merging row segments (memoised, so a segment is sorted
    once for every window that holds it), and after each merge the ranks
    that cannot be any window's median are forgotten: an element with more
    than half the window's remaining elements above it (or below) is below
    (above) the median, and dropping as many from the bottom as from the
    top keeps the median the middle of what remains.  Exchanges no output
    needs are pruned, and an exchange whose max (or min) is unused keeps
    only its min (max).

    Returns (rows, cols, ops, outputs): the input grid's shape; ops, in
    order, as (kind, out, a, b) with kind "min" or "max" and wires 0 ..
    rows * cols - 1 the inputs in row-major order; outputs, the wire of
    each output of the tile in row-major order.
    """
    th, tw = tile
    if k % 2 != 1 or th < 1 or tw < 1:
        raise ValueError(f"separable_median_schedule: k odd, tile >= 1; got "
                         f"{k}, {tile}")
    rows, cols = th + k - 1, tw + k - 1
    net = _Network(rows * cols)
    sorted_rects = {}

    def rect(r0: int, r1: int, c0: int, c1: int) -> List[int]:
        """The sorted wires of input rows [r0, r1) x columns [c0, c1)."""
        if r0 >= r1 or c0 >= c1:
            return []
        key = (r0, r1, c0, c1)
        if key not in sorted_rects:
            if (r1 - r0) * (c1 - c0) == 1:
                sorted_rects[key] = [r0 * cols + c0]
            elif r1 - r0 == 1:
                cm = (c0 + c1) // 2
                sorted_rects[key] = net.merge(rect(r0, r1, c0, cm),
                                              rect(r0, r1, cm, c1))
            else:
                rm = (r0 + r1) // 2
                sorted_rects[key] = net.merge(rect(r0, rm, c0, c1),
                                              rect(rm, r1, c0, c1))
        return sorted_rects[key]

    def core(t):
        """Input rows and columns every window of output tile t covers."""
        r0, r1, c0, c1 = t
        return r1 - 1, r0 + k, c1 - 1, c0 + k

    def forget(merged: List[int], dropped: int):
        remaining = k * k - 2 * dropped
        d = max(0, len(merged) - (remaining + 1) // 2)
        return merged[d:len(merged) - d], dropped + d

    outputs = {}

    def split(t, kept: List[int], c, dropped: int) -> None:
        r0, r1, c0, c1 = t
        if (r1 - r0) * (c1 - c0) == 1:
            outputs[(r0, c0)] = kept[0]
            return
        by_rows = r1 - r0 >= c1 - c0
        if by_rows:
            m = (r0 + r1) // 2
            halves = ((r0, m, c0, c1), (m, r1, c0, c1))
        else:
            m = (c0 + c1) // 2
            halves = ((r0, r1, c0, m), (r0, r1, m, c1))
        cr0, cr1, cc0, cc1 = c
        for half in halves:
            hc = core(half)
            if cr0 >= cr1 or cc0 >= cc1:            # no common core yet
                strip = rect(*hc)
            elif by_rows:
                strip = (rect(hc[0], cr0, cc0, cc1) if hc[0] < cr0
                         else rect(cr1, hc[1], cc0, cc1))
            else:
                strip = (rect(cr0, cr1, hc[2], cc0) if hc[2] < cc0
                         else rect(cr0, cr1, cc1, hc[3]))
            half_kept, half_dropped = forget(net.merge(kept, strip), dropped)
            split(half, half_kept, hc, half_dropped)

    whole = (0, th, 0, tw)
    kept, dropped = forget(rect(*core(whole)), 0)
    split(whole, kept, core(whole), dropped)
    out_wires = tuple(outputs[(r, c)] for r in range(th) for c in range(tw))
    needed, ops = set(out_wires), []
    for op in reversed(net.ops):
        if op[1] in needed:
            ops.append(op)
            needed.update(op[2:])
    return rows, cols, tuple(reversed(ops)), out_wires
