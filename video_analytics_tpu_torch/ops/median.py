"""Median filtering of flow fields (TV-L1 uses 3x3/5x5 medians between
warps to reject outliers), in PyTorch.

Port of ``video_analytics_tpu/ops/median.py``: stack the k² shifted
neighbourhoods (replicate border, cv2.medianBlur semantics) and reduce
with the same pruned Batcher median-selection network.  This is the
plain version of the CUDA median kernel (``ops/cuda/tvl1_solve.median5``),
whose compare-exchange list is generated from ``_median_network`` at
build time (``ops/cuda/_build.py``).  The median of k² values does not
depend on the network, so the two agree bit for bit.
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
