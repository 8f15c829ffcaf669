"""Flow-shape bucketing: the 64-pixel ladder of ``compute-flow``.

Port of ``video_analytics_tpu/ops/bucketing.py``.  ``compute-flow`` and
``warmup`` pad each gray pair at its edges up to the next multiple of
`BUCKET_MULTIPLE` on both axes (edge-replicated), compute the flow at that
shape and crop it back.  The port has no per-shape compile to share; the
module exists so that the port's default ``compute-flow`` writes the
reference's flow, which this padding changes.

Semantics note: edge-replicated padding gives zero image gradient in the
pad band, so the computed flow differs from the native-shape flow only in
a border band (the same band where dense flow is ill-posed anyway).
Exact-parity paths (tests, library calls) call the flow functions directly;
bucketing is applied at the command line, where arbitrary user
resolutions arrive (``--no-bucket`` turns it off).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

BUCKET_MULTIPLE = 64


def bucket_hw(h: int, w: int, multiple: int = BUCKET_MULTIPLE
              ) -> Tuple[int, int]:
    """The bucketed (padded-up) shape for an (h, w) frame."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def bucketed_flow(flow_fn: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor],
                  prev: torch.Tensor, nxt: torch.Tensor,
                  multiple: int = BUCKET_MULTIPLE) -> torch.Tensor:
    """Run `flow_fn` once on edge-padded-to-bucket gray pairs, crop back.

    prev/nxt: (B, H, W); returns (B, H, W, 2).  A shape that is already a
    bucket goes to `flow_fn` unpadded."""
    B, H, W = prev.shape
    bh, bw = bucket_hw(H, W, multiple)
    if (bh, bw) == (H, W):
        return flow_fn(prev, nxt)

    def pad(x: torch.Tensor) -> torch.Tensor:
        # Replicate padding, as jnp.pad(mode="edge"), on a (B, 1, H, W) view.
        return F.pad(x[:, None], (0, bw - W, 0, bh - H),
                     mode="replicate")[:, 0]

    flow = flow_fn(pad(prev), pad(nxt))
    return flow[:, :H, :W]
