"""TV-L1 dense optical flow (Zach, Pock, Bischof 2007) on the GPU.

Port of ``video_analytics_tpu/flow/tvl1.py``.  Parameter names and
defaults mirror OpenCV's ``DualTVL1OpticalFlow`` (``TVL1Config``); the
iteration structure follows the IPOL reference implementation:

per scale (coarse→fine): centred gradient of I1, then ``warps`` times
  - warp I1 and ∇I1 by the current flow and form the linearised residual
    (K-A ``ops/cuda/warp.warp_prep``),
  - run the primal-dual solver with its median between outer rounds and
    the per-image ε stop (K-B/K-C ``ops/cuda/tvl1_solve.pd_solve``),
then the scale-end median (K-C) and the upscale of the flow to the next
finer level by 1/scale_step.

On CUDA tensors the warp, solver and medians are the hand-written
kernels; on CPU tensors, or with ``plain=True``, their plain PyTorch
versions.  The pyramid (Gaussian blur + linear resize) and the centred
gradient are plain tensor code, as they are XLA in the reference.  What
the reference does only for the TPU (lane packing, VMEM gates, warp
bands, batch rounding) has no counterpart here.

Each image stops on its own ε test, as the reference's Pallas solvers
do; so an image's flow does not depend on the batch it rides in.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.ops.cuda.tvl1_solve import (
    median5, median5_plain, pd_solve, pd_solve_plain)
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep, warp_prep_plain
from video_analytics_tpu_torch.ops.kernels import (
    centered_gradient, gaussian_blur, resize_area_like)

_MIN_SIZE = 16         # coarsest pyramid level must keep both dims >= this
_ZOOM_SIGMA0 = 0.6     # IPOL pre-smoothing constant for pyramid downscale


def _level_sizes(h: int, w: int, cfg: TVL1Config) -> List[Tuple[int, int]]:
    """Finest-first level sizes, clamped so the coarsest dim >= 16."""
    sizes = [(h, w)]
    for s in range(1, cfg.nscales):
        scale = cfg.scale_step ** s
        lh, lw = int(round(h * scale)), int(round(w * scale))
        if min(lh, lw) < _MIN_SIZE:
            break
        sizes.append((lh, lw))
    return sizes


def _downscale(img: torch.Tensor, out_hw: Tuple[int, int],
               zoom: float) -> torch.Tensor:
    """IPOL zoom-out: Gaussian pre-smooth with σ = 0.6·√(1/z² − 1),
    then bilinear resize."""
    sigma = _ZOOM_SIGMA0 * math.sqrt(1.0 / zoom ** 2 - 1.0) \
        if zoom < 1.0 else 0.0
    sm = gaussian_blur(img, sigma) if sigma > 1e-6 else img
    return resize_area_like(sm, out_hw)


def tvl1(prev: torch.Tensor, nxt: torch.Tensor,
         cfg: TVL1Config = TVL1Config(), plain: bool = False
         ) -> torch.Tensor:
    """Dense TV-L1 flow for a batch of gray frame pairs.

    Args:
      prev, nxt: (B, H, W) in [0, 255] (float or uint8), on one device.
      cfg: TVL1Config.  ``use_initial_flow`` is not supported yet.
      plain: run the plain PyTorch versions of the kernels even on CUDA
        tensors (the reference the kernels are checked against).

    Returns:
      (B, H, W, 2) float32 flow (dx, dy): prev(p) ≈ next(p + flow(p)).
    """
    if cfg.use_initial_flow:
        raise NotImplementedError("use_initial_flow is not ported yet")
    warp = warp_prep_plain if plain else warp_prep
    solve = pd_solve_plain if plain else pd_solve
    median = median5_plain if plain else median5

    I0_full = prev.float().contiguous()
    I1_full = nxt.float().contiguous()
    B, H, W = I0_full.shape
    sizes = _level_sizes(H, W, cfg)

    # Pyramids finest→coarsest, each level from the previous one.
    I0s, I1s = [I0_full], [I1_full]
    for s in range(1, len(sizes)):
        I0s.append(_downscale(I0s[-1], sizes[s], cfg.scale_step))
        I1s.append(_downscale(I1s[-1], sizes[s], cfg.scale_step))

    uv = None
    for s in range(len(sizes) - 1, -1, -1):
        lh, lw = sizes[s]
        I0, I1 = I0s[s].contiguous(), I1s[s]
        if uv is None:
            uv = torch.zeros((B, 2, lh, lw), dtype=torch.float32,
                             device=I0.device)
        else:
            up = resize_area_like(uv.reshape(B * 2, *uv.shape[2:]), (lh, lw))
            uv = (up * (1.0 / cfg.scale_step)).reshape(B, 2, lh, lw)
        I1x, I1y = centered_gradient(I1)
        i13 = torch.stack([I1, I1x, I1y], dim=1).contiguous()
        for _ in range(cfg.warps):
            uv = solve(warp(i13, I0, uv), uv, cfg)
        if cfg.median_filtering > 1:
            uv = median(uv, cfg.median_filtering)
    return uv.permute(0, 2, 3, 1)
