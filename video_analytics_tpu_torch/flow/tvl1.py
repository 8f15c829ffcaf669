"""TV-L1 dense optical flow (Zach, Pock, Bischof 2007) on the GPU.

Port of ``video_analytics_tpu/flow/tvl1.py``.  Parameter names and
defaults mirror OpenCV's ``DualTVL1OpticalFlow`` (``TVL1Config``); the
iteration structure follows the IPOL reference implementation:

per scale (coarse→fine): centred gradient of I1, then ``warps`` times
  - warp I1 and ∇I1 by the current flow and form the linearised residual
    (K-A ``ops/cuda/warp.warp_prep``),
  - run the primal-dual solver with its median between outer rounds and
    the ε stop, per image,
then the scale-end median (K-C) and the upscale of the flow to the next
finer level by 1/scale_step.  The size rule of ``level_solver`` picks the
kernels of a level: where an image's state fits the shared memory of a
cluster of 8 or 16 thread blocks (every level under the reference's size
rule but very wide ones), the whole scale (every warp with its prep and
solve, and the scale-end median) is one launch
(``ops/cuda/tvl1_solve.pd_solve_scale``, in clusters that a large batch
may take smaller: ``scale_blocks``); where it does not, K-A per
warp, one launch per iteration (K-B/K-C ``pd_solve``) and K-C at the end;
at a level too large for the reference's whole-plane solver, K-A, several
iterations per launch with row bands that stop on their own (K-G
``pd_solve_chunked``) and K-C.

On CUDA tensors the warp, solver and medians are the hand-written
kernels; on CPU tensors, or with ``plain=True``, their plain PyTorch
versions.  The pyramid (Gaussian blur + linear resize) and the centred
gradient are plain tensor code, as they are XLA in the reference.  What
the reference does only for the TPU (lane packing, VMEM gates, warp
bands, batch rounding) has no counterpart here, with one exception: the
size rule that sends a level to the banded solver changes the result
(bands stop on their own ε test), so the port keeps its own copy of it
(``whole_plane_level``) and native-resolution flow takes the same path in
both packages.

Each image stops on its own ε test, as the reference's Pallas solvers
do; so an image's flow does not depend on the batch it rides in.

While ``tvl1.rounds`` holds a list (None by default), each call appends
one ``LevelRounds`` per pyramid level, coarsest first: the outer rounds
its images (on a chunked level, its images' row bands) ran in each warp,
as the solvers report them.  The roofline's work count
(``tools/torch_roofline.py``) reads them; the flow is the same with or
without them.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.ops.cuda.tvl1_solve import (
    chunk_params, median5, median5_plain, pd_solve, pd_solve_chunked,
    pd_solve_chunked_plain, pd_solve_plain, pd_solve_scale,
    pd_solve_scale_plain, warp_geometry)
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep, warp_prep_plain
from video_analytics_tpu_torch.ops.kernels import (
    centered_gradient, gaussian_blur, resize_area_like)
from video_analytics_tpu_torch.utils.spans import span

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


def whole_plane_level(h: int, w: int, median: int) -> bool:
    """Whether the reference solves an (h, w) level with its whole-plane
    solver (True) or its banded one (False): its working-set rule,
    (12 + k² + 2)·h·w floats under 13 MiB with a k×k median, 12·h·w
    without (``ops/pallas/tvl1_solve.solver_fits_vmem``).  With the
    default 5×5 median the banded solver takes every level above 87,381
    pixels, about 295²."""
    planes = 12 + (median * median + 2 if median > 1 else 0)
    return planes * h * w * 4 < 13 * 1024 * 1024


def level_solver(h: int, w: int, median: int,
                 whole_plane: Callable[[int, int, int], bool]
                 = whole_plane_level) -> str:
    """Which solver an (h, w) level takes, by its size alone: "chunked"
    above the reference's whole-plane rule, else "warp" where the level's
    state fits the shared memory of a cluster of 8 or 16 thread blocks
    (``warp_geometry``: every square-ish level under the rule, 224², 256²,
    240×320 and 280×300 among them), else "chain", the per-iteration
    kernels (a level too wide for 16 strips, e.g. 20×4000).
    "warp" levels run a whole scale in one launch (``pd_solve_scale``);
    "warp" and "chain" compute the same function and differ only in the
    order of the ε test's sum."""
    if not whole_plane(h, w, median):
        return "chunked"
    return "warp" if warp_geometry(h, w) is not None else "chain"


class LevelRounds(NamedTuple):
    """The rounds one pyramid level of a ``tvl1`` call ran.

    ``rounds`` is int32 on the flow's device: (B, warps) on a "warp"
    level, (warps, B) on a "chain" level and (warps, B, ceil(h / band))
    on a "chunked" one, whose row bands of ``band`` rows stop on their
    own (``band`` is 0 on the other levels)."""

    hw: Tuple[int, int]
    solver: str
    band: int
    rounds: torch.Tensor


def tvl1(prev: torch.Tensor, nxt: torch.Tensor,
         cfg: TVL1Config = TVL1Config(),
         initial_flow: Optional[torch.Tensor] = None, plain: bool = False,
         whole_plane: Callable[[int, int, int], bool] = whole_plane_level
         ) -> torch.Tensor:
    """Dense TV-L1 flow for a batch of gray frame pairs.

    Args:
      prev, nxt: (B, H, W) in [0, 255] (float or uint8), on one device.
      cfg: TVL1Config.
      initial_flow: optional (B, H, W, 2) seed, used when
        ``cfg.use_initial_flow`` (cv2.OPTFLOW_USE_INITIAL_FLOW).
      plain: run the plain PyTorch versions of the kernels even on CUDA
        tensors (the reference the kernels are checked against).
      whole_plane: the size rule (h, w, median) → bool that keeps a level
        on the whole-plane solvers; the others take the chunked one.
        Tests pass their own to reach the chunked solver at a small size.

    Returns:
      (B, H, W, 2) float32 flow (dx, dy): prev(p) ≈ next(p + flow(p)).
    """
    log = tvl1.rounds
    warp = warp_prep_plain if plain else warp_prep
    solve_scale = pd_solve_scale_plain if plain else pd_solve_scale
    solve_chain = pd_solve_plain if plain else pd_solve
    solve_chunked = pd_solve_chunked_plain if plain else pd_solve_chunked
    median = median5_plain if plain else median5

    I0_full = prev.float().contiguous()
    I1_full = nxt.float().contiguous()
    B, H, W = I0_full.shape
    sizes = _level_sizes(H, W, cfg)

    # Pyramids finest→coarsest, each level from the previous one.
    I0s, I1s = [I0_full], [I1_full]
    with span("va/tvl1.pyramid"):
        for s in range(1, len(sizes)):
            I0s.append(_downscale(I0s[-1], sizes[s], cfg.scale_step))
            I1s.append(_downscale(I1s[-1], sizes[s], cfg.scale_step))

    uv = None
    for s in range(len(sizes) - 1, -1, -1):
        lh, lw = sizes[s]
        with span("va/tvl1.level.%dx%d", lh, lw):
            I0, I1 = I0s[s].contiguous(), I1s[s]
            seeded = cfg.use_initial_flow and initial_flow is not None
            if uv is None and seeded:
                seed = initial_flow.float().permute(0, 3, 1, 2)
                seed = resize_area_like(seed.reshape(B * 2, H, W), (lh, lw))
                uv = (seed * cfg.scale_step ** s).reshape(B, 2, lh, lw)
            elif uv is None:
                uv = torch.zeros((B, 2, lh, lw), dtype=torch.float32,
                                 device=I0.device)
            else:
                up = resize_area_like(uv.reshape(B * 2, *uv.shape[2:]),
                                      (lh, lw))
                uv = (up * (1.0 / cfg.scale_step)).reshape(B, 2, lh, lw)
            I1x, I1y = centered_gradient(I1)
            i13 = torch.stack([I1, I1x, I1y], dim=1).contiguous()
            which = level_solver(lh, lw, cfg.median_filtering, whole_plane)
            band, rounds = 0, None
            if which == "warp":
                if log is not None:
                    rounds = I0.new_zeros((B, cfg.warps), dtype=torch.int32)
                    log.append(LevelRounds((lh, lw), which, band, rounds))
                counts = {} if rounds is None else {"rounds": rounds}
                uv = solve_scale(i13, I0, uv, cfg, **counts)
                continue
            if which == "chain":
                level_solve = solve_chain
                shape = (cfg.warps, B)
            else:
                band, chunk = chunk_params(lh, lw, cfg)
                level_solve = functools.partial(solve_chunked, band=band,
                                                chunk=chunk)
                shape = (cfg.warps, B, -(-lh // band))
            if log is not None:
                rounds = I0.new_zeros(shape, dtype=torch.int32)
                log.append(LevelRounds((lh, lw), which, band, rounds))
            for k in range(cfg.warps):
                counts = {} if rounds is None else {"rounds": rounds[k]}
                uv = level_solve(warp(i13, I0, uv), uv, cfg, **counts)
            if cfg.median_filtering > 1:
                uv = median(uv, cfg.median_filtering)
    return uv.permute(0, 2, 3, 1)


tvl1.rounds = None     # a list to receive each level's LevelRounds
