"""Farnebäck 2003 dense optical flow on the GPU.

Port of ``video_analytics_tpu/flow/farneback.py``: what that package
computes with its exact 2-D gather (its XLA branch), which is what its
tests hold against ``cv2.calcOpticalFlowFarneback``.  Parameter names and
defaults mirror OpenCV's (``FarnebackConfig``).

Each pixel neighbourhood is fit with a quadratic f(x) = xᵀAx + bᵀx + c by
Gaussian-weighted least squares; for a displacement d between two
expansions, A = (A1 + A2w)/2 and Δb = −(b2w − b1)/2 + A·d; d is solved
from window-averaged normal equations (AᵀA)d = AᵀΔb, iterated with
re-warping, coarse to fine over an image pyramid.

First, at every pyramid level (span ``va/farneback.pyramid``):
  - K-D ``fb_prologue``: the level's pre-blur, resize and polynomial
    expansion of every frame, once per frame (one launch; two where the
    level samples a large frame sparsely, ``prologue_form``);
then level by level, coarsest first (span
``va/farneback.level.<h>x<w>``):
  - ``iterations`` times ``fb_iterate``: warp the second frame's
    expansion by the flow and form the normal equations (K-E), average
    them over the window along y and along x, and solve the 2×2 system
    of every pixel.  For windows up to 73 taps that is one launch of
    ``fb_iteration`` (K-E's arithmetic as the loader of the window
    average's tiles); longer windows take K-E and ``fb_window_solve`` or,
    beyond 193 taps, K-E and two of ``sep_corr`` (``window_route``).
    Any blur or window length runs on the kernels.

On CUDA tensors these are the hand-written kernels of
``ops/cuda/farneback.py``; on CPU tensors, or with ``plain=True``, their
plain PyTorch versions, which are built from the functions of this
module.  Inside, planes are channels-first, ``(B, 5, H, W)`` and
``(B, 2, H, W)``; the public functions return ``(B, H, W, 2)`` as the
reference does.  What the reference does only for the TPU (warp bands,
VMEM gates, transposed layouts, the fallback chain between kernels) has
no counterpart here.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from video_analytics_tpu_torch.config import FarnebackConfig
from video_analytics_tpu_torch.ops.kernels import (
    _conv1d, bilinear_sample, farneback_window_taps, gaussian_kernel_1d,
    pad_border, resize_area_like, sepcorr)
from video_analytics_tpu_torch.utils.spans import span


# ---------------------------------------------------------------------------
# Polynomial expansion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _poly_exp_setup(n: int, sigma: float):
    """1D applicability kernels + the inverse-Gramian coefficients.

    Mirrors OpenCV's FarnebackPrepareGaussian: build the 6x6 Gramian of
    the basis (1, x, y, x², y², xy) under the separable Gaussian
    applicability, invert, and keep the entries used for coefficient
    recovery (ig11, ig03, ig33, ig55).
    """
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    G = np.zeros((6, 6), np.float64)
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            w = g[yy + n] * g[xx + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[3, 3] += w * xx ** 4
            G[5, 5] += w * xx * xx * yy * yy
    G[2, 2] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32),
            float(ig11), float(ig03), float(ig33), float(ig55))


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(B, H, W) image → (B, 5, H, W) poly coefficients
    (bx, by, cxx, cyy, cxy) via separable correlations, replicate
    border.  The three vertical sums are shared by the six horizontal
    ones; each sum is what ``sepcorr`` of its tap pair gives."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_setup(n, sigma)
    xp = pad_border(pad_border(img.float(), n, dims=(1,)), n, dims=(2,))
    vg, vxg, vxxg = (_conv1d(xp, k, dim=1) for k in (g, xg, xxg))
    s1 = _conv1d(vg, g, dim=2)         # const
    sx = _conv1d(vg, xg, dim=2)        # x
    sy = _conv1d(vxg, g, dim=2)        # y
    sxx = _conv1d(vg, xxg, dim=2)      # x²
    syy = _conv1d(vxxg, g, dim=2)      # y²
    sxy = _conv1d(vxg, xg, dim=2)      # xy

    bx = sx * ig11
    by = sy * ig11
    cxx = s1 * ig03 + sxx * ig33
    cyy = s1 * ig03 + syy * ig33
    cxy = sxy * ig55
    return torch.stack([bx, by, cxx, cyy, cxy], dim=1)


# ---------------------------------------------------------------------------
# Matrix update + flow solve
# ---------------------------------------------------------------------------

_BORDER_WEIGHTS = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


@functools.lru_cache(maxsize=32)
def _border_attenuation_np(h: int, w: int) -> np.ndarray:
    wy = np.ones(h, np.float32)
    wx = np.ones(w, np.float32)
    for i, s in enumerate(_BORDER_WEIGHTS):
        if i < h:
            wy[i] *= s
            wy[h - 1 - i] *= s
        if i < w:
            wx[i] *= s
            wx[w - 1 - i] *= s
    return np.outer(wy, wx)


def _border_attenuation(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w) cv2-style border attenuation: entries within 5 px of the
    frame are down-weighted, so the window average trusts interior
    pixels more."""
    return torch.from_numpy(_border_attenuation_np(h, w)).to(device)


def _normal_equations(r0, r1w, dx, dy, inb, att):
    """Per-pixel normal-equation entries from the two images' poly planes
    (`r0`, `r1w` are 5-tuples of plane tensors): the out-of-bounds
    branch, the border attenuation and the G/h products, returned as 5
    planes.  The 0.5/0.25 factors and the out-of-bounds fallback are the
    reference's, derived there to bit-level cv2 parity; the order of
    every product and sum is part of the result in float32."""
    a11 = torch.where(inb, (r0[2] + r1w[2]) * 0.5, r0[2])
    a22 = torch.where(inb, (r0[3] + r1w[3]) * 0.5, r0[3])
    a12 = torch.where(inb, (r0[4] + r1w[4]) * 0.25, r0[4] * 0.5)
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    b1w = torch.where(inb, r1w[0], zero)
    b2w = torch.where(inb, r1w[1], zero)
    dbx = (r0[0] - b1w) * 0.5 + a11 * dx + a12 * dy
    dby = (r0[1] - b2w) * 0.5 + a12 * dx + a22 * dy

    a11, a22, a12 = a11 * att, a22 * att, a12 * att
    dbx, dby = dbx * att, dby * att

    g11 = a11 * a11 + a12 * a12
    g12 = (a11 + a22) * a12
    g22 = a22 * a22 + a12 * a12
    h1 = a11 * dbx + a12 * dby
    h2 = a12 * dbx + a22 * dby
    return g11, g12, g22, h1, h2


def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy, xx


def _oob_mask(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """cv2's FarnebackUpdateMatrices interior test on (B, h, w) flow
    planes: floor(p + flow) must stay inside [0, size-2] on both axes
    (which excludes the exact last row/column even at zero flow)."""
    _, h, w = dx.shape
    yy, xx = _pixel_grid(h, w, dx.device)
    x1 = torch.floor(xx + dx)
    y1 = torch.floor(yy + dy)
    return (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """Per-pixel normal-equation entries (B, 5, H, W) =
    (G11, G12, G22, h1, h2) from paired expansions (B, 5, H, W) and the
    current flow (B, 2, H, W).

    Out-of-bounds semantics mirror cv2's FarnebackUpdateMatrices: where
    floor(p + flow) leaves [0, size-2] on either axis, the warped
    expansion is discarded and A := A0, Δb := b0/2."""
    _, _, H, W = R0.shape
    dx, dy = flow[:, 0], flow[:, 1]
    yy, xx = _pixel_grid(H, W, flow.device)
    R1w = bilinear_sample(R1.permute(0, 2, 3, 1), yy + dy, xx + dx)
    planes = _normal_equations(
        tuple(R0[:, i] for i in range(5)),
        tuple(R1w[..., i] for i in range(5)), dx, dy, _oob_mask(dx, dy),
        _border_attenuation(H, W, flow.device)[None])
    return torch.stack(planes, dim=1)


def _solve_flow(M: torch.Tensor) -> torch.Tensor:
    """(B, 5, H, W) averaged normal equations → (B, 2, H, W) flow: the
    2x2 solve with cv2's regularised inverse 1/(det + 1e-3).

    det = (a11·a22 − a12²)² ≥ 0, so the +1e-3 is a pure damping: near
    borders the attenuation shrinks det by scale⁴ and the regulariser
    dominates, damping the flow toward 0, as cv2's does."""
    g11, g12, g22, h1, h2 = (M[:, i] for i in range(5))
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + 1e-3)
    fx = (g22 * h1 - g12 * h2) * idet
    fy = (g11 * h2 - g12 * h1) * idet
    return torch.stack([fx, fy], dim=1)


def _window_taps(cfg: FarnebackConfig) -> np.ndarray:
    return np.array(farneback_window_taps(cfg.winsize, cfg.gaussian_window),
                    np.float32)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def _level_sizes(h: int, w: int, cfg: FarnebackConfig
                 ) -> List[Tuple[int, int, float]]:
    """Per-level (h, w, scale), coarsest first, finest last.

    cv2 semantics: levels are clamped so no level's side drops below 32
    px, and level k has scale pyr_scale**k for k = levels..0."""
    min_size = 32
    levels = cfg.levels
    scale = 1.0
    for k in range(cfg.levels):
        scale *= cfg.pyr_scale
        if w * scale < min_size or h * scale < min_size:
            levels = k
            break
    sizes = []
    for k in range(levels, -1, -1):
        s = cfg.pyr_scale ** k
        sizes.append((int(round(h * s)), int(round(w * s)), s))
    return sizes


def _smooth_taps(scale: float) -> Tuple[float, ...]:
    """cv2's per-level pre-blur taps: sigma = (1/scale − 1)·0.5 with the
    auto ksize rule, except scale >= 1 where cv2's minimum-3 clamp yields
    the fixed [0.25, 0.5, 0.25] kernel: cv2 always pre-blurs, at full
    resolution too.  Single source for this cv2-parity-sensitive
    constant, shared with the prologue kernel."""
    if scale >= 1.0:
        return (0.25, 0.5, 0.25)
    sigma = (1.0 / scale - 1.0) * 0.5
    return tuple(float(t) for t in gaussian_kernel_1d(sigma))


def _smooth_and_resize(img: torch.Tensor, scale: float,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """OpenCV's per-level image prep of (B, H, W): Gaussian blur (taps
    from _smooth_taps, reflect-101 border) on the original image, then
    bilinear resize (rows first, then columns)."""
    k = np.array(_smooth_taps(scale), np.float32)
    sm = sepcorr(img, k, k, border="reflect")
    if scale >= 1.0:
        return sm
    return resize_area_like(sm, out_hw)


def _resize_flow(flow: torch.Tensor, out_hw: Tuple[int, int],
                 gain: float) -> torch.Tensor:
    """Bilinear resize of a (B, 2, h, w) flow, values scaled by `gain`."""
    B = flow.shape[0]
    up = resize_area_like(flow.reshape(B * 2, *flow.shape[2:]), out_hw)
    return (up * gain).reshape(B, 2, *out_hw)


def _pyramid_flow(frames: torch.Tensor, pair, n_pairs: int,
                  cfg: FarnebackConfig,
                  initial_flow: Optional[torch.Tensor],
                  plain: bool) -> torch.Tensor:
    """The coarse-to-fine loop shared by the pair and sequence forms.

    `frames` is (N, H, W): every distinct frame once.  `pair(R)` slices a
    level's (N, 5, lh, lw) expansions into the pairs' (R0, R1), each
    (n_pairs, 5, lh, lw).  Returns (n_pairs, 2, H, W)."""
    from video_analytics_tpu_torch.ops.cuda import farneback as kern
    prologue = kern.fb_prologue_plain if plain else kern.fb_prologue
    iterate = kern.fb_iteration_plain if plain else kern.fb_iterate

    frames = frames.float().contiguous()
    _, H, W = frames.shape
    taps = _window_taps(cfg)
    sizes = _level_sizes(H, W, cfg)
    # Every level's expansions first (the per-frame work), then the
    # per-pair iterations level by level, coarse to fine.
    with span("va/farneback.pyramid"):
        expansions = [pair(prologue(frames, scale, (lh, lw), cfg.poly_n,
                                    cfg.poly_sigma))
                      for lh, lw, scale in sizes]
    flow = None
    for lh, lw, scale in sizes:
        R0, R1 = expansions.pop(0)
        with span("va/farneback.level.%dx%d", lh, lw):
            if flow is not None:
                # cv2: bilinear-resize the coarser flow and scale values
                # by exactly 1/pyr_scale (not the rounded size ratio).
                flow = _resize_flow(flow, (lh, lw), 1.0 / cfg.pyr_scale)
            elif cfg.use_initial_flow and initial_flow is not None:
                seed = initial_flow.float().permute(0, 3, 1, 2).contiguous()
                flow = _resize_flow(seed, (lh, lw), scale)
            else:
                flow = torch.zeros((n_pairs, 2, lh, lw), dtype=torch.float32,
                                   device=frames.device)
            for _ in range(cfg.iterations):
                flow = iterate(R0, R1, flow, taps)
    return flow


def farneback(prev: torch.Tensor, nxt: torch.Tensor,
              cfg: FarnebackConfig = FarnebackConfig(),
              initial_flow: Optional[torch.Tensor] = None,
              plain: bool = False) -> torch.Tensor:
    """Dense flow for a batch of gray frame pairs.

    Args:
      prev, nxt: (B, H, W) in [0, 255] (float or uint8), on one device.
      cfg: FarnebackConfig.
      initial_flow: optional (B, H, W, 2) seed, used when
        ``cfg.use_initial_flow`` (cv2.OPTFLOW_USE_INITIAL_FLOW).
      plain: run the plain PyTorch versions of the kernels even on CUDA
        tensors (the reference the kernels are checked against).

    Returns:
      (B, H, W, 2) float32 flow, channels (dx, dy):
      prev(p) ≈ next(p + flow(p)).
    """
    B = prev.shape[0]
    flow = _pyramid_flow(
        torch.cat([prev.float(), nxt.float()]),
        lambda R: (R[:B], R[B:]), B, cfg, initial_flow, plain)
    return flow.permute(0, 2, 3, 1)


def farneback_sequence(frames: torch.Tensor,
                       cfg: FarnebackConfig = FarnebackConfig(),
                       plain: bool = False) -> torch.Tensor:
    """Flow for all consecutive pairs of a (T, H, W) frame sequence →
    (T-1, H, W, 2), or of B sequences (B, T, H, W) → (B, T-1, H, W, 2).

    Identical math to ``farneback(frames[:-1], frames[1:], cfg)``, but
    the per-frame work (the per-level smoothing, resize and polynomial
    expansion, which the pair form computes twice per interior frame)
    runs once per frame, over all frames of all sequences in one call,
    and is paired by slicing within each sequence.
    """
    batched = frames.dim() == 4
    if not batched:
        frames = frames[None]
    B, T, H, W = frames.shape

    def pair(R):
        R = R.reshape(B, T, *R.shape[1:])
        return (R[:, :-1].reshape(B * (T - 1), *R.shape[2:]),
                R[:, 1:].reshape(B * (T - 1), *R.shape[2:]))

    flow = _pyramid_flow(frames.reshape(B * T, H, W), pair, B * (T - 1),
                         cfg, None, plain)
    flow = flow.permute(0, 2, 3, 1).reshape(B, T - 1, H, W, 2)
    return flow if batched else flow[0]
