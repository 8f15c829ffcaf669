"""Plain Farnebäck (2003) dense optical flow with OpenCV's
``calcOpticalFlowFarneback`` parameters: the benchmark's frozen
reference.

Each neighbourhood is fit with a quadratic by Gaussian-weighted least
squares (the polynomial expansion); per level, coarse to fine, the
second frame's expansion is warped by the flow, the per-pixel normal
equations are averaged over the window along y and then x, and the 2×2
system of each pixel is solved with OpenCV's damping 1/(det + 1e-3),
``iterations`` times.  Each level pre-blurs the frame (OpenCV's sigma
rule, reflect-101) and resizes it; the coarser flow is resized and scaled
by 1/pyr_scale.  The sequence form expands each frame once.  Float32,
or bfloat16 throughout for the flow control (``dtype``).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from bench_h100.reference import ops

BORDER_WEIGHTS = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def level_sizes(h: int, w: int, cfg: dict) -> List[Tuple[int, int, float]]:
    """(h, w, scale) per level, coarsest first; no level under 32 px."""
    levels, scale = cfg["levels"], 1.0
    for k in range(cfg["levels"]):
        scale *= cfg["pyr_scale"]
        if w * scale < 32 or h * scale < 32:
            levels = k
            break
    return [(int(round(h * cfg["pyr_scale"] ** k)),
             int(round(w * cfg["pyr_scale"] ** k)), cfg["pyr_scale"] ** k)
            for k in range(levels, -1, -1)]


def smooth_taps(scale: float) -> np.ndarray:
    """A level's pre-blur: sigma (1/scale − 1)/2, or [¼, ½, ¼] at full
    resolution (OpenCV's smallest kernel)."""
    if scale >= 1.0:
        return np.array([0.25, 0.5, 0.25], np.float32)
    return ops.gaussian_taps((1.0 / scale - 1.0) * 0.5)


def window_taps(cfg: dict) -> np.ndarray:
    if cfg["gaussian_window"]:
        m = cfg["winsize"] // 2
        return ops.gaussian_taps(m * 0.3, n=m)
    return np.array([1.0 / cfg["winsize"]] * cfg["winsize"], np.float32)


@functools.lru_cache(maxsize=8)
def _expansion_setup(n: int, sigma: float):
    """The applicability's 1-D kernels (g, x·g, x²·g) and the entries of
    the inverse Gramian of (1, x, y, x², y², xy) that recover the
    coefficients."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
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
    inv = np.linalg.inv(G)
    return ((g.astype(np.float32), (x * g).astype(np.float32),
             (x * x * g).astype(np.float32)),
            (float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]),
             float(inv[5, 5])))


def expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(B, H, W) → (B, 5, H, W) coefficients (bx, by, cxx, cyy, cxy),
    replicate border."""
    (g, xg, xxg), (ig11, ig03, ig33, ig55) = _expansion_setup(n, sigma)
    img = img if img.is_floating_point() else img.float()
    xp = ops.pad(ops.pad(img, n, 1, "edge"), n, 2, "edge")
    vg, vxg, vxxg = (ops.correlate_valid(xp, k, 1) for k in (g, xg, xxg))
    s1 = ops.correlate_valid(vg, g, 2)
    sx = ops.correlate_valid(vg, xg, 2)
    sy = ops.correlate_valid(vxg, g, 2)
    sxx = ops.correlate_valid(vg, xxg, 2)
    syy = ops.correlate_valid(vxxg, g, 2)
    sxy = ops.correlate_valid(vxg, xg, 2)
    return torch.stack([sx * ig11, sy * ig11, s1 * ig03 + sxx * ig33,
                        s1 * ig03 + syy * ig33, sxy * ig55], dim=1)


def border_attenuation(h: int, w: int, device) -> torch.Tensor:
    wy = np.ones(h, np.float32)
    wx = np.ones(w, np.float32)
    for i, s in enumerate(BORDER_WEIGHTS):
        if i < h:
            wy[i] *= s
            wy[h - 1 - i] *= s
        if i < w:
            wx[i] *= s
            wx[w - 1 - i] *= s
    return torch.from_numpy(np.outer(wy, wx)).to(device)


def normal_equations(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor
                     ) -> torch.Tensor:
    """(B, 5, H, W) planes (G11, G12, G22, h1, h2) from the expansions and
    the (B, 2, H, W) flow; where floor(p + flow) leaves [0, size − 2] the
    warped expansion is dropped (A = A0, Δb = b0/2), as OpenCV does."""
    _, _, H, W = R0.shape
    dx, dy = flow[:, 0], flow[:, 1]
    yy = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=flow.device)[None, :]
    R1w = ops.bilinear_sample(R1.permute(0, 2, 3, 1), yy + dy, xx + dx)
    r0 = [R0[:, i] for i in range(5)]
    r1 = [R1w[..., i] for i in range(5)]
    x1, y1 = torch.floor(xx + dx), torch.floor(yy + dy)
    inb = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    att = border_attenuation(H, W, flow.device)[None].to(R0.dtype)
    a11 = torch.where(inb, (r0[2] + r1[2]) * 0.5, r0[2])
    a22 = torch.where(inb, (r0[3] + r1[3]) * 0.5, r0[3])
    a12 = torch.where(inb, (r0[4] + r1[4]) * 0.25, r0[4] * 0.5)
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    b1w = torch.where(inb, r1[0], zero)
    b2w = torch.where(inb, r1[1], zero)
    dbx = (r0[0] - b1w) * 0.5 + a11 * dx + a12 * dy
    dby = (r0[1] - b2w) * 0.5 + a12 * dx + a22 * dy
    a11, a22, a12 = a11 * att, a22 * att, a12 * att
    dbx, dby = dbx * att, dby * att
    return torch.stack([a11 * a11 + a12 * a12, (a11 + a22) * a12,
                        a22 * a22 + a12 * a12, a11 * dbx + a12 * dby,
                        a12 * dbx + a22 * dby], dim=1)


def window_solve(M: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Average the planes over the window (replicate border) along y,
    then x, and solve each pixel's 2×2 system → (B, 2, H, W)."""
    B, C, h, w = M.shape
    n = len(taps) // 2
    x = M.reshape(B * C, h, w)
    x = ops.correlate_valid(ops.pad(x, n, 1, "edge"), taps, 1)
    x = ops.correlate_valid(ops.pad(x, n, 2, "edge"), taps, 2)
    g11, g12, g22, h1, h2 = x.reshape(B, C, h, w).unbind(1)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet], dim=1)


def farneback_sequence(frames: torch.Tensor, cfg: dict,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, H, W) gray sequences in [0, 255] → (B, T−1, H, W, 2) flow of
    consecutive pairs (dx, dy), prev(p) ≈ next(p + flow(p)).  `cfg` holds
    OpenCV's parameter names (``pyr_scale``, ``levels``, ``winsize``,
    ``iterations``, ``poly_n``, ``poly_sigma``, ``gaussian_window``)."""
    B, T, H, W = frames.shape
    flat = frames.reshape(B * T, H, W).to(dtype).contiguous()
    taps = window_taps(cfg)
    flow = None
    for lh, lw, scale in level_sizes(H, W, cfg):
        if flow is None:
            flow = torch.zeros((B * (T - 1), 2, lh, lw), dtype=dtype,
                               device=frames.device)
        else:
            up = ops.resize(flow.reshape(-1, *flow.shape[2:]), (lh, lw))
            flow = (up * (1.0 / cfg["pyr_scale"])).reshape(-1, 2, lh, lw)
        k = smooth_taps(scale)
        img = ops.separable(flat, k, k, "reflect")
        if scale < 1.0:
            img = ops.resize(img, (lh, lw))
        R = expansion(img, cfg["poly_n"], cfg["poly_sigma"])
        R = R.reshape(B, T, *R.shape[1:])
        R0 = R[:, :-1].reshape(B * (T - 1), *R.shape[2:])
        R1 = R[:, 1:].reshape(B * (T - 1), *R.shape[2:])
        for _ in range(cfg["iterations"]):
            flow = window_solve(normal_equations(R0, R1, flow), taps)
    return flow.permute(0, 2, 3, 1).reshape(B, T - 1, H, W, 2)
