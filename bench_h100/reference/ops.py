"""Plain image primitives of the reference: separable
correlations, the linear resize, the clamped bilinear sample and the
finite differences that TV-L1 and Farneback share.

A frozen copy of the arithmetic the benchmark holds the program to, in
plain PyTorch tensor code.  Each sum keeps its order (tap by tap, as the
published algorithms and OpenCV write them), so each term rounds as it
does there.  Border conventions follow OpenCV: replicate borders for
correlations and derivatives, reflect-101 for the Gaussian pre-blurs,
clamped coordinates for warps.  Each keeps its input's dtype (float32,
or bfloat16 for the flow control); sample coordinates stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_taps(sigma: float, n: Optional[int] = None) -> np.ndarray:
    """Normalised Gaussian over offsets [-n, n]; without `n`, OpenCV's
    automatic size (round(5·sigma) | 1, at least 3)."""
    if n is None:
        n = max(int(round(sigma * 5)) | 1, 3) // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def correlate_valid(x: torch.Tensor, taps: Sequence[float], dim: int
                    ) -> torch.Tensor:
    """Correlate (B, H, W) with `taps` along `dim` (1 = rows, 2 = columns)
    over the valid span, summed tap by tap."""
    n = len(taps)
    size = x.shape[dim] - n + 1
    acc = None
    for i in range(n):
        term = float(taps[i]) * x.narrow(dim, i, size)
        acc = term if acc is None else acc + term
    return acc


def pad(x: torch.Tensor, n: int, dim: int, mode: str) -> torch.Tensor:
    """Pad (B, H, W) by n on both sides of `dim`: "edge" replicates,
    "reflect" mirrors without repeating the border (reflect-101)."""
    widths = [0, 0, 0, 0]
    widths[0 if dim == 2 else 2] = n
    widths[1 if dim == 2 else 3] = n
    torch_mode = {"edge": "replicate", "reflect": "reflect"}[mode]
    return F.pad(x[:, None], widths, mode=torch_mode)[:, 0]


def separable(x: torch.Tensor, ky: Sequence[float], kx: Sequence[float],
              mode: str) -> torch.Tensor:
    """Rows with `ky`, then columns with `kx`, padded by `mode`."""
    y = correlate_valid(pad(x, len(ky) // 2, 1, mode), ky, 1)
    return correlate_valid(pad(y, len(kx) // 2, 2, mode), kx, 2)


def linear_weights(n_in: int, n_out: int, inv_scale: np.float32,
                   shift: np.float32) -> np.ndarray:
    """(n_in, n_out) weights of linear resampling without antialiasing:
    output o samples input position (o + 0.5)·inv_scale − shift − 0.5 with
    the triangle kernel, each column normalised by its sum (so a sample
    beyond the first or last input takes that input), zero outside
    [−0.5, n_in − 0.5].  All in float32."""
    f32 = np.float32
    pos = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
           - f32(shift) - f32(0.5))
    dist = np.abs(pos[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (pos >= f32(-0.5)) & (pos <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """Linear resize weights for scale n_out / n_in (1/scale rounded once
    to float32)."""
    return linear_weights(n_in, n_out, np.float32(1.0 / (n_out / n_in)),
                          np.float32(0.0))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """Resize along `dim` by the ≤ 2 nonzero taps of each output."""
    w = resize_weights(x.shape[dim], n_out).T
    idx = np.zeros((2, n_out), np.int64)
    wt = np.zeros((2, n_out), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(w[o])
        idx[:len(nz), o] = nz
        wt[:len(nz), o] = w[o, nz]
    shape = [1] * x.dim()
    shape[dim] = n_out
    i0, i1 = (torch.from_numpy(i).to(x.device) for i in idx)
    w0, w1 = (torch.from_numpy(v).to(x.device, x.dtype).view(shape)
              for v in wt)
    return x.index_select(dim, i0) * w0 + x.index_select(dim, i1) * w1


def resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of (B, H, W, ...) to (B, h, w, ...): rows, then
    columns."""
    h, w = out_hw
    y = x if x.shape[1] == h else _resize_axis(x, h, 1)
    return y if y.shape[2] == w else _resize_axis(y, w, 2)


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Sample (B, H, W, C) at (B, h, w) coordinates clamped to the image;
    returns (B, h, w, C) in the image's dtype."""
    B, H, W, C = img.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(ys).clamp(0, H - 2).to(torch.int64)
    x0 = torch.floor(xs).clamp(0, W - 2).to(torch.int64)
    fy = (ys - y0.to(ys.dtype))[..., None]
    fx = (xs - x0.to(xs.dtype))[..., None]
    flat = img.reshape(B, H * W, C)

    def at(yy, xx):
        idx = (yy * W + xx).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, C)

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)


def centred_gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences of (B, H, W), replicate border; (dx, dy)."""
    xp = pad(x, 1, 2, "edge")
    yp = pad(x, 1, 1, "edge")
    return ((xp[:, :, 2:] - xp[:, :, :-2]) * 0.5,
            (yp[:, 2:, :] - yp[:, :-2, :]) * 0.5)


def forward_gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero on the last column / row."""
    gx = torch.cat([x[:, :, 1:] - x[:, :, :-1],
                    torch.zeros_like(x[:, :, :1])], dim=2)
    gy = torch.cat([x[:, 1:, :] - x[:, :-1, :],
                    torch.zeros_like(x[:, :1, :])], dim=1)
    return gx, gy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    ``forward_gradient``."""
    d1 = torch.cat([p1[:, :, :1], p1[:, :, 1:] - p1[:, :, :-1]], dim=2)
    d2 = torch.cat([p2[:, :1, :], p2[:, 1:, :] - p2[:, :-1, :]], dim=1)
    return d1 + d2


def median(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k median of each (H, W) plane of (B, C, H, W), replicate
    border: the middle of the k² sorted neighbours."""
    B, C, H, W = x.shape
    n = k // 2
    xp = F.pad(x.reshape(B * C, 1, H, W), [n, n, n, n], mode="replicate")
    nbrs = torch.stack([xp[:, 0, i:i + H, j:j + W]
                        for i in range(k) for j in range(k)])
    return nbrs.median(dim=0).values.reshape(B, C, H, W)
