"""Shared image-processing primitives for the flow algorithms, in PyTorch.

Port of ``video_analytics_tpu/ops/kernels.py``.  These are plain tensor
code: the reference runs them as XLA, and they are the plain versions
that the hand-written CUDA kernels (``ops/cuda/``) are held against.
Every function takes and returns tensors on the caller's device.

Border conventions mirror OpenCV as the reference does: replicate
borders for correlations, clamped continuous coordinates for warps.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, n: Optional[int] = None) -> np.ndarray:
    """Normalised 1D Gaussian over offsets [-n, n].

    When n is None uses OpenCV's automatic ksize rule
    (cvRound(sigma*5)|1 capped below at 3 → n = ksize//2)."""
    if n is None:
        ksize = max(int(round(sigma * 5)) | 1, 3)
        n = ksize // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def farneback_window_taps(winsize: int, gaussian: bool
                          ) -> Tuple[float, ...]:
    """Farneback 1D window-average taps: the winsize box window, or
    cv2's OPTFLOW_FARNEBACK_GAUSSIAN (σ = m·0.3 over [-m, m],
    m = winsize//2).  Single source for a cv2-parity-sensitive constant
    used by flow/farneback.py and the sep_corr kernel."""
    if gaussian:
        m = winsize // 2
        return tuple(float(t) for t in gaussian_kernel_1d(m * 0.3, n=m))
    return tuple([1.0 / winsize] * winsize)


def _conv1d(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """Correlate (B, H, W) with a 1D kernel along H (dim=1) or W (dim=2),
    VALID: an unrolled shift-and-add in the reference's order, so each
    tap rounds as it does there."""
    n = k.shape[0]
    size = x.shape[dim] - n + 1
    acc = None
    for i in range(n):
        term = float(k[i]) * x.narrow(dim, i, size)
        acc = term if acc is None else acc + term
    return acc


def pad_border(x: torch.Tensor, n: int, dims: Tuple[int, ...] = (1, 2),
               mode: str = "edge") -> torch.Tensor:
    """Pad (B, H, W) by n on the given spatial dims.  mode='edge' ≙ cv2
    BORDER_REPLICATE; 'reflect' ≙ BORDER_REFLECT_101."""
    pad = [0, 0, 0, 0]                       # (W left, W right, H top, H bottom)
    if 2 in dims:
        pad[0] = pad[1] = n
    if 1 in dims:
        pad[2] = pad[3] = n
    torch_mode = {"edge": "replicate", "reflect": "reflect"}[mode]
    return F.pad(x[:, None], pad, mode=torch_mode)[:, 0]


def sepcorr(x: torch.Tensor, ky: np.ndarray, kx: np.ndarray,
            border: str = "edge") -> torch.Tensor:
    """Separable 2D correlation of (B, H, W): vertical kernel ky then
    horizontal kernel kx (both length 2n+1)."""
    ny, nx = ky.shape[0] // 2, kx.shape[0] // 2
    xp = pad_border(x, ny, dims=(1,), mode=border)
    xp = pad_border(xp, nx, dims=(2,), mode=border)
    y = _conv1d(xp, ky, dim=1)
    return _conv1d(y, kx, dim=2)


def gaussian_blur(x: torch.Tensor, sigma: float, n: Optional[int] = None,
                  border: str = "reflect") -> torch.Tensor:
    """(B, H, W) Gaussian blur; default border reflect-101 like cv2's
    GaussianBlur with BORDER_DEFAULT."""
    g = gaussian_kernel_1d(sigma, n)
    return sepcorr(x, g, g, border=border)


def box_blur(x: torch.Tensor, winsize: int, border: str = "edge"
             ) -> torch.Tensor:
    """(B, H, W) normalised box filter: `winsize` taps of 1/winsize (in
    float32, as the reference builds them) along H, then W."""
    k = np.full((winsize,), 1.0 / winsize, np.float32)
    return sepcorr(x, k, k, border=border)


# -- linear resampling ------------------------------------------------------

def linear_weight_matrix(n_in: int, n_out: int, inv_scale: np.float32,
                         shift: np.float32) -> np.ndarray:
    """(n_in, n_out) float32 weights of linear resampling without
    antialiasing: ``jax.image``'s ``compute_weight_mat`` with the triangle
    kernel, in the same float32 operations, so both packages hold equal
    weights.  Output o samples input position
    ``(o + 0.5)·inv_scale − shift − 0.5``; ``shift`` is the reference's
    ``translation · inv_scale``.  Columns are normalised by their weight
    sum, and samples outside [−0.5, n_in − 0.5] get zero weight."""
    f32 = np.float32
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(shift) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """Weights of ``jax.image.resize(method='linear', antialias=False)``
    along one axis: scale n_out/n_in, no translation.  The reference
    takes ``1 / scale`` in double precision and rounds it once to f32."""
    return linear_weight_matrix(n_in, n_out,
                                np.float32(1.0 / (n_out / n_in)),
                                np.float32(0.0))


@functools.lru_cache(maxsize=64)
def _two_tap(n_in: int, n_out: int, device: torch.device):
    """The ≤ 2 nonzero taps of each output of ``resize_weights``:
    (index0, index1, weight0, weight1) tensors of length n_out."""
    w = resize_weights(n_in, n_out).T                    # (n_out, n_in)
    idx = np.zeros((2, n_out), np.int64)
    wt = np.zeros((2, n_out), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(w[o])
        if len(nz) > 2:
            raise AssertionError("linear resize row with > 2 taps")
        idx[:len(nz), o] = nz
        wt[:len(nz), o] = w[o, nz]
    return (torch.from_numpy(idx[0]).to(device),
            torch.from_numpy(idx[1]).to(device),
            torch.from_numpy(wt[0]).to(device),
            torch.from_numpy(wt[1]).to(device))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = _two_tap(x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    return (x.index_select(dim, i0) * w0.view(shape)
            + x.index_select(dim, i1) * w1.view(shape))


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of (B, H, W, ...) → (B, h, w, ...) over axes 1 and 2,
    the reference's ``jax.image.resize(linear, antialias=False)`` (trailing
    axes, e.g. a flow's (dx, dy), are carried along unchanged).

    The reference applies dense (in × out) weight matrices.  Linear
    weights have at most two nonzero taps per output, so this applies
    those two as gathers: elementwise per image, so an image's result
    does not depend on the batch it rides in (a batched matrix product
    may pick another summation order for another batch size).  It is
    differentiable with respect to `x`."""
    h, w = out_hw
    y = x if x.shape[1] == h else _resize_axis(x, h, 1)
    return y if y.shape[2] == w else _resize_axis(y, w, 2)


def resize_area_like(x: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """Bilinear resize of (B, H, W) → (B, h, w) (cv2 INTER_LINEAR):
    ``resize_linear`` of a gray batch."""
    return resize_linear(x, out_hw)


# -- warps and derivatives --------------------------------------------------

def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Sample (B, H, W, C) at continuous (ys, xs) of shape (B, h, w).

    Coordinates are clamped to the valid image rectangle (replicate
    border, cv2-style out-of-range handling).  Returns (B, h, w, C).
    """
    B, H, W, C = img.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(ys).clamp(0, H - 2).to(torch.int64)
    x0 = torch.floor(xs).clamp(0, W - 2).to(torch.int64)
    fy = (ys - y0.to(ys.dtype))[..., None]
    fx = (xs - x0.to(xs.dtype))[..., None]
    flat = img.reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, C)

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp (B, H, W, C) by flow (B, H, W, 2) where
    flow[..., 0] = dx, flow[..., 1] = dy: out(p) = img(p + flow(p)),
    clamped to the image (``bilinear_sample``).  Differentiable with
    respect to both the image and the flow."""
    _, H, W, _ = flow.shape
    yy = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None]
    xx = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :]
    return bilinear_sample(img, yy + flow[..., 1], xx + flow[..., 0])


def centered_gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient of (B, H, W) with replicate borders
    (border derivative = one-sided difference halved, cv2-style).
    Returns (dx, dy)."""
    xp = pad_border(x, 1, dims=(2,), mode="edge")
    gx = (xp[:, :, 2:] - xp[:, :, :-2]) * 0.5
    yp = pad_border(x, 1, dims=(1,), mode="edge")
    gy = (yp[:, 2:, :] - yp[:, :-2, :]) * 0.5
    return gx, gy


def forward_gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with zero at the last row/col (the adjoint
    convention the TV dual update needs)."""
    gx = torch.cat([x[:, :, 1:] - x[:, :, :-1],
                    torch.zeros_like(x[:, :, :1])], dim=2)
    gy = torch.cat([x[:, 1:, :] - x[:, :-1, :],
                    torch.zeros_like(x[:, :1, :])], dim=1)
    return gx, gy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    forward_gradient: div(p)(i,j) = p1(i,j)-p1(i,j-1) + p2(i,j)-p2(i-1,j),
    with the first col/row using p directly."""
    d1 = torch.cat([p1[:, :, :1], p1[:, :, 1:] - p1[:, :, :-1]], dim=2)
    d2 = torch.cat([p2[:, :1, :], p2[:, 1:, :] - p2[:, :-1, :]], dim=1)
    return d1 + d2
