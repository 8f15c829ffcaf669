"""K-D, K-E, K-F and ``fb_window_solve``: the kernels of the Farneback
path.

They replace the eight Farneback kernels of
``video_analytics_tpu/ops/pallas/farneback_kernels.py``, which are
TPU-layout and VMEM-size variants of three computations:

- K-D ``fb_prologue`` (``csrc/fb_prologue.cu``): ``poly_prologue_pallas``
  and its unfused twin ``poly_expansion_pallas``: per frame and level,
  the pre-blur, the bilinear resize and the polynomial expansion;
- K-E ``fb_warp_neq`` (``csrc/fb_warp_neq.cu``): the warp and
  normal-equation halves of ``_neq_corr_axis``, ``warp_neq_corr_pallas``,
  ``corr_solve_warp_from_T_pallas``, ``warp_emit_T_pallas`` and
  ``farneback_level_pallas``, and the five-plane use of
  ``ops/pallas/warp.py``;
- K-F ``sep_corr`` (``csrc/sep_corr.cu``): ``_sep_corr_axis`` and the
  window-average and 2×2-solve halves of ``_neq_corr_axis``,
  ``warp_neq_corr_pallas``, ``corr_solve_from_T_pallas``,
  ``corr_solve_warp_from_T_pallas`` and ``farneback_level_pallas``;
- ``fb_window_solve`` (``csrc/fb_window_solve.cu``): K-F along y, K-F
  along x and the solve in one launch, as ``corr_solve_from_T_pallas``
  keeps both passes in one kernel; and ``fb_iteration``, the same launch
  with K-E's arithmetic as its tile loader, one whole iteration of
  ``farneback_level_pallas``.

Each wrapper stands beside its plain PyTorch version, which is built
from the functions of ``flow/farneback.py`` and is what a CPU tensor
gets.  On a CUDA tensor a wrapper launches its kernel or raises.  The
source notes in ``csrc/`` say what bounds each kernel on the H100.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from video_analytics_tpu_torch.flow.farneback import (
    _BORDER_WEIGHTS, _poly_exp_setup, _smooth_and_resize, _smooth_taps,
    _solve_flow, poly_expansion, update_matrices)
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.ops.kernels import (
    _conv1d, _two_tap, pad_border)

MAX_TAPS = 31          # va::MAX_TAPS of csrc/common.cuh


def _c_floats(values: Sequence[float]):
    """A C float array of the taps, each rounded to float32 once."""
    return (ctypes.c_float * len(values))(*[float(v) for v in values])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- K-D: blur + resize + polynomial expansion ------------------------------

def fb_prologue_plain(frames: torch.Tensor, scale: float,
                      out_hw: Tuple[int, int], poly_n: int,
                      poly_sigma: float) -> torch.Tensor:
    """Plain PyTorch version of ``fb_prologue``: ``_smooth_and_resize``
    then ``poly_expansion`` (``flow/farneback.py``)."""
    return poly_expansion(_smooth_and_resize(frames.float(), scale, out_hw),
                          poly_n, poly_sigma)


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in: int, n_out: int, device: torch.device):
    """The two taps per output of the linear resize along one axis, as
    one (2, n_out) int32 and one (2, n_out) float32 tensor."""
    i0, i1, w0, w1 = _two_tap(n_in, n_out, device)
    return (torch.stack([i0, i1]).to(torch.int32).contiguous(),
            torch.stack([w0, w1]).contiguous())


def fb_prologue(frames: torch.Tensor, scale: float, out_hw: Tuple[int, int],
                poly_n: int, poly_sigma: float) -> torch.Tensor:
    """One pyramid level's per-frame work, in one launch.

    Args:
      frames: (N, H, W) float32 gray frames at full resolution.
      scale: the level's scale (1 at the finest); picks the pre-blur
        taps (``_smooth_taps``) and whether the level is resized.
      out_hw: the level's (lh, lw); any size, not only H/2^k.
      poly_n, poly_sigma: radius and sigma of the expansion's
        applicability.

    Returns:
      (N, 5, lh, lw) float32 planes (bx, by, cxx, cyy, cxy): the
      reflect-101 pre-blur of the frame, its bilinear resize (rows, then
      columns) where scale < 1, and the polynomial expansion with
      replicate border.
    """
    if not frames.is_cuda:
        return fb_prologue_plain(frames, scale, out_hw, poly_n, poly_sigma)
    N, H, W = frames.shape
    lh, lw = out_hw
    dev = frames.device
    _build.expect(frames, "frames", (N, H, W), dev)
    btaps = _smooth_taps(scale)
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_setup(poly_n, poly_sigma)
    if len(btaps) > MAX_TAPS or len(g) > MAX_TAPS:
        raise ValueError(f"fb_prologue takes at most {MAX_TAPS} taps, got "
                         f"{len(btaps)} (blur) and {len(g)} (expansion)")
    if len(btaps) // 2 >= min(H, W):
        raise ValueError(f"fb_prologue: blur radius {len(btaps) // 2} needs "
                         f"a larger frame than {(H, W)}")
    resized = scale < 1.0
    if not resized and (lh, lw) != (H, W):
        raise ValueError(f"fb_prologue: scale {scale} keeps the size, but "
                         f"out_hw {out_hw} != {(H, W)}")
    # An axis whose size does not change is not resampled (as the plain
    # resize skips it): a null tap table.
    ytab = _resize_taps(H, lh, dev) if resized and lh != H else None
    xtab = _resize_taps(W, lw, dev) if resized and lw != W else None
    out = torch.empty((N, 5, lh, lw), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check(lib.va_fb_prologue(
        frames.data_ptr(), out.data_ptr(), N, H, W, lh, lw,
        _c_floats(btaps), len(btaps),
        None if ytab is None else ytab[0].data_ptr(),
        None if ytab is None else ytab[1].data_ptr(),
        None if xtab is None else xtab[0].data_ptr(),
        None if xtab is None else xtab[1].data_ptr(),
        _c_floats(g), _c_floats(xg), _c_floats(xxg), len(g),
        ig11, ig03, ig33, ig55, _stream(frames)), "fb_prologue")
    fb_prologue.launches += 1
    return out


fb_prologue.launches = 0


# -- K-E: warp + normal equations -------------------------------------------

def fb_warp_neq_plain(R0: torch.Tensor, R1: torch.Tensor,
                      flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fb_warp_neq``: ``update_matrices``
    (``flow/farneback.py``)."""
    return update_matrices(R0, R1, flow)


def fb_warp_neq(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor
                ) -> torch.Tensor:
    """Warp the second frame's expansion by the flow and form the
    per-pixel normal equations.

    Args:
      R0, R1: (B, 5, h, w) float32 expansions of the pair's frames.
      flow: (B, 2, h, w) float32 current flow (dx, dy).

    Returns:
      (B, 5, h, w) float32 planes (g11, g12, g22, h1, h2), border
      attenuation applied.
    """
    if not flow.is_cuda:
        return fb_warp_neq_plain(R0, R1, flow)
    B, _, h, w = flow.shape
    if h < 2 or w < 2:
        raise ValueError(f"fb_warp_neq needs h, w >= 2, got {(h, w)}")
    dev = flow.device
    _build.expect(flow, "flow", (B, 2, h, w), dev)
    _build.expect(R0, "R0", (B, 5, h, w), dev)
    _build.expect(R1, "R1", (B, 5, h, w), dev)
    M = torch.empty((B, 5, h, w), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check(lib.va_fb_warp_neq(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), M.data_ptr(),
        B, h, w, _c_floats(_BORDER_WEIGHTS), _stream(flow)), "fb_warp_neq")
    fb_warp_neq.launches += 1
    return M


fb_warp_neq.launches = 0


# -- K-F: 1-D correlation, optional 2×2 solve --------------------------------

def sep_corr_plain(x: torch.Tensor, taps: Sequence[float], axis: int,
                   solve: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``sep_corr``: the replicate pad and
    ``_conv1d`` of ``ops/kernels.py``, then ``_solve_flow``."""
    B, C, h, w = x.shape
    k = np.asarray(taps, np.float32)
    dim = 1 + axis
    xp = pad_border(x.reshape(B * C, h, w), len(k) // 2, dims=(dim,))
    y = _conv1d(xp, k, dim).reshape(B, C, h, w)
    return _solve_flow(y) if solve else y


def sep_corr(x: torch.Tensor, taps: Sequence[float], axis: int,
             solve: bool = False) -> torch.Tensor:
    """1-D correlation of every plane of x along one axis, replicate
    border, summed tap by tap in the taps' order.

    Args:
      x: (B, C, h, w) float32.
      taps: odd number of taps, at most 31.
      axis: 0 correlates along y (vertical), 1 along x (horizontal).
      solve: for C = 5, turn the five averaged normal-equation planes of
        each pixel into the flow (``_solve_flow``) before writing.

    Returns:
      (B, C, h, w), or (B, 2, h, w) flow with ``solve``.
    """
    if not x.is_cuda:
        return sep_corr_plain(x, taps, axis, solve)
    B, C, h, w = x.shape
    if axis not in (0, 1):
        raise ValueError(f"sep_corr: axis must be 0 or 1, got {axis}")
    if len(taps) % 2 != 1 or len(taps) > MAX_TAPS:
        raise ValueError(f"sep_corr takes an odd number of taps <= "
                         f"{MAX_TAPS}, got {len(taps)}")
    if solve and C != 5:
        raise ValueError(f"sep_corr: the solve epilogue needs C = 5, got {C}")
    _build.expect(x, "x", (B, C, h, w), x.device)
    out = torch.empty((B, 2 if solve else C, h, w), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    _build.check(lib.va_sep_corr(
        x.data_ptr(), out.data_ptr(), B, C, h, w, _c_floats(taps), len(taps),
        axis, int(solve), _stream(x)), "sep_corr")
    sep_corr.launches += 1
    if solve:
        sep_corr.launches_solve += 1
    return out


# Every launch, and of those the launches of the other instantiation of
# the kernel, the five-plane one with the solve epilogue.
sep_corr.launches = 0
sep_corr.launches_solve = 0


# -- fb_window_solve: both window passes and the solve in one launch --------

def _expect_taps(taps: Sequence[float], what: str) -> None:
    if len(taps) % 2 != 1 or len(taps) > MAX_TAPS:
        raise ValueError(f"{what} takes an odd number of taps <= "
                         f"{MAX_TAPS}, got {len(taps)}")


def fb_window_solve_plain(M: torch.Tensor, taps: Sequence[float]
                          ) -> torch.Tensor:
    """Plain PyTorch version of ``fb_window_solve``: ``sep_corr_plain``
    along y, then along x with the solve."""
    return sep_corr_plain(sep_corr_plain(M, taps, 0), taps, 1, solve=True)


def fb_window_solve(M: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """The window average of the five normal-equation planes along y and
    along x (replicate border, each sum tap by tap in the taps' order) and
    the regularised 2×2 solve of every pixel, in one launch: what
    ``sep_corr`` computes in two, to the bit.

    Args:
      M: (B, 5, h, w) float32 planes (g11, g12, g22, h1, h2).
      taps: odd number of taps, at most 31, applied along both axes.

    Returns:
      (B, 2, h, w) float32 flow.
    """
    if not M.is_cuda:
        return fb_window_solve_plain(M, taps)
    B, _, h, w = M.shape
    _expect_taps(taps, "fb_window_solve")
    _build.expect(M, "M", (B, 5, h, w), M.device)
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=M.device)
    lib = _build.library()
    _build.check(lib.va_fb_window_solve(
        M.data_ptr(), out.data_ptr(), B, h, w, _c_floats(taps), len(taps),
        _stream(M)), "fb_window_solve")
    fb_window_solve.launches += 1
    return out


fb_window_solve.launches = 0


def fb_iteration_plain(R0: torch.Tensor, R1: torch.Tensor,
                       flow: torch.Tensor, taps: Sequence[float]
                       ) -> torch.Tensor:
    """Plain PyTorch version of ``fb_iteration``: ``fb_warp_neq_plain``,
    then ``fb_window_solve_plain``."""
    return fb_window_solve_plain(fb_warp_neq_plain(R0, R1, flow), taps)


def fb_iteration(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                 taps: Sequence[float]) -> torch.Tensor:
    """One whole Farneback iteration in one launch: ``fb_warp_neq`` as
    the tile loader of ``fb_window_solve`` (the normal equations are
    formed anew for a tile's halo and never reach device memory).

    Args:
      R0, R1: (B, 5, h, w) float32 expansions of the pair's frames.
      flow: (B, 2, h, w) float32 current flow; not modified.
      taps: odd number of window taps, at most 31.

    Returns:
      (B, 2, h, w) float32 new flow.
    """
    if not flow.is_cuda:
        return fb_iteration_plain(R0, R1, flow, taps)
    B, _, h, w = flow.shape
    if h < 2 or w < 2:
        raise ValueError(f"fb_iteration needs h, w >= 2, got {(h, w)}")
    _expect_taps(taps, "fb_iteration")
    dev = flow.device
    _build.expect(flow, "flow", (B, 2, h, w), dev)
    _build.expect(R0, "R0", (B, 5, h, w), dev)
    _build.expect(R1, "R1", (B, 5, h, w), dev)
    out = torch.empty_like(flow)
    lib = _build.library()
    _build.check(lib.va_fb_iteration(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), out.data_ptr(), B, h,
        w, _c_floats(_BORDER_WEIGHTS), _c_floats(taps), len(taps),
        _stream(flow)), "fb_iteration")
    fb_iteration.launches += 1
    return out


fb_iteration.launches = 0

