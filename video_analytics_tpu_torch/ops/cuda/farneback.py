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

``fb_iterate`` is one iteration of the pyramid loop: the size rule
``window_route`` picks one of three compositions of these kernels by the
window's length, as ``prologue_form`` picks K-D's one or two launches by
the level's; neither rule ever picks a plain version.

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

_BLOCK_SMEM = 232448   # bytes of shared memory a block may opt in to
_TILE = 32             # level tile side of fb_prologue_kernel (csrc)


def _c_floats(values: Sequence[float]):
    """A C float array of the taps, each rounded to float32 once."""
    return (ctypes.c_float * len(values))(*[float(v) for v in values])


@functools.lru_cache(maxsize=64)
def _device_floats(values: Tuple[float, ...], device: torch.device
                   ) -> torch.Tensor:
    """The taps as a float32 tensor on `device`: the kernels copy taps of
    any length from there into shared memory."""
    return torch.tensor(values, dtype=torch.float32, device=device)


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
def _resize_index(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two taps of each output of the linear resize along one axis, as
    (2, n_out) int32 indices and float32 weights.  A tap of weight 0 reads
    the first tap's index: its term is +0 wherever it reads (frames are
    gray levels >= 0), and the kernel's tile then spans only the columns
    the level really reads."""
    i0, i1, w0, w1 = _two_tap(n_in, n_out, torch.device("cpu"))
    idx = np.stack([i0.numpy(), i1.numpy()]).astype(np.int32)
    wt = np.stack([w0.numpy(), w1.numpy()])
    idx = np.where(wt == 0, idx[:1], idx).astype(np.int32)
    # The kernel takes a tile's reach from its first and last sample: both
    # taps rise with the output, the second never below the first.
    if (np.diff(idx, axis=1) < 0).any() or (idx[1] < idx[0]).any():
        raise ValueError(f"fb_prologue: a {n_in} -> {n_out} resize whose "
                         f"taps are not monotone")
    return idx, wt


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in: int, n_out: int, device: torch.device):
    """``_resize_index`` as one (2, n_out) int32 and one (2, n_out)
    float32 tensor on `device`."""
    idx, wt = _resize_index(n_in, n_out)
    return (torch.from_numpy(idx).to(device).contiguous(),
            torch.from_numpy(wt).to(device).contiguous())


def prologue_span(W: int, lw: int, n_blur: int, n_poly: int,
                  resized: bool) -> int:
    """Source columns the widest 32-wide level tile of ``fb_prologue``
    reaches: the columns its tile and halo of ``n_poly // 2`` level pixels
    resample from (both taps of each), widened by the blur's radius and
    cut to the frame."""
    p, rb = n_poly // 2, n_blur // 2
    idx = _resize_index(W, lw)[0] if resized else None
    span = 0
    for x0 in range(0, lw, _TILE):
        gx = np.clip(np.arange(x0 - p, x0 + _TILE + p), 0, lw - 1)
        cols = idx[:, gx] if resized else gx
        span = max(span, min(W - 1, int(cols.max()) + rb)
                   - max(0, int(cols.min()) - rb) + 1)
    return span


def prologue_smem(n_blur: int, n_poly: int, y_resized: bool,
                  x_resized: bool, span: int) -> int:
    """Bytes of shared memory a block of the one-launch form takes
    (``va_fb_prologue_smem``): the taps, the tile's source indices, the
    blurred frame at its sample points, the level tile with its halo, the
    expansion's vertical sums (rows of a multiple of four floats), and
    the vertical blur over `span` columns at each sample row."""
    ry, rx = 1 + y_resized, 1 + x_resized
    lh = lw = _TILE + n_poly - 1
    sr, sc = lh * ry, lw * rx
    tile = (n_blur + 3 * n_poly + sr + sc + sr * sc + lh * lw
            + 3 * _TILE * ((lw + 3) & ~3))
    return 4 * (tile + sr * span)


@functools.lru_cache(maxsize=256)
def prologue_form(H: int, W: int, lh: int, lw: int, scale: float,
                  poly_n: int) -> Tuple[str, int]:
    """The size rule of ``fb_prologue``: ("fused", span) where the widest
    tile's buffers fit a block's shared memory, one launch that blurs,
    resizes and expands (every level down to 1/8 of a 1080p frame); else
    ("split", 0): a first launch writes the blurred frame at the level's
    sample points, a sample row a block, and the expansion reads them
    (1/16 of 1080p and below, where a tile reaches ~700 frame columns)."""
    resized = scale < 1.0
    y_res, x_res = resized and lh != H, resized and lw != W
    n_blur, n_poly = len(_smooth_taps(scale)), 2 * poly_n + 1
    span = prologue_span(W, lw, n_blur, n_poly, x_res)
    if prologue_smem(n_blur, n_poly, y_res, x_res, span) <= _BLOCK_SMEM:
        return "fused", span
    if 4 * (n_blur + W) > _BLOCK_SMEM:
        raise ValueError(f"fb_prologue: a row of {W} columns is more than a "
                         f"block's shared memory holds")
    return "split", 0


@functools.lru_cache(maxsize=64)
def _prologue_taps(scale: float, poly_n: int, poly_sigma: float,
                   device: torch.device) -> torch.Tensor:
    """The blur taps, then g, xg, xxg, as one float32 tensor on `device`."""
    g, xg, xxg = _poly_exp_setup(poly_n, poly_sigma)[:3]
    return torch.tensor(
        [float(t) for t in _smooth_taps(scale)]
        + [float(t) for k in (g, xg, xxg) for t in k],
        dtype=torch.float32, device=device)


def fb_prologue(frames: torch.Tensor, scale: float, out_hw: Tuple[int, int],
                poly_n: int, poly_sigma: float) -> torch.Tensor:
    """One pyramid level's per-frame work: one launch, or two where the
    level samples the frame too sparsely for a tile's reach to fit a
    block (``prologue_form``).

    Args:
      frames: (N, H, W) float32 gray frames at full resolution.
      scale: the level's scale (1 at the finest); picks the pre-blur
        taps (``_smooth_taps``, any number) and whether the level is
        resized.
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
    _build.expect_grid_batch(N, "fb_prologue")
    btaps = _smooth_taps(scale)
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_setup(poly_n, poly_sigma)
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
    form, size = prologue_form(H, W, lh, lw, scale, poly_n)
    taps = _prologue_taps(scale, poly_n, poly_sigma, dev)
    out = torch.empty((N, 5, lh, lw), dtype=torch.float32, device=dev)
    snd = None
    if form == "split":
        snd = torch.empty((N, (2 if ytab is not None else 1) * lh,
                           (2 if xtab is not None else 1) * lw),
                          dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check(lib.va_fb_prologue(
        frames.data_ptr(), out.data_ptr(),
        None if snd is None else snd.data_ptr(), N, H, W, lh, lw,
        taps.data_ptr(), len(btaps), len(g),
        None if ytab is None else ytab[0].data_ptr(),
        None if ytab is None else ytab[1].data_ptr(),
        None if xtab is None else xtab[0].data_ptr(),
        None if xtab is None else xtab[1].data_ptr(),
        ig11, ig03, ig33, ig55, size, _stream(frames)), "fb_prologue")
    fb_prologue.launches += 1
    if form == "split":
        fb_prologue.launches_blur += 1
    return out


# Every launch of the expansion kernel, one a level; and the launches of
# the blur pass that comes before it in the two-launch form.
fb_prologue.launches = 0
fb_prologue.launches_blur = 0


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
    _build.expect_grid_batch(B, "fb_warp_neq")
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


def _expect_taps(taps: Sequence[float], what: str, smem: int = 0) -> None:
    """Raise unless there is an odd number of taps and the launch's
    shared memory (`smem` bytes) fits a block."""
    if len(taps) % 2 != 1:
        raise ValueError(f"{what} takes an odd number of taps, got "
                         f"{len(taps)}")
    if smem > _BLOCK_SMEM:
        raise ValueError(f"{what}: {len(taps)} taps need {smem} B of shared "
                         f"memory, more than a block has; window_route "
                         f"names the kernels for them")


def _taps_on(taps: Sequence[float], device: torch.device) -> torch.Tensor:
    return _device_floats(tuple(float(t) for t in taps), device)


def sep_corr_smem(n: int, axis: int, planes: int) -> int:
    """Bytes of shared memory a block of ``sep_corr`` takes at most
    (``va_sep_corr_smem``), the same for every window length n and both
    axes: two stages of a chunk of taps (64 for one plane, 32 for the
    five of the solve) and the samples they reach along the axis for a
    block's 32 lanes and 8 × R outputs (R = 16, or 8 with five planes)."""
    chunk, R = (64, 16) if planes == 1 else (32, 8)
    span = 8 * R + chunk - 1
    return 4 * 2 * (planes * span * 32 + chunk)


def sep_corr(x: torch.Tensor, taps: Sequence[float], axis: int,
             solve: bool = False) -> torch.Tensor:
    """1-D correlation of every plane of x along one axis, replicate
    border, summed tap by tap in the taps' order.

    Args:
      x: (B, C, h, w) float32.
      taps: odd number of taps, any length: the kernel streams them
        through shared memory in chunks.
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
    _expect_taps(taps, "sep_corr",
                 sep_corr_smem(len(taps), axis, 5 if solve else 1))
    if solve and C != 5:
        raise ValueError(f"sep_corr: the solve epilogue needs C = 5, got {C}")
    _build.expect(x, "x", (B, C, h, w), x.device)
    _build.expect_grid_batch(B if solve else B * C, "sep_corr")
    out = torch.empty((B, 2 if solve else C, h, w), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    _build.check(lib.va_sep_corr(
        x.data_ptr(), out.data_ptr(), B, C, h, w,
        _taps_on(taps, x.device).data_ptr(), len(taps), axis, int(solve),
        _stream(x)), "sep_corr")
    sep_corr.launches += 1
    if solve:
        sep_corr.launches_solve += 1
    return out


# Every launch, and of those the launches of the other instantiation of
# the kernel, the five-plane one with the solve epilogue.
sep_corr.launches = 0
sep_corr.launches_solve = 0


# -- fb_window_solve: both window passes and the solve in one launch --------

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
      taps: odd number of taps, at most 193 (``window_route``), applied
        along both axes.

    Returns:
      (B, 2, h, w) float32 flow.
    """
    if not M.is_cuda:
        return fb_window_solve_plain(M, taps)
    B, _, h, w = M.shape
    _expect_taps(taps, "fb_window_solve", window_smem(len(taps), 1))
    _build.expect(M, "M", (B, 5, h, w), M.device)
    _build.expect_grid_batch(B, "fb_window_solve")
    out = torch.empty((B, 2, h, w), dtype=torch.float32, device=M.device)
    lib = _build.library()
    _build.check(lib.va_fb_window_solve(
        M.data_ptr(), out.data_ptr(), B, h, w, _c_floats(taps),
        _taps_on(taps, M.device).data_ptr(), len(taps), _stream(M)),
        "fb_window_solve")
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
      taps: odd number of window taps, at most 73 (``window_route``).

    Returns:
      (B, 2, h, w) float32 new flow.
    """
    if not flow.is_cuda:
        return fb_iteration_plain(R0, R1, flow, taps)
    B, _, h, w = flow.shape
    if h < 2 or w < 2:
        raise ValueError(f"fb_iteration needs h, w >= 2, got {(h, w)}")
    _expect_taps(taps, "fb_iteration", window_smem(len(taps), 5))
    dev = flow.device
    _build.expect(flow, "flow", (B, 2, h, w), dev)
    _build.expect(R0, "R0", (B, 5, h, w), dev)
    _build.expect(R1, "R1", (B, 5, h, w), dev)
    _build.expect_grid_batch(B, "fb_iteration")
    out = torch.empty_like(flow)
    lib = _build.library()
    _build.check(lib.va_fb_iteration(
        R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), out.data_ptr(), B, h,
        w, _c_floats(_BORDER_WEIGHTS), _c_floats(taps),
        _taps_on(taps, dev).data_ptr(), len(taps), _stream(flow)),
        "fb_iteration")
    fb_iteration.launches += 1
    return out


fb_iteration.launches = 0


# -- one iteration, by the window's length ------------------------------------

_WIN_TILE = 32         # output tile side of fb_window_solve_kernel (csrc)


def window_smem(n: int, planes: int) -> int:
    """Bytes of shared memory a block of ``fb_window_solve`` (planes = 1)
    or ``fb_iteration`` (planes = 5) takes for n taps
    (``va_fb_window_smem``): the pass along y's output, row length a
    multiple of four floats, the loaded tile(s) with their halo of n // 2,
    and the taps."""
    r = n // 2
    mid = (_WIN_TILE + 2 * r + 3) & ~3
    return 4 * (_WIN_TILE * mid + planes * (_WIN_TILE + 2 * r) ** 2 + n)


@functools.lru_cache(maxsize=64)
def window_route(n: int) -> str:
    """The size rule of a Farneback iteration on the card, by the window's
    n taps: "iteration" (``fb_iteration``, one launch) while its five
    tiles fit a block (n <= 73); else "window_solve" (``fb_warp_neq``,
    then ``fb_window_solve``) while its one tile does (n <= 193); else
    "sep_corr" (``fb_warp_neq``, then ``sep_corr`` along y and along x
    with the solve).  All three compute the same flow to the bit."""
    if window_smem(n, 5) <= _BLOCK_SMEM:
        return "iteration"
    if window_smem(n, 1) <= _BLOCK_SMEM:
        return "window_solve"
    return "sep_corr"


def fb_iterate(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
               taps: Sequence[float]) -> torch.Tensor:
    """One Farneback iteration through the kernels ``window_route`` names
    for the window (on CPU tensors, ``fb_iteration_plain``).  Same
    arguments and result as ``fb_iteration``."""
    if not flow.is_cuda:
        return fb_iteration_plain(R0, R1, flow, taps)
    route = window_route(len(taps))
    if route == "iteration":
        return fb_iteration(R0, R1, flow, taps)
    M = fb_warp_neq(R0, R1, flow)
    if route == "window_solve":
        return fb_window_solve(M, taps)
    return sep_corr(sep_corr(M, taps, 0), taps, 1, solve=True)
