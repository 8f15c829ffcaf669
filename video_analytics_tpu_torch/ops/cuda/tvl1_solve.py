"""K-B and K-C: the TV-L1 primal-dual solver of one warp and its median.

Replaces the solver of ``video_analytics_tpu/ops/pallas/tvl1_solve.py``
(``tvl1_solve_warp``, ``tvl1_solve_warp_packed`` and the solver half of
``tvl1_scale_pallas``) and its in-kernel k×k median.  The kernels are
``csrc/tvl1_pd.cu`` (``pd_step``, one primal-dual iteration over the
batch, and ``eps_reduce``, the per-image convergence test) and
``csrc/median.cu`` (``median5``); their source notes give the design and
what bounds each on the H100.

``pd_solve`` drives one warp: ``outer_iterations`` rounds, each a median
of the images still active, ``inner_iterations`` primal-dual steps with
the dual variables reset to zero at the warp's start, and the ε test.
Each image stops on its own test, as the Pallas solvers do; the reference
XLA solver instead runs until the slowest image of the batch converges
(ROADMAP F1).  The CUDA path keeps the per-image flags on the device and
launches every round without reading them back, so the host never waits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.ops.kernels import divergence, forward_gradient
from video_analytics_tpu_torch.ops.median import median_filter2d

_GRAD_EPS = 1e-10      # guard for the v-step division


def _solver_constants(cfg: TVL1Config) -> Tuple[float, float, float]:
    """(l_t, theta, taut) = (λθ, θ, τ/θ), as the reference forms them."""
    return cfg.lambda_ * cfg.theta, cfg.theta, cfg.tau / cfg.theta


def _expect_active(active: torch.Tensor, B: int, device) -> None:
    if (active.dtype != torch.int32 or tuple(active.shape) != (B,)
            or active.device != device or not active.is_contiguous()):
        raise ValueError(f"active: expected a contiguous ({B},) int32 tensor "
                         f"on {device}, got {tuple(active.shape)} "
                         f"{active.dtype} on {active.device}")


# -- K-C: median ------------------------------------------------------------

def median5_plain(x: torch.Tensor, k: int,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``median5``."""
    B, C, H, W = x.shape
    out = median_filter2d(x.reshape(B * C, H, W), k).reshape(B, C, H, W)
    if active is None:
        return out
    return torch.where(active.bool().view(B, 1, 1, 1), out, x)


def median5(x: torch.Tensor, k: int, active: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k×k median (k = 3 or 5, replicate border) of each (H, W) plane of
    x: (B, C, H, W) float32.  With ``active`` ((B,) int32), images whose
    flag is 0 pass through unchanged.  ``out``, if given, receives the
    result and must not alias x."""
    if not x.is_cuda:
        return median5_plain(x, k, active)
    if k not in (3, 5):
        raise ValueError(f"median5 takes k = 3 or 5, got {k}")
    B, C, H, W = x.shape
    _build.expect(x, "x", (B, C, H, W), x.device)
    if out is None:
        out = torch.empty_like(x)
    _build.expect(out, "out", (B, C, H, W), x.device)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("median5: out must not alias x")
    if active is not None:
        _expect_active(active, B, x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.va_median(
        x.data_ptr(), out.data_ptr(), B * C, C, H, W, k,
        None if active is None else active.data_ptr(), stream), "median5")
    median5.launches += 1
    return out


median5.launches = 0


# -- K-B: one primal-dual iteration -----------------------------------------

def pd_step_plain(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
                  cfg: TVL1Config, with_err: bool = False):
    """Plain PyTorch version of one ``pd_step`` on every image: the body
    of the reference's ``_solve_warp`` loop (``flow/tvl1.py:149-181``).
    Returns (uv, p, err) with err the (B,) mean squared update, or None
    unless ``with_err``."""
    l_t, theta, taut = _solver_constants(cfg)
    I1wx, I1wy, grad, rho_c = prep.unbind(1)
    u, v = uv[:, 0], uv[:, 1]
    p11, p12, p21, p22 = p.unbind(1)
    th = l_t * grad
    inv_grad = 1.0 / torch.clamp(grad, min=_GRAD_EPS)
    rho = rho_c + I1wx * u + I1wy * v
    d = torch.where(rho < -th, l_t,
                    torch.where(rho > th, -l_t, -rho * inv_grad))
    v1 = u + d * I1wx
    v2 = v + d * I1wy
    un = v1 + theta * divergence(p11, p12)
    vn = v2 + theta * divergence(p21, p22)
    err = None
    if with_err:
        n_px = u.shape[1] * u.shape[2]
        err = ((un - u) ** 2 + (vn - v) ** 2).sum(dim=(1, 2)) / n_px
    ux, uy = forward_gradient(un)
    vx, vy = forward_gradient(vn)
    inv_u = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
    inv_v = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
    p = torch.stack([(p11 + taut * ux) * inv_u, (p12 + taut * uy) * inv_u,
                     (p21 + taut * vx) * inv_v, (p22 + taut * vy) * inv_v],
                    dim=1)
    return torch.stack([un, vn], dim=1), p, err


def pd_blocks(H: int, W: int) -> int:
    """Thread blocks per image of ``pd_step`` (32×8 tiles, TX × TY of
    csrc/common.cuh): the row length of its ``partial`` sums."""
    return math.ceil(W / 32) * math.ceil(H / 8)


def pd_step(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
            active: torch.Tensor, cfg: TVL1Config, uv_out: torch.Tensor,
            p_out: torch.Tensor, partial: Optional[torch.Tensor] = None
            ) -> None:
    """One primal-dual iteration of every active image, on CUDA tensors.

    prep (B, 4, H, W) from ``warp_prep``; uv (B, 2, H, W) and the dual
    variables p (B, 4, H, W) are read, and the new values written to the
    distinct buffers uv_out and p_out (frozen images copy uv forward and
    leave p_out stale: the solver never reads it again in this warp).
    With ``partial`` ((B, pd_blocks(H, W)) float32), each block's sum of
    squared updates is written there for ``eps_reduce``."""
    B, _, H, W = uv.shape
    dev = uv.device
    if not uv.is_cuda:
        raise ValueError("pd_step launches a CUDA kernel: pass CUDA tensors "
                         "(pd_step_plain is the CPU version)")
    for t, name, c in ((prep, "prep", 4), (uv, "uv", 2), (p, "p", 4),
                       (uv_out, "uv_out", 2), (p_out, "p_out", 4)):
        _build.expect(t, name, (B, c, H, W), dev)
    if uv_out.data_ptr() == uv.data_ptr() or p_out.data_ptr() == p.data_ptr():
        raise ValueError("pd_step: outputs must not alias inputs")
    _expect_active(active, B, dev)
    if partial is not None:
        _build.expect(partial, "partial", (B, pd_blocks(H, W)), dev)
    l_t, theta, taut = _solver_constants(cfg)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.va_pd_step(
        prep.data_ptr(), uv.data_ptr(), p.data_ptr(), uv_out.data_ptr(),
        p_out.data_ptr(), active.data_ptr(),
        None if partial is None else partial.data_ptr(),
        B, H, W, l_t, theta, taut, stream), "pd_step")
    pd_step.launches += 1


pd_step.launches = 0


# -- the ε test ---------------------------------------------------------------

def eps_reduce_plain(partial: torch.Tensor, active: torch.Tensor,
                     err: torch.Tensor, n_px: int, epsilon: float) -> None:
    """Plain PyTorch version of ``eps_reduce`` (in place)."""
    on = active.bool()
    e = partial.sum(dim=1) / n_px
    err.copy_(torch.where(on, e, err))
    active.copy_((on & ~(e < epsilon * epsilon)).to(active.dtype))


def eps_reduce(partial: torch.Tensor, active: torch.Tensor,
               err: torch.Tensor, n_px: int, epsilon: float) -> None:
    """Per-image convergence test, in place: for each image still active,
    err[b] = Σ partial[b] / n_px (summed in a fixed order) and its flag is
    cleared when err[b] < ε²."""
    if not partial.is_cuda:
        return eps_reduce_plain(partial, active, err, n_px, epsilon)
    B, n_part = partial.shape
    _build.expect(partial, "partial", (B, n_part), partial.device)
    _build.expect(err, "err", (B,), partial.device)
    _expect_active(active, B, partial.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(partial.device).cuda_stream
    _build.check(lib.va_eps_reduce(
        partial.data_ptr(), active.data_ptr(), err.data_ptr(), B, n_part,
        float(n_px), epsilon * epsilon, stream), "eps_reduce")
    eps_reduce.launches += 1


eps_reduce.launches = 0


# -- one warp ---------------------------------------------------------------

def pd_solve_plain(prep: torch.Tensor, uv: torch.Tensor, cfg: TVL1Config
                   ) -> torch.Tensor:
    """Plain PyTorch version of ``pd_solve``: the reference's
    ``_solve_warp`` with the per-image gate of the Pallas solvers.  Reads
    the flags on the host each round and stops once all are clear."""
    B, _, H, W = uv.shape
    active = torch.ones(B, dtype=torch.bool, device=uv.device)
    p = torch.zeros((B, 4, H, W), dtype=torch.float32, device=uv.device)
    eps2 = cfg.epsilon * cfg.epsilon
    for _ in range(cfg.outer_iterations):
        if not bool(active.any()):
            break
        keep = active.view(B, 1, 1, 1)
        if cfg.median_filtering > 1:
            uv = torch.where(keep, median5_plain(uv, cfg.median_filtering),
                             uv)
        new_uv, new_p = uv, p
        for i in range(cfg.inner_iterations):
            last = i == cfg.inner_iterations - 1
            new_uv, new_p, err = pd_step_plain(prep, new_uv, new_p, cfg,
                                               with_err=last)
        uv = torch.where(keep, new_uv, uv)
        p = torch.where(keep, new_p, p)
        active = active & ~(err < eps2)
    return uv


def pd_solve(prep: torch.Tensor, uv: torch.Tensor, cfg: TVL1Config
             ) -> torch.Tensor:
    """All primal-dual iterations of one TV-L1 warp.

    Args:
      prep: (B, 4, H, W) from ``warp_prep`` (I1wx, I1wy, grad, rho_c).
      uv: (B, 2, H, W) flow at the warp's start; not modified.
      cfg: the TVL1Config (λ, θ, τ, ε, iteration counts, median size).

    Returns:
      (B, 2, H, W) float32 flow after the warp.
    """
    if not uv.is_cuda:
        return pd_solve_plain(prep, uv, cfg)
    B, _, H, W = uv.shape
    dev = uv.device
    active = torch.ones(B, dtype=torch.int32, device=dev)
    err = torch.full((B,), math.inf, dtype=torch.float32, device=dev)
    partial = torch.empty((B, pd_blocks(H, W)), dtype=torch.float32,
                          device=dev)
    p = torch.zeros((B, 4, H, W), dtype=torch.float32, device=dev)
    p_next = torch.empty_like(p)
    bufs = (torch.empty_like(uv), torch.empty_like(uv))
    cur, turn = uv, 0
    for _ in range(cfg.outer_iterations):
        if cfg.median_filtering > 1:
            cur = median5(cur, cfg.median_filtering, active, out=bufs[turn])
            turn ^= 1
        for i in range(cfg.inner_iterations):
            last = i == cfg.inner_iterations - 1
            pd_step(prep, cur, p, active, cfg, bufs[turn], p_next,
                    partial if last else None)
            cur, turn = bufs[turn], turn ^ 1
            p, p_next = p_next, p
        eps_reduce(partial, active, err, H * W, cfg.epsilon)
    return cur
