"""Plain TV-L1 optical flow (Zach, Pock, Bischof 2007, in the
IPOL reference's iteration structure), with OpenCV's
``DualTVL1OpticalFlow`` parameters: the benchmark's frozen reference.

Per scale, coarse to fine: the centred gradient of I1, then ``warps``
times: warp I1 and its gradient by the flow, form the linearised
residual, and run up to ``outer_iterations`` rounds of (a k×k median of
the flow, then ``inner_iterations`` primal-dual steps), each image
stopping on its own ε test (the mean squared update of a round's last
step under ε²); a k×k median closes the scale, and the flow is upscaled
by 1/scale_step.  The dual variables restart at zero each warp.

Only the whole-plane solver is here: a level above the ``whole_plane``
size rule (about 295² with the 5×5 median) is solved in row bands that
stop on their own, a different function, and ``tvl1`` refuses it.

``tvl1(..., rounds=list)`` appends one ``LevelRounds`` per level,
coarsest first, with the (B, warps) rounds each image ran.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from bench_h100.reference import ops

MIN_SIZE = 16          # the coarsest level keeps both sides >= this
ZOOM_SIGMA0 = 0.6      # IPOL's pre-smoothing constant of a downscale
GRAD_EPS = 1e-10       # guard of the threshold step's division


class LevelRounds(NamedTuple):
    hw: Tuple[int, int]
    solver: str
    band: int
    rounds: torch.Tensor         # (B, warps) int32


def level_sizes(h: int, w: int, cfg: dict) -> List[Tuple[int, int]]:
    """Finest-first level sizes, stopping before a side falls under 16."""
    sizes = [(h, w)]
    for s in range(1, cfg["nscales"]):
        f = cfg["scale_step"] ** s
        lh, lw = int(round(h * f)), int(round(w * f))
        if min(lh, lw) < MIN_SIZE:
            break
        sizes.append((lh, lw))
    return sizes


def whole_plane(h: int, w: int, k: int) -> bool:
    """The working-set rule under which a level is solved as one plane:
    (12 + k² + 2)·h·w floats under 13 MiB with a k×k median."""
    planes = 12 + (k * k + 2 if k > 1 else 0)
    return planes * h * w * 4 < 13 * 1024 * 1024


def downscale(img: torch.Tensor, out_hw: Tuple[int, int], zoom: float
              ) -> torch.Tensor:
    sigma = ZOOM_SIGMA0 * math.sqrt(1.0 / zoom ** 2 - 1.0)
    g = ops.gaussian_taps(sigma)
    return ops.resize(ops.separable(img, g, g, "reflect"), out_hw)


def warp_prep(i13: torch.Tensor, i0: torch.Tensor, uv: torch.Tensor
              ) -> torch.Tensor:
    """(I1wx, I1wy, |∇I1w|², I1w − I1wx·u − I1wy·v − I0) of the warp."""
    B, _, H, W = i13.shape
    u0, v0 = uv[:, 0], uv[:, 1]
    yy = torch.arange(H, dtype=torch.float32, device=uv.device)
    xx = torch.arange(W, dtype=torch.float32, device=uv.device)
    w = ops.bilinear_sample(i13.permute(0, 2, 3, 1), yy[:, None] + v0,
                            xx[None, :] + u0)
    I1w, I1wx, I1wy = w[..., 0], w[..., 1], w[..., 2]
    grad = I1wx * I1wx + I1wy * I1wy
    rho_c = I1w - I1wx * u0 - I1wy * v0 - i0
    return torch.stack([I1wx, I1wy, grad, rho_c], dim=1).to(i13.dtype)


def pd_step(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
            cfg: dict, with_err: bool):
    """One primal-dual step of every image: (uv, p, err), err the (B,)
    mean squared update when `with_err`."""
    l_t = cfg["lambda"] * cfg["theta"]
    theta = cfg["theta"]
    taut = cfg["tau"] / cfg["theta"]
    I1wx, I1wy, grad, rho_c = prep.unbind(1)
    u, v = uv[:, 0], uv[:, 1]
    p11, p12, p21, p22 = p.unbind(1)
    th = l_t * grad
    inv_grad = 1.0 / torch.clamp(grad, min=GRAD_EPS)
    rho = rho_c + I1wx * u + I1wy * v
    d = torch.where(rho < -th, l_t,
                    torch.where(rho > th, -l_t, -rho * inv_grad))
    un = u + d * I1wx + theta * ops.divergence(p11, p12)
    vn = v + d * I1wy + theta * ops.divergence(p21, p22)
    err = None
    if with_err:
        sq = (un - u) ** 2 + (vn - v) ** 2
        err = sq.sum(dim=(1, 2)) / (uv.shape[2] * uv.shape[3])
    ux, uy = ops.forward_gradient(un)
    vx, vy = ops.forward_gradient(vn)
    inv_u = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
    inv_v = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
    p = torch.stack([(p11 + taut * ux) * inv_u, (p12 + taut * uy) * inv_u,
                     (p21 + taut * vx) * inv_v, (p22 + taut * vy) * inv_v],
                    dim=1)
    return torch.stack([un, vn], dim=1), p, err


def solve_warp(prep: torch.Tensor, uv: torch.Tensor, cfg: dict
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One warp's rounds; returns (uv, rounds each image ran)."""
    B, _, H, W = uv.shape
    active = torch.ones(B, dtype=torch.bool, device=uv.device)
    ran = torch.zeros(B, dtype=torch.int32, device=uv.device)
    p = torch.zeros((B, 4, H, W), dtype=uv.dtype, device=uv.device)
    eps2 = cfg["epsilon"] * cfg["epsilon"]
    k = cfg["median_filtering"]
    for _ in range(cfg["outer_iterations"]):
        if not bool(active.any()):
            break
        ran += active.to(torch.int32)
        keep = active.view(B, 1, 1, 1)
        if k > 1:
            uv = torch.where(keep, ops.median(uv, k), uv)
        new_uv, new_p = uv, p
        for i in range(cfg["inner_iterations"]):
            new_uv, new_p, err = pd_step(
                prep, new_uv, new_p, cfg,
                with_err=i == cfg["inner_iterations"] - 1)
        uv = torch.where(keep, new_uv, uv)
        p = torch.where(keep, new_p, p)
        active = active & ~(err < eps2)
    return uv, ran


def tvl1(prev: torch.Tensor, nxt: torch.Tensor, cfg: dict,
         rounds: Optional[list] = None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W) gray pairs in [0, 255] → (B, H, W, 2) flow (dx, dy) with
    prev(p) ≈ next(p + flow(p)).  `cfg` holds OpenCV's parameter names
    (``tau``, ``lambda``, ``theta``, ``nscales``, ``warps``, ``epsilon``,
    ``inner_iterations``, ``outer_iterations``, ``scale_step``,
    ``median_filtering``).  Images and state are held and computed in
    `dtype` (bfloat16 for the flow control), sample coordinates in
    float32."""
    I0s = [prev.to(dtype).contiguous()]
    I1s = [nxt.to(dtype).contiguous()]
    B, H, W = I0s[0].shape
    sizes = level_sizes(H, W, cfg)
    k = cfg["median_filtering"]
    for lh, lw in sizes:
        if not whole_plane(lh, lw, k):
            raise ValueError(f"a {lh}x{lw} level is solved in bands, "
                             f"which this reference does not cover")
    for s in range(1, len(sizes)):
        I0s.append(downscale(I0s[-1], sizes[s], cfg["scale_step"]))
        I1s.append(downscale(I1s[-1], sizes[s], cfg["scale_step"]))
    uv = None
    for s in range(len(sizes) - 1, -1, -1):
        lh, lw = sizes[s]
        I0, I1 = I0s[s].contiguous(), I1s[s]
        if uv is None:
            uv = torch.zeros((B, 2, lh, lw), dtype=dtype, device=I0.device)
        else:
            up = ops.resize(uv.reshape(B * 2, *uv.shape[2:]), (lh, lw))
            uv = (up * (1.0 / cfg["scale_step"])).reshape(B, 2, lh, lw)
        I1x, I1y = ops.centred_gradient(I1)
        i13 = torch.stack([I1, I1x, I1y], dim=1).contiguous()
        ran = []
        for _ in range(cfg["warps"]):
            uv, r = solve_warp(warp_prep(i13, I0, uv), uv, cfg)
            ran.append(r)
        if k > 1:
            uv = ops.median(uv, k)
        if rounds is not None:
            rounds.append(LevelRounds((lh, lw), "warp", 0,
                                      torch.stack(ran, dim=1)))
    return uv.permute(0, 2, 3, 1)
