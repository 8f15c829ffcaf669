"""K-B, K-C, K-G and K-H ``tvl1_scale``: the TV-L1 primal-dual solver of
one warp, its median, the chunked solver of large planes and the whole
pyramid scale in one launch with an image's state resident in a
thread-block cluster.

Replaces the solvers of ``video_analytics_tpu/ops/pallas/tvl1_solve.py``
(``tvl1_solve_warp``, ``tvl1_solve_warp_packed``, ``tvl1_scale_pallas``,
and ``tvl1_solve_warp_banded`` with its kernel ``_run_chunk``) and their
in-kernel k×k median.  The kernels are
``csrc/tvl1_pd.cu`` (``pd_step``, one primal-dual iteration over the
batch, which on a round's last step also runs the per-image convergence
test), ``csrc/median.cu`` (``median5``), ``csrc/tvl1_pd_chunk.cu``
(``pd_chunk``, several iterations per launch on shared-memory tiles, whose
last launch of a round also runs the bands' convergence test) and
``csrc/tvl1_pd_warp.cu`` (``pd_solve_scale``, every warp of a scale in one
launch with an image's state resident in the shared memory of a
thread-block cluster); their source notes give the design and what bounds
each on the H100.

``pd_solve`` drives one warp: ``outer_iterations`` rounds, each a median
of the images still active and ``inner_iterations`` primal-dual steps
with the dual variables reset to zero at the warp's start, the last of
which carries the ε test.
Each image stops on its own test, as the Pallas solvers do; the reference
XLA solver instead runs until the slowest image of the batch converges
(ROADMAP F1).  The CUDA path keeps the per-image flags on the device and
launches every round without reading them back, so the host never waits.

``pd_solve_scale`` runs all the warps of a level whose state fits a
cluster's shared memory (``warp_geometry``) in one launch: each warp
opens with K-A's warp and prep as the kernel's prologue and then computes
what ``pd_solve`` computes, and the scale-end median closes the launch;
``flow/tvl1.py`` takes it wherever the level fits.  Its clusters are
sized for the batch (``scale_blocks``).

``pd_solve_chunked`` drives one warp of a plane too large for either
(``flow/tvl1.py`` sends it every level the reference sends to its banded
solver): each round is ``ceil(K / chunk)`` launches of ``pd_chunk``, the
first of which opens with the median and the last of which ends with the
bands' test: rows are gated in bands on their own ε test, as in the
reference.

Every solver and its plain version take an optional ``rounds`` tensor that
receives the outer rounds each image (for ``pd_solve_chunked``, each band
of each image) ran, the work its ε test let through; the count changes no
result.  ``flow/tvl1.tvl1`` passes one while ``tvl1.rounds`` holds a list.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch

from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep_plain
from video_analytics_tpu_torch.ops.kernels import divergence, forward_gradient
from video_analytics_tpu_torch.ops.median import median_filter2d

_GRAD_EPS = 1e-10      # guard for the v-step division


def _solver_constants(cfg: TVL1Config) -> Tuple[float, float, float]:
    """(l_t, theta, taut) = (λθ, θ, τ/θ), as the reference forms them."""
    return cfg.lambda_ * cfg.theta, cfg.theta, cfg.tau / cfg.theta


def _expect_active(active: torch.Tensor, B: int, device,
                   name: str = "active") -> None:
    if (active.dtype != torch.int32 or tuple(active.shape) != (B,)
            or active.device != device or not active.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous ({B},) int32 tensor "
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
    _build.expect_grid_batch(B * C, "median5")
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

def _pd_step_fields(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
                    cfg: TVL1Config, with_sq: bool):
    """One primal-dual iteration on every image: the body of the
    reference's ``_solve_warp`` loop (``flow/tvl1.py:149-181``).  Returns
    (uv, p, sq) with sq the (B, H, W) squared update (un-u)² + (vn-v)², or
    None unless ``with_sq``."""
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
    sq = (un - u) ** 2 + (vn - v) ** 2 if with_sq else None
    ux, uy = forward_gradient(un)
    vx, vy = forward_gradient(vn)
    inv_u = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
    inv_v = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
    p = torch.stack([(p11 + taut * ux) * inv_u, (p12 + taut * uy) * inv_u,
                     (p21 + taut * vx) * inv_v, (p22 + taut * vy) * inv_v],
                    dim=1)
    return torch.stack([un, vn], dim=1), p, sq


def pd_step_plain(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
                  cfg: TVL1Config, with_err: bool = False):
    """Plain PyTorch version of one ``pd_step`` on every image.  Returns
    (uv, p, err) with err the (B,) mean squared update, or None unless
    ``with_err``."""
    uv_new, p, sq = _pd_step_fields(prep, uv, p, cfg, with_err)
    err = None
    if with_err:
        err = sq.sum(dim=(1, 2)) / (uv.shape[2] * uv.shape[3])
    return uv_new, p, err


def pd_blocks(H: int, W: int) -> int:
    """Thread blocks per image of ``pd_step`` (32×8 tiles, TX × TY of
    csrc/common.cuh): the row length of its ``partial`` sums."""
    return math.ceil(W / 32) * math.ceil(H / 8)


def pd_step(prep: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
            active: torch.Tensor, cfg: TVL1Config, uv_out: torch.Tensor,
            p_out: torch.Tensor, partial: Optional[torch.Tensor] = None,
            count: Optional[torch.Tensor] = None,
            err: Optional[torch.Tensor] = None) -> None:
    """One primal-dual iteration of every active image, on CUDA tensors.

    prep (B, 4, H, W) from ``warp_prep``; uv (B, 2, H, W) and the dual
    variables p (B, 4, H, W) are read, and the new values written to the
    distinct buffers uv_out and p_out (frozen images copy uv forward and
    leave p_out stale: the solver never reads it again in this warp).
    With ``partial`` ((B, pd_blocks(H, W)) float32), each block's sum of
    squared updates is written there.  With ``count`` ((B,) int32, zero,
    left zero) and ``err`` ((B,) float32) as well, the launch ends with
    the ε test of ``eps_reduce_plain`` on those sums: err[b] of each active
    image becomes its mean squared update (summed in a fixed order) and
    active[b] is cleared where that is under ε²."""
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
    _build.expect_grid_batch(B, "pd_step")
    _expect_active(active, B, dev)
    if partial is not None:
        _build.expect(partial, "partial", (B, pd_blocks(H, W)), dev)
    test = count is not None or err is not None
    if test:
        if partial is None or count is None or err is None:
            raise ValueError("pd_step: the ε test takes partial, count and "
                             "err together")
        _expect_active(count, B, dev, "count")
        _build.expect(err, "err", (B,), dev)
        if count.data_ptr() == active.data_ptr():
            raise ValueError("pd_step: count must not alias active")
    l_t, theta, taut = _solver_constants(cfg)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.va_pd_step(
        prep.data_ptr(), uv.data_ptr(), p.data_ptr(), uv_out.data_ptr(),
        p_out.data_ptr(), active.data_ptr(),
        None if partial is None else partial.data_ptr(),
        count.data_ptr() if test else None, err.data_ptr() if test else None,
        B, H, W, l_t, theta, taut, cfg.epsilon * cfg.epsilon, stream),
        "pd_step")
    pd_step.launches += 1
    pd_step.launches_test += test


pd_step.launches = 0
pd_step.launches_test = 0      # of them, launches that ran the ε test


# -- the ε test ---------------------------------------------------------------

def eps_reduce_plain(partial: torch.Tensor, active: torch.Tensor,
                     err: torch.Tensor, n_px: int, epsilon: float) -> None:
    """Plain PyTorch version of the ε test that ``pd_step`` runs in a
    round's last launch (in place): for each image still active, err[b] =
    Σ partial[b] / n_px and its flag is cleared when err[b] < ε²."""
    on = active.bool()
    e = partial.sum(dim=1) / n_px
    err.copy_(torch.where(on, e, err))
    active.copy_((on & ~(e < epsilon * epsilon)).to(active.dtype))


# -- one warp ---------------------------------------------------------------

def pd_solve_plain(prep: torch.Tensor, uv: torch.Tensor, cfg: TVL1Config,
                   rounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``pd_solve``: the reference's
    ``_solve_warp`` with the per-image gate of the Pallas solvers.  Reads
    the flags on the host each round and stops once all are clear.
    `rounds`, a (B,) tensor, receives the rounds each image ran."""
    B, _, H, W = uv.shape
    active = torch.ones(B, dtype=torch.bool, device=uv.device)
    ran = torch.zeros(B, dtype=torch.int32, device=uv.device)
    p = torch.zeros((B, 4, H, W), dtype=torch.float32, device=uv.device)
    eps2 = cfg.epsilon * cfg.epsilon
    for _ in range(cfg.outer_iterations):
        if not bool(active.any()):
            break
        ran += active.to(torch.int32)
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
    if rounds is not None:
        rounds.copy_(ran)
    return uv


def pd_solve(prep: torch.Tensor, uv: torch.Tensor, cfg: TVL1Config,
             rounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All primal-dual iterations of one TV-L1 warp.

    Args:
      prep: (B, 4, H, W) from ``warp_prep`` (I1wx, I1wy, grad, rho_c).
      uv: (B, 2, H, W) flow at the warp's start; not modified.
      cfg: the TVL1Config (λ, θ, τ, ε, iteration counts, median size).
      rounds: optional (B,) int32 tensor that receives the outer rounds
        each image ran (summed from the flags on the device).

    Returns:
      (B, 2, H, W) float32 flow after the warp.
    """
    if not uv.is_cuda:
        return pd_solve_plain(prep, uv, cfg, rounds)
    B, _, H, W = uv.shape
    dev = uv.device
    active = torch.ones(B, dtype=torch.int32, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    err = torch.full((B,), math.inf, dtype=torch.float32, device=dev)
    partial = torch.empty((B, pd_blocks(H, W)), dtype=torch.float32,
                          device=dev)
    p = torch.zeros((B, 4, H, W), dtype=torch.float32, device=dev)
    p_next = torch.empty_like(p)
    bufs = (torch.empty_like(uv), torch.empty_like(uv))
    cur, turn = uv, 0
    if rounds is not None:
        rounds.zero_()
    for o in range(cfg.outer_iterations):
        if rounds is not None:
            rounds += active
        if cfg.median_filtering > 1:
            cur = median5(cur, cfg.median_filtering, active, out=bufs[turn])
            turn ^= 1
        # The round's last step tests it, unless no round follows.
        test = o + 1 < cfg.outer_iterations
        for i in range(cfg.inner_iterations):
            last = test and i == cfg.inner_iterations - 1
            pd_step(prep, cur, p, active, cfg, bufs[turn], p_next,
                    *((partial, count, err) if last else ()))
            cur, turn = bufs[turn], turn ^ 1
            p, p_next = p_next, p
    return cur


# -- K-H: an image per thread-block cluster, its strips and cluster size -----

_CLUSTER_SIZES = (8, 16)     # blocks per cluster of the size rule: the
                             # portable maximum, then Hopper's non-portable one
_SCALE_BLOCKS = (1, 2, 4, 8, 16)   # the sizes ``pd_solve_scale`` may take
_BLOCK_SMEM = 232448         # bytes of shared memory a block may opt in to
_WARP_SCRATCH = 64           # floats beside the planes: the ε test's sums
# The fixed cost of one pass of clusters over the card, in pixels of a
# block's strip.  A level of the benchmark's batch (120 images of a 224²
# crop's pyramid, all in 8-block clusters: 8 passes a level) takes a + b ×
# (its strip's pixels) device ms; fitted to the five levels' spans
# (``va/tvl1.level.<h>x<w>``, 33 batches, NVIDIA H100 80GB HBM3 at 700 W):
# a = 3.675 ms, b = 3.286e-3 ms a pixel, within 5 % at every level, so one
# pass costs a / b ≈ 1,120 pixels' worth however small its strips: the
# latency of an iteration (two cluster barriers, short dependent chains).
_PASS_PX = 1120


def strip_geometry(h: int, w: int, blocks: int
                   ) -> Optional[Tuple[int, bool, int, int]]:
    """An (h, w) image in a cluster of `blocks` thread blocks (1, 2, 4, 8
    or 16).  Block r owns rows [r·rows, (r+1)·rows) with rows =
    ceil(h / blocks), and keeps the six state planes of that strip in its
    shared memory, four of them with a halo row that a neighbouring block
    fills; where three more planes fit, I1wx, I1wy and rho_c of the strip
    lie there too, else they are read through L2 each iteration.

    Returns (rows per strip, whether those constants lie in shared
    memory, bytes of shared memory a block, blocks), or None where the
    state alone exceeds the 232,448 B a block may have (or `blocks` is
    no cluster size the kernel takes)."""
    if blocks not in _SCALE_BLOCKS:
        return None
    rows = -(-h // blocks)
    smem = 4 * ((6 * rows + 4) * w + _WARP_SCRATCH)
    if smem > _BLOCK_SMEM:
        return None
    consts = smem + 4 * 3 * rows * w <= _BLOCK_SMEM
    return rows, consts, smem + (4 * 3 * rows * w if consts else 0), blocks


def warp_geometry(h: int, w: int
                  ) -> Optional[Tuple[int, bool, int, int]]:
    """The size rule of which levels ``level_solver`` sends to
    ``pd_solve_scale``: ``strip_geometry`` at 8 blocks where the strips
    fit, else at 16 (a non-portable cluster size: one block on each of 16
    SMs of one GPC).  Its size is the cap under which ``scale_blocks``
    chooses a launch's size for the batch.

    Returns (rows per strip, whether those constants lie in shared
    memory, bytes of shared memory a block, blocks per cluster), or None
    where the state alone exceeds the 232,448 B a block may have at both
    sizes: the level does not fit a cluster.  224² needs 229,632 B with
    the constants in 8 blocks, 256² 200,960 B without; 240×320 (235,776 B
    in 8 blocks) takes 16 and 178,176 B, 280×300 199,456 B and 295×296,
    the largest square level under the reference's size rule, 207,456 B.
    A 20×4000 level fits neither (256,256 B in 16 strips of 2 rows)."""
    for blocks in _CLUSTER_SIZES:
        geom = strip_geometry(h, w, blocks)
        if geom is not None:
            return geom
    return None


def scale_blocks(h: int, w: int, batch: int,
                 slots: Callable[[int], int]) -> Optional[int]:
    """Blocks per cluster of ``pd_solve_scale`` for `batch` images of
    (h, w).  ``slots(c)`` is the number of clusters of c blocks the card
    holds at once (``cudaOccupancyMaxActiveClusters``), so the batch runs
    in ceil(batch / slots(c)) passes, each of which costs a fixed
    ``_PASS_PX`` plus a strip's pixels.  Of the sizes up to the size
    rule's (``warp_geometry``) whose strips fit (``strip_geometry``) and
    of which the card holds a cluster, the one that costs least; ties go
    to the larger cluster.  (The fixed cost was fitted at the size rule's
    size; nothing measured says what a wider cluster's barriers cost.)
    A serve request's 15 images keep the size rule's size; a batch too
    large for one pass takes smaller clusters where their strips fit.
    None where the level fits no cluster."""
    rule = warp_geometry(h, w)
    if rule is None:
        return None
    best = None
    for blocks in _SCALE_BLOCKS:
        geom = strip_geometry(h, w, blocks)
        n = slots(blocks) if geom is not None and blocks <= rule[3] else 0
        if n < 1:
            continue
        cost = -(-batch // n) * (_PASS_PX + geom[0] * w)
        if best is None or cost <= best[0]:
            best = (cost, blocks)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def resident_clusters(device: int, h: int, w: int, blocks: int) -> int:
    """Clusters of `blocks` blocks of the solver kernel at (h, w) that
    card `device` holds at once (``cudaOccupancyMaxActiveClusters``, one
    block an SM); asked once a process.  The strips must fit."""
    with torch.cuda.device(device):
        n = _build.library().va_pd_warp_max_clusters(
            h, w, _build.GRID_YZ_MAX, blocks)
    if n < 0:
        _build.check(-n, "cudaOccupancyMaxActiveClusters")
    return n


# -- tvl1_scale: every warp of one pyramid scale in one launch ---------------

def pd_solve_scale_plain(i13: torch.Tensor, i0: torch.Tensor,
                         uv: torch.Tensor, cfg: TVL1Config,
                         rounds: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of ``pd_solve_scale``: ``cfg.warps`` times
    the warp with its prep and one warp's solve, then the scale-end
    median.  `rounds`, a (B, warps) tensor, receives the rounds each
    image ran in each warp."""
    for w in range(cfg.warps):
        uv = pd_solve_plain(warp_prep_plain(i13, i0, uv), uv, cfg,
                            None if rounds is None else rounds[:, w])
    if cfg.median_filtering > 1:
        uv = median5_plain(uv, cfg.median_filtering)
    return uv


def pd_solve_scale(i13: torch.Tensor, i0: torch.Tensor, uv: torch.Tensor,
                   cfg: TVL1Config, rounds: Optional[torch.Tensor] = None,
                   blocks: Optional[int] = None) -> torch.Tensor:
    """One whole pyramid scale of TV-L1 in one launch: ``cfg.warps`` times
    the warp of (I1, ∂I1/∂x, ∂I1/∂y) by the current flow with the
    solver's prep (what ``warp_prep`` computes) and one warp's solve (what
    ``pd_solve`` computes), then the k×k median once more.  An
    image's state stays in the shared memory of its cluster from the first
    warp to the last.  Equal to ``pd_solve_scale_plain`` bit for bit
    except where the order of the ε test's sum flips a round at the
    threshold; the cluster size only partitions that sum.

    Args:
      i13: (B, 3, H, W) float32 planes I1, ∂I1/∂x, ∂I1/∂y.
      i0: (B, H, W) float32 first frame.
      uv: (B, 2, H, W) flow at the scale's start; not modified.
      cfg: the TVL1Config (warps, λ, θ, τ, ε, iteration counts, median).
      rounds: optional (B, warps) int32 tensor that receives the outer
        rounds each image ran in each warp.
      blocks: blocks per cluster; by default ``scale_blocks`` chooses for
        the batch from the card's occupancy.  Tests force each size.

    Returns:
      (B, 2, H, W) float32 flow at the scale's end.

    Raises ValueError for a CUDA tensor of a level that does not fit a
    cluster (``warp_geometry``): the caller picks the solver by that rule;
    and for `blocks` whose strips do not fit (``strip_geometry``).
    """
    if not uv.is_cuda:
        return pd_solve_scale_plain(i13, i0, uv, cfg, rounds)
    B, _, H, W = uv.shape
    dev = uv.device
    if warp_geometry(H, W) is None:
        raise ValueError(f"pd_solve_scale: a {H}x{W} level does not fit the "
                         f"shared memory of a cluster (warp_geometry); "
                         f"warp_prep and pd_solve are the kernels for it")
    if blocks is not None and strip_geometry(H, W, blocks) is None:
        raise ValueError(f"pd_solve_scale: a {H}x{W} level does not fit "
                         f"clusters of {blocks} blocks (strip_geometry)")
    if H < 2 or W < 2:
        raise ValueError(f"pd_solve_scale needs H, W >= 2, got {(H, W)}")
    _build.expect(i13, "i13", (B, 3, H, W), dev)
    _build.expect(i0, "i0", (B, H, W), dev)
    _build.expect(uv, "uv", (B, 2, H, W), dev)
    k = cfg.median_filtering if cfg.median_filtering > 1 else 0
    if k not in (0, 3, 5):
        raise ValueError(f"pd_solve_scale takes a median of 3 or 5, got {k}")
    _build.expect_grid_batch(B, "pd_solve_scale")
    if rounds is not None and (
            rounds.dtype != torch.int32 or rounds.device != dev
            or tuple(rounds.shape) != (B, cfg.warps)
            or not rounds.is_contiguous()):
        raise ValueError(f"rounds: expected a contiguous ({B}, {cfg.warps}) "
                         f"int32 tensor on {dev}")
    if cfg.warps < 1:        # no warp: the scale is its closing median alone
        return median5(uv, k) if k else uv.clone()
    if blocks is None:
        blocks = scale_blocks(H, W, B, functools.partial(
            resident_clusters, dev.index, H, W))
        if blocks is None:
            raise RuntimeError(f"pd_solve_scale: the card holds no cluster "
                               f"of a {H}x{W} level at any size")
    out = torch.empty_like(uv)
    # Where the strip's constants do not fit shared memory beside the state
    # the kernel keeps them here, each block its own strip's.
    consts = strip_geometry(H, W, blocks)[1]
    scratch = None if consts else torch.empty_like(i13)
    l_t, theta, taut = _solver_constants(cfg)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.va_pd_scale(
        i13.data_ptr(), i0.data_ptr(), uv.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if rounds is None else rounds.data_ptr(), B, H, W, blocks,
        cfg.warps, cfg.inner_iterations, cfg.outer_iterations, k, l_t, theta,
        taut, cfg.epsilon * cfg.epsilon, stream), "pd_solve_scale")
    pd_solve_scale.launches += 1
    by = pd_solve_scale.launches_by_blocks
    by[blocks] = by.get(blocks, 0) + 1
    return out


pd_solve_scale.launches = 0
pd_solve_scale.launches_by_blocks = {}   # blocks per cluster → launches


# -- K-G: several iterations per launch, for large planes --------------------

_CHUNK_SIDE = 64       # window side S of pd_chunk: 6 planes of S² floats
_TILE_ROWS_PER_BAND = 4
# One launch's fixed share (window load, tile store, launch), in iterations'
# cost: fitted to one 1080×1920 warp timed at 2 to 15 iterations per launch
# on an H100 (chip_smoke.py --sweep-chunk; within 5 % at every point).
_CHUNK_IO_ITERS = 7.0


def _median_radius(cfg: TVL1Config) -> int:
    return cfg.median_filtering // 2 if cfg.median_filtering > 1 else 0


def chunk_tile(chunk: int, cfg: TVL1Config) -> Tuple[int, int]:
    """(tile, halo) of ``pd_chunk`` for `chunk` iterations per launch: the
    halo covers the iterations plus the median's radius, and the tile is
    what a 64×64 window (six state planes, 96 KB of shared memory, so that
    two blocks share an SM) leaves inside it."""
    halo = chunk + _median_radius(cfg)
    tile = _CHUNK_SIDE - 2 * halo
    if tile < 1:
        raise ValueError(f"chunk {chunk} leaves no tile inside a "
                         f"{_CHUNK_SIDE}-wide window (halo {halo})")
    return tile, halo


def chunk_params(h: int, w: int, cfg: TVL1Config) -> Tuple[int, int]:
    """(band, chunk) of ``pd_solve_chunked`` for an (h, w) plane.

    chunk = iterations per launch.  A launch works on its whole S×S
    window to deliver a T×T tile, T = S − 2·(chunk + median radius), so
    the redundant work grows as (S/T)² with the chunk, while a small
    chunk pays the window's load and the tile's store more often.  The
    cost per round in window-pixel iterations, with one load-and-store
    priced at `_CHUNK_IO_ITERS` iterations, is minimised over the chunk.
    band = rows per gating band: `_TILE_ROWS_PER_BAND` tile rows, so no
    tile straddles a band edge; coarse enough that a band's ε test is a
    mean over many pixels, fine enough that still rows of a large frame
    stop on their own."""
    K = cfg.inner_iterations
    best = None
    for chunk in range(1, K + 1):
        tile = _CHUNK_SIDE - 2 * (chunk + _median_radius(cfg))
        if tile < 8:
            break
        n_chunks = -(-K // chunk)
        cost = (K + n_chunks * _CHUNK_IO_ITERS) * (_CHUNK_SIDE / tile) ** 2
        if best is None or cost < best[0]:
            best = (cost, chunk, tile)
    _, chunk, tile = best
    return _TILE_ROWS_PER_BAND * tile, chunk


def _expect_band_flags(act: torch.Tensor, B: int, n_bands: int, device,
                       name: str = "act") -> None:
    if (act.dtype != torch.int32 or tuple(act.shape) != (B, n_bands)
            or act.device != device or not act.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous ({B}, {n_bands}) "
                         f"int32 tensor on {device}, got {tuple(act.shape)} "
                         f"{act.dtype} on {act.device}")


def pd_chunk_plain(prep: torch.Tensor, state: torch.Tensor,
                   act: torch.Tensor, cfg: TVL1Config, iters: int, band: int,
                   do_median: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pd_chunk``: iterate the whole planes,
    then keep the new values in the rows of active bands only.  Returns
    (state, err) with err (B, n_bands) the summed squared update of the
    last iteration over each active band, 0 for a frozen one."""
    B, _, H, W = state.shape
    n_bands = -(-H // band)
    uv, p = state[:, :2], state[:, 2:]
    if do_median and cfg.median_filtering > 1:
        uv = median5_plain(uv, cfg.median_filtering)
    sq = None
    for i in range(iters):
        uv, p, sq = _pd_step_fields(prep, uv, p, cfg, i == iters - 1)
    pad = n_bands * band - H
    sq = torch.nn.functional.pad(sq, (0, 0, 0, pad))
    err = sq.reshape(B, n_bands, band * W).sum(dim=2)
    on = act.bool()
    rows = on.repeat_interleave(band, dim=1)[:, :H].view(B, 1, H, 1)
    new = torch.where(rows, torch.cat([uv, p], dim=1), state)
    return new, torch.where(on, err, torch.zeros_like(err))


def chunk_partials(H: int, W: int, band: int, tile: int) -> int:
    """Thread blocks of ``pd_chunk`` per gating band: the row length of
    its ``partial`` sums."""
    return -(-band // tile) * -(-W // tile)


def pd_chunk(prep: torch.Tensor, state: torch.Tensor, act: torch.Tensor,
             cfg: TVL1Config, iters: int, band: int, tile: int, halo: int,
             do_median: bool, state_out: torch.Tensor,
             partial: Optional[torch.Tensor] = None,
             prev_act: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None,
             err_band: Optional[torch.Tensor] = None,
             act_next: Optional[torch.Tensor] = None,
             adaptive: bool = True) -> None:
    """`iters` primal-dual iterations of every active band, on CUDA tensors.

    prep (B, 4, H, W) from ``warp_prep``; state (B, 6, H, W) holds u, v,
    p11, p12, p21, p22 and is read; the new state goes to the distinct
    buffer state_out (frozen bands are copied forward).  act
    (B, ceil(H / band)) int32 gates each band of `band` rows.  With
    ``do_median`` the k×k median of u and v (``cfg.median_filtering``)
    runs first.  `tile` and `halo` are the block's tile side and window
    margin (``chunk_tile``): halo ≥ iters + k // 2, tile + 2·halo ≤ 64.
    With ``partial`` ((B, n_bands, chunk_partials(H, W, band, tile))
    float32) each block writes its tile's summed squared update of the
    last iteration there, 0 for a frozen band.  ``prev_act``, if given,
    holds the flags of the launch before, which read what this launch
    writes and wrote what it reads (the ping-pong of
    ``pd_solve_chunked``): a band frozen in both is left alone, its rows
    being equal in both buffers already.

    With ``count`` ((B,) int32, zero, left zero), ``err_band``
    ((B, n_bands) float32) and ``act_next`` ((B, n_bands) int32, a buffer
    other than act and prev_act) as well as ``partial``, the launch ends
    with the bands' convergence test of ``band_flags_plain`` (ε from cfg):
    each band that ran takes the sum of its blocks' partials (in a fixed
    order) as its ``err_band``, and ``act_next`` receives the next round's
    flags by the rule of ``_band_flags``."""
    B, _, H, W = state.shape
    dev = state.device
    if not state.is_cuda:
        raise ValueError("pd_chunk launches a CUDA kernel: pass CUDA tensors "
                         "(pd_chunk_plain is the CPU version)")
    _build.expect(prep, "prep", (B, 4, H, W), dev)
    _build.expect(state, "state", (B, 6, H, W), dev)
    _build.expect(state_out, "state_out", (B, 6, H, W), dev)
    if state_out.data_ptr() == state.data_ptr():
        raise ValueError("pd_chunk: state_out must not alias state")
    _build.expect_grid_batch(B, "pd_chunk")
    n_bands = -(-H // band)
    _expect_band_flags(act, B, n_bands, dev)
    if prev_act is not None:
        _expect_band_flags(prev_act, B, n_bands, dev, "prev_act")
    k = cfg.median_filtering if do_median and cfg.median_filtering > 1 else 0
    if k not in (0, 3, 5):
        raise ValueError(f"pd_chunk takes a median of 3 or 5, got {k}")
    if halo < iters + k // 2:
        raise ValueError(f"pd_chunk: halo {halo} < iters {iters} + median "
                         f"radius {k // 2}")
    if partial is not None:
        _build.expect(partial, "partial",
                      (B, n_bands, chunk_partials(H, W, band, tile)), dev)
    given = [t is not None for t in (count, err_band, act_next)]
    test = any(given)
    if test:
        if partial is None or not all(given):
            raise ValueError("pd_chunk: the bands' test takes partial, "
                             "count, err_band and act_next together")
        _expect_active(count, B, dev, "count")
        _build.expect(err_band, "err_band", (B, n_bands), dev)
        _expect_band_flags(act_next, B, n_bands, dev, "act_next")
        if any(t is not None and act_next.data_ptr() == t.data_ptr()
               for t in (act, prev_act, count)):
            raise ValueError("pd_chunk: act_next must not alias act, "
                             "prev_act or count")
    l_t, theta, taut = _solver_constants(cfg)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.va_pd_chunk(
        prep.data_ptr(), state.data_ptr(), state_out.data_ptr(),
        act.data_ptr(), None if prev_act is None else prev_act.data_ptr(),
        None if partial is None else partial.data_ptr(),
        count.data_ptr() if test else None,
        err_band.data_ptr() if test else None,
        act_next.data_ptr() if test else None, B, H, W, band, tile, halo,
        iters, k, l_t, theta, taut, cfg.epsilon * cfg.epsilon, int(adaptive),
        stream), "pd_chunk")
    pd_chunk.launches += 1
    pd_chunk.launches_test += test


pd_chunk.launches = 0
pd_chunk.launches_test = 0     # of them, launches that ran the bands' test


def _band_flags(err_band: torch.Tensor, band_px: torch.Tensor, n_px: int,
                eps2: float, adaptive: bool) -> torch.Tensor:
    """(B, n_bands) bool: which bands run this round
    (``tvl1_solve.py:1054-1070``).  An image whose summed error is under
    ε² per pixel has stopped.  With ``adaptive`` a band runs if it or a
    neighbouring band has not met ε² per pixel on its own."""
    conv = err_band.sum(dim=1) / n_px < eps2
    if not adaptive:
        return (~conv)[:, None].expand_as(err_band)
    active = err_band >= eps2 * band_px
    run = active.clone()
    run[:, :-1] |= active[:, 1:]
    run[:, 1:] |= active[:, :-1]
    return run & ~conv[:, None]


def _band_px(H: int, W: int, band: int, device) -> torch.Tensor:
    """(n_bands,) float32: pixels of each band of `band` rows."""
    return torch.tensor([min(band, H - band * i) * W
                         for i in range(-(-H // band))],
                        dtype=torch.float32, device=device)


def band_flags_plain(partial: torch.Tensor, act: torch.Tensor,
                     err_band: torch.Tensor, act_next: torch.Tensor,
                     band: int, H: int, W: int, epsilon: float,
                     adaptive: bool) -> None:
    """Plain PyTorch version of the bands' test that ``pd_chunk`` runs in
    a round's last launch (in place): each band that ran (``act``) takes
    the sum of its ``partial`` row (B, n_bands, n_part) as its
    ``err_band``, and ``act_next`` receives the next round's flags by the
    rule of ``_band_flags``."""
    err_band.copy_(torch.where(act.bool(), partial.sum(dim=2), err_band))
    run = _band_flags(err_band, _band_px(H, W, band, err_band.device), H * W,
                      epsilon * epsilon, adaptive)
    act_next.copy_(run.to(act_next.dtype))


def _solve_chunked_plain(prep: torch.Tensor, uv: torch.Tensor,
                         cfg: TVL1Config, band: int, chunk: int,
                         adaptive: bool,
                         rounds: Optional[torch.Tensor]) -> torch.Tensor:
    B, _, H, W = uv.shape
    K = cfg.inner_iterations
    eps2 = cfg.epsilon * cfg.epsilon
    n_bands = -(-H // band)
    band_px = _band_px(H, W, band, uv.device)
    state = torch.cat([uv, torch.zeros((B, 4, H, W), dtype=torch.float32,
                                       device=uv.device)], dim=1)
    err_band = torch.full((B, n_bands), math.inf, dtype=torch.float32,
                          device=uv.device)
    ran = torch.zeros((B, n_bands), dtype=torch.int32, device=uv.device)
    for _ in range(cfg.outer_iterations):
        run = _band_flags(err_band, band_px, H * W, eps2, adaptive)
        if not bool(run.any()):
            break
        act = run.to(torch.int32)
        ran += act
        for c0 in range(0, K, chunk):
            state, err = pd_chunk_plain(prep, state, act, cfg,
                                        min(chunk, K - c0), band, c0 == 0)
        err_band = torch.where(run, err, err_band)
    if rounds is not None:
        rounds.copy_(ran)
    return state[:, :2].contiguous()


def _solve_chunked_cuda(prep: torch.Tensor, uv: torch.Tensor,
                        cfg: TVL1Config, band: int, chunk: int,
                        adaptive: bool,
                        rounds: Optional[torch.Tensor]) -> torch.Tensor:
    """Every buffer is allocated here, once; a round is its launches of
    ``pd_chunk``, the last of which writes the error sums and runs the
    bands' test on them (unless no round follows).  Nothing is read
    back."""
    B, _, H, W = uv.shape
    dev = uv.device
    K = cfg.inner_iterations
    n_bands = -(-H // band)
    tile, halo = chunk_tile(chunk, cfg)
    if band % tile:
        raise ValueError(f"band {band} is not a multiple of the tile "
                         f"{tile} that chunk {chunk} gives")
    state = torch.cat([uv, torch.zeros((B, 4, H, W), dtype=torch.float32,
                                       device=dev)], dim=1)
    spare = torch.empty_like(state)
    partial = torch.empty((B, n_bands, chunk_partials(H, W, band, tile)),
                          dtype=torch.float32, device=dev)
    err_band = torch.full((B, n_bands), math.inf, dtype=torch.float32,
                          device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    # Three flag buffers in turn: the round's, the next round's (written by
    # its last launch) and the round's before, which its first launch reads
    # as prev_act.
    flags = [torch.ones((B, n_bands), dtype=torch.int32, device=dev)
             for _ in range(3)]
    prev = None
    if rounds is not None:
        rounds.zero_()
    for o in range(cfg.outer_iterations):
        act, act_next = flags[o % 3], flags[(o + 1) % 3]
        if rounds is not None:
            rounds += act
        test = o + 1 < cfg.outer_iterations
        for c0 in range(0, K, chunk):
            last = test and c0 + chunk >= K
            pd_chunk(prep, state, act, cfg, min(chunk, K - c0), band, tile,
                     halo, c0 == 0, spare, partial if last else None, prev,
                     *((count, err_band, act_next, adaptive) if last else ()))
            state, spare, prev = spare, state, act
    return state[:, :2].contiguous()


def pd_solve_chunked_plain(prep: torch.Tensor, uv: torch.Tensor,
                           cfg: TVL1Config, band: int, chunk: int,
                           adaptive: bool = True,
                           rounds: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of ``pd_solve_chunked``.  Reads the flags on
    the host each round and stops once all are clear."""
    return _solve_chunked_plain(prep, uv, cfg, band, chunk, adaptive, rounds)


def pd_solve_chunked(prep: torch.Tensor, uv: torch.Tensor, cfg: TVL1Config,
                     band: int, chunk: int, adaptive: bool = True,
                     rounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All primal-dual iterations of one TV-L1 warp of a large plane:
    the counterpart of the reference's ``tvl1_solve_warp_banded``.

    The dual variables start at zero.  Each of ``outer_iterations``
    rounds is ``ceil(inner_iterations / chunk)`` launches of
    ``pd_chunk``, the first with the median.  An image stops when its
    summed error falls under ε² per pixel; with ``adaptive`` each band of
    `band` rows stops on its own ε test unless a neighbouring band still
    runs, and a stopped band runs again when a neighbour's test fails.
    A running band iterates from the chunk's start state of its frozen
    neighbours, whose rows are not written: the result depends on
    (band, chunk), as in the reference.  With ``adaptive=False`` it does
    not, and equals ``pd_solve``'s up to the order of the ε sums.  The
    flags stay on the device; nothing is read back.

    Args:
      prep: (B, 4, H, W) from ``warp_prep``.
      uv: (B, 2, H, W) flow at the warp's start; not modified.
      band, chunk: rows per gating band (a multiple of the tile that
        ``chunk_tile(chunk, cfg)`` gives) and iterations per launch
        (``chunk_params`` picks both).
      rounds: optional (B, ceil(H / band)) int32 tensor that receives the
        outer rounds each band of each image ran (summed from the flags
        on the device).

    Returns:
      (B, 2, H, W) float32 flow after the warp.
    """
    solve = _solve_chunked_cuda if uv.is_cuda else _solve_chunked_plain
    return solve(prep, uv, cfg, band, chunk, adaptive, rounds)
