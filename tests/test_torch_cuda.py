"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false; on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small and ragged (not multiples of the 32x8 thread tiles),
so the kernels' edge handling is exercised; chip_smoke.py checks the
serve path's full shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config
from video_analytics_tpu_torch.flow.farneback import (
    farneback, farneback_sequence)
from video_analytics_tpu_torch.flow.tvl1 import tvl1
from video_analytics_tpu_torch.ops.cuda import farneback as fk
from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep, warp_prep_plain
from video_analytics_tpu_torch.ops.kernels import centered_gradient

pytestmark = pytest.mark.cuda

FAST = TVL1Config(nscales=3, warps=2, outer_iterations=4,
                  inner_iterations=10, median_filtering=5)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _images(dev, b, h, w, seed=0):
    """b smooth [0, 255] images and their successors moved ~(1.2, -0.6)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for t in (0.0, 1.0):
        imgs = []
        for k in range(b):
            ph = rng.uniform(0, 6, 4)
            img = (np.sin(0.21 * (x - 1.2 * t) + ph[0])
                   + np.cos(0.17 * (y + 0.6 * t) + ph[1])
                   + 0.5 * np.sin(0.1 * (x + y - 0.6 * t) + ph[2]))
            imgs.append(127.5 + 60 * img)
        rng = np.random.default_rng(seed)      # same phases for t = 1
        out.append(torch.tensor(np.stack(imgs), dtype=torch.float32,
                                device=dev))
    return out


def _level(dev, b=3, h=37, w=53):
    i0, i1 = _images(dev, b, h, w)
    i1x, i1y = centered_gradient(i1)
    i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
    g = torch.Generator(dev).manual_seed(1)
    uv = 2.0 * torch.randn((b, 2, h, w), device=dev, generator=g)
    return i0, i13, uv


def test_warp_prep_matches_plain(dev):
    i0, i13, uv = _level(dev)
    n = warp_prep.launches
    got = warp_prep(i13, i0, uv)
    assert warp_prep.launches == n + 1
    assert torch.equal(got, warp_prep_plain(i13, i0, uv))


def _median_planes(dev, b, h, w, seed=0):
    """(b, 2, h, w) flow planes with what a selection network can get
    wrong: ties (values on a coarse grid), a constant region, and zeros of
    both signs."""
    g = torch.Generator(dev).manual_seed(seed)
    uv = torch.round(4.0 * torch.randn((b, 2, h, w), device=dev,
                                       generator=g)) / 2.0
    uv[:, :, : h // 3, : w // 3] = 1.5
    zeros = torch.rand((b, 2, h, w), device=dev, generator=g) < 0.2
    signs = torch.where(torch.rand((b, 2, h, w), device=dev, generator=g)
                        < 0.5, -1.0, 1.0)
    return torch.where(zeros, 0.0 * signs, uv).contiguous()


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h,w", [(37, 53), (5, 7), (2, 40), (40, 3), (1, 1),
                                 (70, 130), (1080, 1920)])
def test_median5_bit_exact_with_mask(dev, k, h, w):
    """Equal by value (torch.equal: -0 equals +0) to the plain version, on
    planes narrower than a block's 32 columns or shorter than a thread's 8
    rows or than k, and at the full 1080p level; a masked image passes
    through."""
    uv = _median_planes(dev, 4, h, w, seed=h * w)
    if (h, w) == (37, 53):
        _, _, uv = _level(dev, b=4)
    active = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=dev)
    for mask in (None, active):
        got = ts.median5(uv, k, mask)
        assert torch.equal(got, ts.median5_plain(uv, k, mask))
    assert torch.equal(got[1:3], uv[1:3])


@pytest.mark.parametrize("k", [3, 5])
def test_median5_unaligned_rows(dev, k):
    """Rows of a multiple of four floats that start 4 bytes past a 16-byte
    boundary take the one-float loads, not the 16-byte ones."""
    uv = _median_planes(dev, 2, 24, 64, seed=k)
    store = torch.empty(uv.numel() + 1, device=dev)
    x = store[1:].view(uv.shape)
    x.copy_(uv)
    out = torch.empty(uv.numel() + 1, device=dev)[1:].view(uv.shape)
    active = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    assert torch.equal(ts.median5(x, k, active, out=out),
                       ts.median5_plain(uv, k, active))


@pytest.mark.parametrize("epsilon", [0.01, 0.0])
def test_pd_solve_matches_plain(dev, epsilon):
    cfg = dataclasses.replace(FAST, epsilon=epsilon)
    i0, i13, uv = _level(dev)
    prep = warp_prep_plain(i13, i0, uv)
    got = ts.pd_solve(prep, uv, cfg)
    want = ts.pd_solve_plain(prep, uv, cfg)
    assert (got - want).abs().max().item() <= 1e-4


def test_tvl1_kernels_match_plain_and_ignore_batch(dev):
    i0, i1 = _images(dev, 3, 48, 64, seed=5)
    cfg = dataclasses.replace(FAST, epsilon=0.0)
    got = tvl1(i0, i1, cfg)
    want = tvl1(i0, i1, cfg, plain=True)
    assert (got - want).abs().max().item() <= 1e-3
    assert torch.equal(tvl1(i0[1:2], i1[1:2], FAST)[0],
                       tvl1(i0, i1, FAST)[1])


def test_wrappers_reject_bad_tensors(dev):
    i0, i13, uv = _level(dev)
    with pytest.raises(ValueError, match="dtype"):
        warp_prep(i13.double(), i0, uv)
    with pytest.raises(ValueError, match="contiguous"):
        warp_prep(i13, i0, uv.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="active"):
        ts.median5(uv, 5, torch.ones(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shape"):
        ts.median5(uv, 5, out=torch.empty_like(uv[:, :1]))
    with pytest.raises(ValueError, match="on cpu"):
        warp_prep(i13, i0.cpu(), uv)


# -- K-G: the chunked large-plane solver ------------------------------------

def _chunk_inputs(dev, b, h, w, n_bands, seed=0):
    """prep from a real warp, a random solver state and band flags with
    some bands frozen."""
    i0, i13, uv = _level(dev, b, h, w)
    prep = warp_prep_plain(i13, i0, uv)
    g = torch.Generator(dev).manual_seed(seed)
    state = torch.cat([uv, 0.3 * torch.randn((b, 4, h, w), device=dev,
                                             generator=g)], dim=1)
    act = (torch.rand((b, n_bands), device=dev, generator=g) < 0.7).to(
        torch.int32)
    act[0, 0] = 1
    return prep, state, act


@pytest.mark.parametrize("k", [0, 3, 5])
@pytest.mark.parametrize("h,w,band,tile,halo,iters", [
    (61, 96, 16, 16, 8, 3),        # ragged last band, tile = band
    (75, 131, 32, 16, 9, 7),       # two tile rows per band, W remainder
    (20, 23, 40, 40, 12, 10),      # H and W below one tile, one band
    (130, 70, 48, 48, 8, 6),       # the 64-wide window of the main path
    (97, 150, 24, 12, 4, 1),       # one iteration per launch
])
def test_pd_chunk_matches_plain(dev, k, h, w, band, tile, halo, iters):
    """State bit for bit (same operations in the same order, no FMA
    contraction); the band sums to 1e-5 relative (their order differs)."""
    cfg = TVL1Config(median_filtering=k)
    n_bands = -(-h // band)
    prep, state, act = _chunk_inputs(dev, 2, h, w, n_bands, seed=h + k)
    for do_median in (True, False):
        if do_median and halo < iters + k // 2:
            continue
        out = torch.full_like(state, float("nan"))
        partial = torch.full(
            (2, n_bands, ts.chunk_partials(h, w, band, tile)), float("nan"),
            device=dev)
        n = ts.pd_chunk.launches
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo,
                    do_median, out, partial)
        assert ts.pd_chunk.launches == n + 1
        err = partial.sum(dim=2)
        want, want_err = ts.pd_chunk_plain(prep, state, act, cfg, iters,
                                           band, do_median)
        assert torch.equal(out, want), (out - want).abs().max().item()
        assert err.shape == want_err.shape
        assert ((err - want_err).abs() <= 1e-5 * want_err.abs()).all()
        assert (err[act == 0] == 0).all()
        # Without error sums the state is the same; a band frozen in the
        # launch before as well is left alone (its rows are there already).
        again = torch.full_like(state, float("nan"))
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo,
                    do_median, again)
        assert torch.equal(again, want)
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo,
                    do_median, again, None, act)
        assert torch.equal(again, want)
        fresh = torch.full_like(state, float("nan"))
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo,
                    do_median, fresh, None, act)
        rows = (act == 0).repeat_interleave(band, dim=1)[:, None, :h, None]
        rows = rows.expand_as(fresh)
        assert fresh[rows].isnan().all()
        assert torch.equal(fresh[~rows], want[~rows])


@pytest.mark.parametrize("adaptive", [False, True])
def test_pd_solve_chunked_matches_plain(dev, adaptive):
    """At ε = 0 no flag ever clears, so kernels and plain versions agree
    bit for bit, and adaptive=False equals the per-iteration chain; with
    the gate engaged a band's flag may flip on the order of its sum, so
    the bound is 10·ε."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, inner_iterations=7)
    i0, i13, uv = _level(dev, 2, 150, 131)
    prep = warp_prep_plain(i13, i0, uv)
    band, chunk = 2 * ts.chunk_tile(3, cfg)[0], 3
    got = ts.pd_solve_chunked(prep, uv, cfg, band, chunk, adaptive)
    want = ts.pd_solve_chunked_plain(prep, uv, cfg, band, chunk, adaptive)
    assert torch.equal(got, want)
    assert torch.equal(got, ts.pd_solve(prep, uv, cfg))
    gated = dataclasses.replace(cfg, epsilon=0.05)
    got = ts.pd_solve_chunked(prep, uv, gated, band, chunk, adaptive)
    want = ts.pd_solve_chunked_plain(prep, uv, gated, band, chunk, adaptive)
    assert (got - want).abs().max().item() <= 10 * gated.epsilon


def test_tvl1_chunked_levels_match_plain(dev):
    """``tvl1`` above the size rule (320x300 > 87,381 px): the finest
    level takes K-G, the coarser one (256x240) the whole-scale launch of
    the cluster solver."""
    i0, i1 = _images(dev, 2, 320, 300, seed=3)
    cfg = TVL1Config(nscales=2, warps=2, outer_iterations=2,
                     inner_iterations=8, epsilon=0.0)
    n, n_scale = ts.pd_chunk.launches, ts.pd_solve_scale.launches
    got = tvl1(i0, i1, cfg)
    band, chunk = ts.chunk_params(320, 300, cfg)
    assert ts.pd_chunk.launches - n == 2 * 2 * -(-8 // chunk)
    assert ts.pd_solve_scale.launches - n_scale == 1
    assert torch.equal(got, tvl1(i0, i1, cfg, plain=True))


@pytest.mark.parametrize("route", ["chain", "chunked", "scale"])
def test_rounds_match_plain(dev, route):
    """The rounds each solver reports on the card (each image's, each
    band's on the chunked solver) against its plain version's on the same
    inputs, with the ε test engaged: equal, but where the order of the
    test's sum flips a round at the threshold (at most one a warp); at
    ε = 0 every image runs every round.  Reporting them changes no
    result."""
    i0, i13, uv = _level(dev, 3, 150, 131)
    prep = warp_prep_plain(i13, i0, uv)
    band, chunk = 2 * ts.chunk_tile(3, FAST)[0], 3
    shape = {"chain": (3,), "chunked": (3, -(-150 // band)),
             "scale": (3, FAST.warps)}[route]
    for eps in (0.05, 0.0):
        cfg = dataclasses.replace(FAST, epsilon=eps)
        solve, plain = {
            "chain": (lambda c, r=None: ts.pd_solve(prep, uv, c, r),
                      lambda c, r: ts.pd_solve_plain(prep, uv, c, r)),
            "chunked": (lambda c, r=None: ts.pd_solve_chunked(
                prep, uv, c, band, chunk, True, r),
                        lambda c, r: ts.pd_solve_chunked_plain(
                prep, uv, c, band, chunk, True, r)),
            "scale": (lambda c, r=None: ts.pd_solve_scale(i13, i0, uv, c, r),
                      lambda c, r: ts.pd_solve_scale_plain(i13, i0, uv, c,
                                                           r))}[route]
        got = torch.full(shape, -1, dtype=torch.int32, device=dev)
        want = torch.full(shape, -1, dtype=torch.int32, device=dev)
        assert torch.equal(solve(cfg, got), solve(cfg))
        plain(cfg, want)
        assert int(got.min()) >= 0 and int(got.max()) <= cfg.outer_iterations
        assert (got - want).abs().max().item() <= (1 if eps else 0)
        if not eps:
            assert int(got.min()) == cfg.outer_iterations


def test_pd_chunk_rejects_bad_arguments(dev):
    cfg = TVL1Config()
    prep, state, act = _chunk_inputs(dev, 1, 40, 40, 1)
    out = torch.empty_like(state)
    with pytest.raises(ValueError, match="halo"):
        ts.pd_chunk(prep, state, act, cfg, 5, 40, 40, 5, True, out)
    with pytest.raises(ValueError, match="alias"):
        ts.pd_chunk(prep, state, act, cfg, 2, 40, 40, 4, True, state)
    with pytest.raises(ValueError, match="act"):
        ts.pd_chunk(prep, state, act.long(), cfg, 2, 40, 40, 4, True, out)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        # a 120-wide window is wider than the kernel's 64-wide grid
        ts.pd_chunk(prep, state, act, cfg, 2, 40, 100, 10, True, out)
    with pytest.raises(ValueError, match="partial"):
        ts.pd_chunk(prep, state, act, cfg, 2, 40, 40, 4, True, out,
                    torch.empty((1, 1, 7), device=dev))


def _split_epsilon(err, px, keep):
    """ε whose ε² lies mid-way (geometrically) in the widest gap between
    the per-pixel errors err / px (where `keep` and positive): sums on
    both sides of the threshold, none within rounding of it."""
    r = torch.unique((err / px)[keep & (err > 0)]).double()
    assert r.numel() >= 2, r
    gap = (r[1:] / r[:-1]).argmax()
    return float((r[gap] * r[gap + 1]).sqrt().sqrt())


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("b,h,w,band,tile,halo,iters", [
    (1, 61, 96, 16, 5, 4, 2),      # a tile row past the image's end
    (45, 40, 33, 40, 40, 12, 2),   # one block an image, 45 images
    (3, 1080, 53, 24, 10, 4, 2),   # 45 bands; short tile rows at band ends
])
def test_pd_chunk_band_test_matches_plain(dev, b, h, w, band, tile, halo,
                                         iters, adaptive):
    """The round's last launch with the bands' test: its state equals
    ``pd_chunk_plain``'s bit for bit; its ``err_band`` and ``act_next``
    equal ``band_flags_plain`` run on the partials the same launch wrote
    (flags exactly, sums to 1e-5 relative: their order differs).  Odd
    bands move 1e-2 as much as even ones, image 1 is at rest (its error is
    0: it converges), some bands are frozen, with and without
    ``prev_act``, and the last image keeps the first round's inf."""
    cfg = TVL1Config(median_filtering=5)
    n_bands = -(-h // band)
    prep, state, _ = _chunk_inputs(dev, b, h, w, n_bands, seed=h + b)
    rows = torch.arange(h, device=dev) // band % 2 == 1
    state[:, :, rows] *= 1e-2
    prep[:, 3, rows] *= 1e-2
    if b > 1:
        state[1] = 0.0
        prep[1, 3] = 0.0
    act = torch.ones((b, n_bands), dtype=torch.int32, device=dev)
    act[0, 1::3] = 0
    act[-1, :1] = 0
    _, want_err = ts.pd_chunk_plain(prep, state, act, cfg, iters, band, True)
    px = torch.tensor([min(band, h - band * j) * w for j in range(n_bands)],
                      dtype=torch.float32, device=dev)
    eps = _split_epsilon(want_err, px, act == 1)
    cfg = dataclasses.replace(cfg, epsilon=eps)
    g = torch.Generator(dev).manual_seed(h)
    old = torch.rand((b, n_bands), device=dev, generator=g) * 2 * eps ** 2 * px
    if b > 1:
        old[1] = 0.0
    old[-1, :1] = float("inf")
    partial = torch.full((b, n_bands, ts.chunk_partials(h, w, band, tile)),
                         float("nan"), device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    want_state, _ = ts.pd_chunk_plain(prep, state, act, cfg, iters, band,
                                      True)
    for prev in (None, act):
        out = torch.full_like(state, float("nan"))
        if prev is not None:        # the frozen rows are there already
            out.copy_(want_state)
        errs = [old.clone(), old.clone()]
        nxt = [torch.full_like(act, -1), torch.full_like(act, -1)]
        n = ts.pd_chunk.launches, ts.pd_chunk.launches_test
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo, True, out,
                    partial, prev, count, errs[0], nxt[0], adaptive)
        assert (ts.pd_chunk.launches, ts.pd_chunk.launches_test) == (
            n[0] + 1, n[1] + 1)
        assert torch.equal(out, want_state)
        assert not count.any()
        ts.band_flags_plain(partial, act, errs[1], nxt[1], band, h, w, eps,
                            adaptive)
        assert torch.equal(nxt[0], nxt[1])
        finite = errs[1].isfinite()
        assert torch.equal(errs[0].isfinite(), finite)
        assert ((errs[0] - errs[1])[finite].abs()
                <= 1e-5 * errs[1][finite].abs()).all()
        r = (errs[1] / px)[finite] / eps ** 2
        assert ((r - 1).abs() > 1e-3).all()
        mean = errs[1].sum(dim=1) / (h * w) / eps ** 2
        assert ((mean - 1).abs() > 1e-3).all()
        if b > 1:
            assert not nxt[0][1].any()      # the image at rest has stopped
    assert bool(((want_err / px)[act == 1] < eps ** 2).any())
    assert bool(((want_err / px)[act == 1] > eps ** 2).any())
    with pytest.raises(ValueError, match="alias"):
        ts.pd_chunk(prep, state, act, cfg, iters, band, tile, halo, True,
                    out, partial, None, count, errs[0], act, adaptive)


def test_pd_step_eps_test_matches_plain(dev):
    """The round's last ``pd_step`` with the ε test: its state equals
    ``pd_step_plain``'s on the active images; its ``err`` and flags equal
    ``eps_reduce_plain`` run on the partials the same launch wrote (flags
    exactly, err to 1e-5 relative).  Image 0 stays above ε², image 1
    moves 1e-2 as much and falls below, image 2 is at rest and image 3
    frozen."""
    cfg = FAST
    i0, i13, uv = _level(dev, 4, 37, 53)
    prep = warp_prep_plain(i13, i0, uv)
    g = torch.Generator(dev).manual_seed(3)
    p = 0.3 * torch.randn((4, 4, 37, 53), device=dev, generator=g)
    uv[1] *= 1e-2
    p[1] *= 1e-2
    prep[1, 3] *= 1e-2
    uv[2], p[2], prep[2, 3] = 0.0, 0.0, 0.0
    want_uv, want_p, want_err = ts.pd_step_plain(prep, uv, p, cfg, True)
    assert want_err[1] < 0.5 * want_err[0]
    eps = float((want_err[0] * want_err[1]).double().sqrt().sqrt())
    cfg = dataclasses.replace(cfg, epsilon=eps)
    active = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    before = active.clone()
    uv_out, p_out = torch.empty_like(uv), torch.empty_like(p)
    partial = torch.full((4, ts.pd_blocks(37, 53)), float("nan"), device=dev)
    count = torch.zeros(4, dtype=torch.int32, device=dev)
    err = torch.full((4,), float("inf"), device=dev)
    n = ts.pd_step.launches, ts.pd_step.launches_test
    ts.pd_step(prep, uv, p, active, cfg, uv_out, p_out, partial, count, err)
    assert (ts.pd_step.launches, ts.pd_step.launches_test) == (n[0] + 1,
                                                              n[1] + 1)
    assert torch.equal(uv_out[:3], want_uv[:3])
    assert torch.equal(uv_out[3], uv[3])
    assert torch.equal(p_out[:3], want_p[:3])
    assert not count.any()
    flags, errs = before.clone(), torch.full((4,), float("inf"), device=dev)
    ts.eps_reduce_plain(partial, flags, errs, 37 * 53, eps)
    assert torch.equal(active, flags)
    assert active.tolist() == [1, 0, 0, 0]
    assert err[3] == float("inf") and err[2] == 0.0
    assert ((err[:2] - errs[:2]).abs() <= 1e-5 * errs[:2].abs()).all()
    with pytest.raises(ValueError, match="together"):
        ts.pd_step(prep, uv, p, active, cfg, uv_out, p_out, None, count, err)


def test_solvers_launch_no_separate_test_kernel(dev):
    """A whole ``pd_solve_chunked`` and a whole ``pd_solve`` run their
    rounds' tests inside their solver launches: the library has no test
    kernel of its own, the profile shows only the solver's kernels, and
    the counts are the solver's launches alone."""
    from torch.profiler import ProfilerActivity, profile

    from video_analytics_tpu_torch.ops.cuda import _build
    lib = _build.library()
    assert not hasattr(lib, "va_band_flags")
    assert not hasattr(lib, "va_eps_reduce")
    cfg = dataclasses.replace(FAST, epsilon=0.05, inner_iterations=7)
    i0, i13, uv = _level(dev, 2, 150, 131)
    prep = warp_prep_plain(i13, i0, uv)
    band, chunk = 2 * ts.chunk_tile(3, cfg)[0], 3
    runs = [(lambda: ts.pd_solve_chunked(prep, uv, cfg, band, chunk),
             {"pd_chunk_kernel"}),
            (lambda: ts.pd_solve(prep, uv, cfg),
             {"pd_step_kernel", "median_kernel"})]
    for solve, kernels in runs:
        solve()
        n = (ts.pd_chunk.launches, ts.pd_chunk.launches_test,
             ts.pd_step.launches, ts.pd_step.launches_test,
             ts.median5.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
        names = {ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
        ours = {k for k in ("pd_chunk_kernel", "pd_step_kernel",
                            "median_kernel", "band_flags_kernel",
                            "eps_reduce_kernel")
                if any(k in name for name in names)}
        assert ours <= kernels, names
        rounds = cfg.outer_iterations
        got = (ts.pd_chunk.launches - n[0], ts.pd_chunk.launches_test - n[1],
               ts.pd_step.launches - n[2], ts.pd_step.launches_test - n[3],
               ts.median5.launches - n[4])
        if "pd_chunk_kernel" in kernels:
            assert got == (rounds * -(-cfg.inner_iterations // chunk),
                           rounds - 1, 0, 0, 0)
        else:
            assert got == (0, 0, rounds * cfg.inner_iterations, rounds - 1,
                           rounds)


# -- tvl1_scale: every warp of one pyramid scale in one launch ----------------

def _chain_scale(i13, i0, uv, cfg):
    """One scale as the per-iteration chain: K-A and K-B per warp, then
    K-C."""
    for _ in range(cfg.warps):
        uv = ts.pd_solve(warp_prep(i13, i0, uv), uv, cfg)
    if cfg.median_filtering > 1:
        uv = ts.median5(uv, cfg.median_filtering)
    return uv


@pytest.mark.parametrize("k", [0, 3, 5])
@pytest.mark.parametrize("b,h,w", [
    (1, 37, 53),         # strips of 5 rows, the last of 2
    (3, 17, 40),         # strips of 3, 3, 3, 3, 3, 2 and two empty ones
    (45, 19, 23),        # more clusters than the card holds; a 1-row strip
    (2, 150, 201),       # 10 pixels a thread in registers
    (1, 248, 296),       # constants in scratch, read back through L2
    (1, 240, 320),       # 16-block clusters: strips of 15 rows
    (2, 280, 300),       # 16-block clusters: strips of 18 rows
])
def test_pd_solve_scale_matches_plain(dev, b, h, w, k):
    """The whole-scale launch against its plain version and against the
    per-iteration chain it replaces.  ε = 0: bit for bit.  With the test
    engaged, in the size rule's clusters and in those chosen for the
    batch, a round may flip at the threshold on the order of the ε sum,
    which moves the flow by less than 10·ε a warp from either."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, median_filtering=k,
                              outer_iterations=2, warps=3)
    i0, i13, uv = _level(dev, b, h, w)
    rounds = torch.zeros((b, 3), dtype=torch.int32, device=dev)
    before = (ts.pd_solve_scale.launches, warp_prep.launches,
              ts.pd_step.launches, ts.median5.launches)
    got = ts.pd_solve_scale(i13, i0, uv, cfg, rounds)
    assert (ts.pd_solve_scale.launches, warp_prep.launches,
            ts.pd_step.launches, ts.median5.launches) \
        == (before[0] + 1,) + before[1:]
    assert torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, cfg))
    assert torch.equal(got, _chain_scale(i13, i0, uv, cfg))
    assert (rounds == 2).all()
    one = dataclasses.replace(cfg, warps=1)
    assert torch.equal(ts.pd_solve_scale(i13, i0, uv, one),
                       _chain_scale(i13, i0, uv, one))
    # No warp: the scale is its closing median, through K-C.
    none = dataclasses.replace(cfg, warps=0)
    n = ts.pd_solve_scale.launches
    assert torch.equal(ts.pd_solve_scale(i13, i0, uv, none),
                       ts.pd_solve_scale_plain(i13, i0, uv, none))
    assert ts.pd_solve_scale.launches == n
    gated = dataclasses.replace(cfg, epsilon=0.05, outer_iterations=6)
    want = ts.pd_solve_scale_plain(i13, i0, uv, gated)
    chain = _chain_scale(i13, i0, uv, gated)
    # In the size rule's clusters, and in those chosen for the batch (45
    # images of 19x23 take fewer blocks than 8, so fewer passes).
    for blocks in (ts.warp_geometry(h, w)[3], None):
        got = ts.pd_solve_scale(i13, i0, uv, gated, rounds, blocks)
        for ref in (want, chain):
            assert (got - ref).abs().max().item() <= 10 * gated.epsilon * 3
        assert ((rounds >= 1) & (rounds <= 6)).all()


def test_pd_solve_scale_refuses_what_it_cannot_launch(dev):
    cfg = TVL1Config()
    z = lambda *shape: torch.zeros(shape, device=dev)
    n = ts.pd_solve_scale.launches
    with pytest.raises(ValueError, match="does not fit"):
        ts.pd_solve_scale(z(1, 3, 20, 4000), z(1, 20, 4000),
                          z(1, 2, 20, 4000), cfg)
    with pytest.raises(ValueError, match="dtype"):
        ts.pd_solve_scale(z(1, 3, 32, 32).double(), z(1, 32, 32),
                          z(1, 2, 32, 32), cfg)
    with pytest.raises(ValueError, match="shape"):
        ts.pd_solve_scale(z(1, 4, 32, 32), z(1, 32, 32), z(1, 2, 32, 32), cfg)
    with pytest.raises(ValueError, match="on cpu"):
        ts.pd_solve_scale(z(1, 3, 32, 32), z(1, 32, 32).cpu(),
                          z(1, 2, 32, 32), cfg)
    with pytest.raises(ValueError, match="median"):
        ts.pd_solve_scale(z(1, 3, 32, 32), z(1, 32, 32), z(1, 2, 32, 32),
                          TVL1Config(median_filtering=7))
    with pytest.raises(ValueError, match="rounds"):
        ts.pd_solve_scale(z(1, 3, 32, 32), z(1, 32, 32), z(1, 2, 32, 32), cfg,
                          torch.zeros(1, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="H, W >= 2"):
        ts.pd_solve_scale(z(1, 3, 1, 32), z(1, 1, 32), z(1, 2, 1, 32), cfg)
    assert ts.pd_solve_scale.launches == n


@pytest.mark.parametrize("h,w", [(224, 224), (179, 179), (143, 143),
                                 (115, 115), (92, 92), (240, 320)])
def test_pd_solve_scale_at_every_cluster_size(dev, h, w):
    """The whole-scale launch forced to each cluster size whose strips fit
    (1, 2, 4, 8 or 16 blocks; the constants in shared memory or in the
    scratch as each size allows): at ε = 0 the plain version's flow to the
    bit, each launch counted under its size; a size that does not fit is
    refused before anything launches."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, outer_iterations=2)
    i0, i13, uv = _level(dev, 2, h, w)
    want = ts.pd_solve_scale_plain(i13, i0, uv, cfg)
    sizes = [c for c in (1, 2, 4, 8, 16)
             if ts.strip_geometry(h, w, c) is not None]
    assert ts.warp_geometry(h, w)[3] in sizes
    for c in sizes:
        n = ts.pd_solve_scale.launches_by_blocks.get(c, 0)
        got = ts.pd_solve_scale(i13, i0, uv, cfg, blocks=c)
        assert ts.pd_solve_scale.launches_by_blocks[c] == n + 1
        assert torch.equal(got, want), c
    n = ts.pd_solve_scale.launches
    for c in sorted({1, 2, 4, 8, 16} - set(sizes)) + [3]:
        with pytest.raises(ValueError, match=f"clusters of {c} blocks"):
            ts.pd_solve_scale(i13, i0, uv, cfg, blocks=c)
    assert ts.pd_solve_scale.launches == n


def test_va_pd_scale_refuses_a_cluster_its_strips_do_not_fit(dev):
    """The library itself refuses (cudaErrorInvalidValue, nothing
    launched) 224² in 4, 2 or 1 blocks, a size it does not take, and 92²
    in one block without the scratch its constants need there.  Its
    shared memory a block (``va_pd_scale_smem``) is ``strip_geometry``'s
    at every size, -1 where the strips do not fit."""
    from video_analytics_tpu_torch.ops.cuda import _build
    lib = _build.library()
    i0, i13, uv = _level(dev, 1, 224, 224)
    out, scratch = torch.full_like(uv, 7.0), torch.empty_like(i13)
    stream = torch.cuda.current_stream(dev).cuda_stream
    l_t, theta, taut = ts._solver_constants(FAST)

    def launch(h, w, blocks, scr):
        return lib.va_pd_scale(
            i13.data_ptr(), i0.data_ptr(), uv.data_ptr(), out.data_ptr(),
            None if scr is None else scr.data_ptr(), None, 1, h, w, blocks,
            1, 2, 1, 5, l_t, theta, taut, 0.0, stream)
    for h, w, blocks, scr in [(224, 224, 4, scratch), (224, 224, 2, scratch),
                              (224, 224, 1, scratch), (224, 224, 3, scratch),
                              (224, 224, 32, scratch), (92, 92, 1, None)]:
        assert launch(h, w, blocks, scr) == 1, (h, w, blocks)
    torch.cuda.synchronize()
    assert (out == 7.0).all()
    assert launch(224, 224, 8, None) == 0
    for h, w in [(224, 224), (92, 92), (256, 256), (240, 320), (20, 4000)]:
        for c in (1, 2, 3, 4, 8, 16, 32):
            geom = ts.strip_geometry(h, w, c)
            assert lib.va_pd_scale_smem(h, w, c) == \
                (-1 if geom is None else geom[2]), (h, w, c)


@pytest.mark.parametrize("batch", [120, 360])
def test_pd_solve_scale_at_eval_batches(dev, batch):
    """The batches ``eval-ucf101 --batched --batch-clips 8`` gives one
    ``tvl1`` call: 8 clips x 15 frame pairs, and x 3 windows with
    ``--windows 3``.  Every image at 224² (the finest level, 8-block
    clusters, a grid of 8 x batch blocks) with ``TVL1Config()`` at ε = 0:
    bit for bit against the plain version."""
    cfg = dataclasses.replace(TVL1Config(), epsilon=0.0)
    i0, i13, uv = _level(dev, batch, 224, 224)
    n = ts.pd_solve_scale.launches
    got = ts.pd_solve_scale(i13, i0, uv, cfg)
    assert ts.pd_solve_scale.launches == n + 1
    assert torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, cfg))


def test_wrappers_refuse_batches_past_the_grid(dev):
    """A batch that would put more than 65,535 blocks on a grid's y or z
    dimension is refused before anything launches."""
    from video_analytics_tpu_torch.ops.cuda import _build
    n = _build.GRID_YZ_MAX + 1
    z = lambda *shape: torch.zeros(shape, device=dev)
    taps = [1.0 / 3] * 3
    counts = lambda: (ts.pd_solve_scale.launches, warp_prep.launches,
                      ts.median5.launches,
                      fk.fb_prologue.launches, fk.fb_warp_neq.launches,
                      fk.fb_window_solve.launches, fk.fb_iteration.launches,
                      fk.sep_corr.launches)
    before = counts()
    calls = [
        lambda: ts.pd_solve_scale(z(n, 3, 8, 8), z(n, 8, 8), z(n, 2, 8, 8),
                                  FAST),
        lambda: warp_prep(z(n, 3, 8, 8), z(n, 8, 8), z(n, 2, 8, 8)),
        lambda: ts.median5(z(n // 2 + 1, 2, 8, 8), 5),
        lambda: fk.fb_prologue(z(n, 16, 16), 1.0, (16, 16), 5, 1.1),
        lambda: fk.fb_warp_neq(z(n, 5, 8, 8), z(n, 5, 8, 8), z(n, 2, 8, 8)),
        lambda: fk.fb_window_solve(z(n, 5, 8, 8), taps),
        lambda: fk.fb_iteration(z(n, 5, 8, 8), z(n, 5, 8, 8), z(n, 2, 8, 8),
                                taps),
        lambda: fk.sep_corr(z(n // 5 + 1, 5, 8, 8), taps, 0)]
    for call in calls:
        with pytest.raises(ValueError, match="holds 65535"):
            call()
    assert counts() == before
    # At the limit the launch goes ahead.
    ts.median5(z(_build.GRID_YZ_MAX, 1, 8, 8), 3)
    assert ts.median5.launches == before[2] + 1


@pytest.mark.parametrize("h,w", [(240, 320), (280, 300)])
def test_sixteen_block_levels_match_the_chain(dev, h, w):
    """A level that fits no cluster of 8 takes one of 16: the whole-scale
    launch equals the per-iteration chain it replaces (K-A, K-B, ε, K-C)
    and the plain version at ε = 0, and ``tvl1`` there launches only
    ``tvl1_scale``, one per level."""
    assert ts.warp_geometry(h, w)[3] == 16
    cfg = dataclasses.replace(FAST, epsilon=0.0, outer_iterations=2)
    i0, i13, uv = _level(dev, 2, h, w)
    got = ts.pd_solve_scale(i13, i0, uv, cfg)
    chain = uv
    for _ in range(cfg.warps):
        chain = ts.pd_solve(warp_prep(i13, i0, chain), chain, cfg)
    chain = ts.median5(chain, cfg.median_filtering)
    assert torch.equal(got, chain)
    assert torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, cfg))
    p0, p1 = _images(dev, 2, h, w, seed=7)
    before = (ts.pd_solve_scale.launches, ts.pd_step.launches,
              warp_prep.launches)
    flow = tvl1(p0, p1, cfg)
    assert (ts.pd_solve_scale.launches - before[0], ts.pd_step.launches,
            warp_prep.launches) == (cfg.nscales, before[1], before[2])
    assert torch.equal(flow, tvl1(p0, p1, cfg, plain=True))


def test_level_of_no_cluster_takes_the_chain(dev):
    """20x4000 fits neither cluster size: K-A, K-B, ε and K-C there."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, nscales=2, warps=1,
                              outer_iterations=2)
    p0, p1 = _images(dev, 1, 20, 4000, seed=8)
    n = ts.pd_step.launches, ts.pd_solve_scale.launches
    flow = tvl1(p0, p1, cfg)
    assert ts.pd_step.launches - n[0] == 2 * cfg.inner_iterations
    assert ts.pd_solve_scale.launches - n[1] == 1
    assert torch.equal(flow, tvl1(p0, p1, cfg, plain=True))


# -- the Farneback kernels (K-D, K-E, K-F) ----------------------------------
# Each holds a row of the TPU kernel table (fb_window_solve and
# fb_iteration below hold corr_solve_from_T_pallas and one iteration of
# farneback_level_pallas): K-D poly_prologue_pallas /
# poly_expansion_pallas; K-E the warp + normal-equation halves of
# _neq_corr_axis, warp_neq_corr_pallas, corr_solve_warp_from_T_pallas,
# warp_emit_T_pallas, farneback_level_pallas; K-F _sep_corr_axis and the
# average + solve halves of the same and corr_solve_from_T_pallas.

@pytest.mark.parametrize("hw,scale,out_hw,poly", [
    ((37, 53), 1.0, (37, 53), (5, 1.2)),       # finest level, ragged
    ((96, 128), 0.5, (48, 64), (5, 1.2)),      # exact halving
    ((96, 128), 0.25, (24, 32), (7, 1.5)),     # quartering, poly_n 7
    ((67, 93), 0.5, (34, 46), (5, 1.2)),       # odd size, rounded level
    ((67, 93), 0.6, (40, 56), (5, 1.2)),       # not a 2^k divisor
    ((40, 64), 0.5, (40, 32), (5, 1.2)),       # one axis keeps its size
])
def test_fb_prologue_matches_plain(dev, hw, scale, out_hw, poly):
    frames, _ = _images(dev, 3, *hw, seed=2)
    n = fk.fb_prologue.launches
    got = fk.fb_prologue(frames, scale, out_hw, *poly)
    assert fk.fb_prologue.launches == n + 1
    want = fk.fb_prologue_plain(frames, scale, out_hw, *poly)
    assert got.shape == want.shape == (3, 5, *out_hw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw,scale,out_hw", [
    ((128, 160), 1 / 16, (8, 10)),        # 39 blur taps
    ((200, 240), 1 / 32, (6, 8)),         # 79 blur taps
    ((1080, 1920), 1 / 16, (68, 120)),    # 39 taps, the two-launch form
    ((1080, 1920), 1 / 32, (34, 60)),     # 79 taps, the two-launch form
])
def test_fb_prologue_long_blurs_match_plain(dev, hw, scale, out_hw):
    frames, _ = _images(dev, 2, *hw, seed=4)
    assert len(fk._smooth_taps(scale)) in (39, 79)
    got = fk.fb_prologue(frames, scale, out_hw, 5, 1.2)
    assert torch.equal(got, fk.fb_prologue_plain(frames, scale, out_hw, 5,
                                                 1.2))


@pytest.mark.parametrize("hw,scale,out_hw", [
    ((37, 53), 1.0, (37, 53)), ((96, 128), 0.25, (24, 32)),
    ((67, 93), 0.6, (40, 56)), ((40, 64), 0.5, (40, 32)),
    ((128, 160), 1 / 16, (8, 10))])
def test_fb_prologue_two_launch_form_matches_plain(dev, hw, scale, out_hw,
                                                   monkeypatch):
    """The two-launch form at ragged shapes where the rule would fuse."""
    monkeypatch.setattr(fk, "prologue_form", lambda *a: ("split", 0))
    frames, _ = _images(dev, 3, *hw, seed=5)
    n = fk.fb_prologue.launches_blur
    got = fk.fb_prologue(frames, scale, out_hw, 7, 1.5)
    assert fk.fb_prologue.launches_blur == n + 1
    assert torch.equal(got, fk.fb_prologue_plain(frames, scale, out_hw, 7,
                                                 1.5))


@pytest.mark.parametrize("winsize", [33, 75, 201, 1401])
def test_long_windows_match_plain(dev, winsize):
    """Every window length runs on kernels (``window_route``), each of the
    three compositions equal to the plain iteration."""
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps
    taps = farneback_window_taps(winsize, False)
    R0, R1 = _expansions(dev, 2, 70, 130)
    g = torch.Generator(dev).manual_seed(winsize)
    flow = 3.0 * torch.randn((2, 2, 70, 130), device=dev, generator=g)
    want = fk.fb_iteration_plain(R0, R1, flow, taps)
    route = fk.window_route(winsize)
    n = (fk.fb_iteration.launches, fk.fb_window_solve.launches,
         fk.sep_corr.launches)
    assert torch.equal(fk.fb_iterate(R0, R1, flow, taps), want)
    assert (fk.fb_iteration.launches - n[0], fk.fb_window_solve.launches
            - n[1], fk.sep_corr.launches - n[2]) == {
        "iteration": (1, 0, 0), "window_solve": (0, 1, 0),
        "sep_corr": (0, 0, 2)}[route]
    M = fk.fb_warp_neq(R0, R1, flow)
    assert torch.equal(
        fk.sep_corr(fk.sep_corr(M, taps, 0), taps, 1, solve=True), want)
    if route != "sep_corr":
        assert torch.equal(fk.fb_window_solve(M, taps), want)
    if route == "iteration":
        assert torch.equal(fk.fb_iteration(R0, R1, flow, taps), want)


def test_farneback_beyond_31_taps_matches_plain(dev):
    """F2: a pyramid whose coarse level pre-blurs with 39 taps, and a
    33-tap window, on the kernels."""
    i0, i1 = _images(dev, 2, 512, 544, seed=9)
    for cfg in (FarnebackConfig(levels=4, iterations=2),
                FarnebackConfig(winsize=33, levels=2)):
        assert torch.equal(farneback(i0, i1, cfg),
                           farneback(i0, i1, cfg, plain=True))


def _expansions(dev, b, h, w, seed=3):
    i0, i1 = _images(dev, b, h, w, seed=seed)
    R0 = fk.fb_prologue_plain(i0, 1.0, (h, w), 5, 1.2)
    R1 = fk.fb_prologue_plain(i1, 1.0, (h, w), 5, 1.2)
    return R0.contiguous(), R1.contiguous()


@pytest.mark.parametrize("h,w", [(37, 53), (8, 9), (64, 32)])
def test_fb_warp_neq_matches_plain(dev, h, w):
    R0, R1 = _expansions(dev, 3, h, w)
    g = torch.Generator(dev).manual_seed(4)
    flow = 3.0 * torch.randn((3, 2, h, w), device=dev, generator=g)
    # Exact integers, the clamp and far out of bounds: floor(p + d) and
    # the gather's clamp read the same sum.
    flow[0, :, : h // 2] = torch.round(flow[0, :, : h // 2])
    flow[1, 0, :, :4] = -50.0
    flow[1, 1, -3:] = 50.0
    flow[2] = 0.0
    n = fk.fb_warp_neq.launches
    got = fk.fb_warp_neq(R0, R1, flow)
    assert fk.fb_warp_neq.launches == n + 1
    assert torch.equal(got, fk.fb_warp_neq_plain(R0, R1, flow))


@pytest.mark.parametrize("gaussian,winsize", [
    (False, 15), (True, 15), (False, 9), (True, 31), (False, 201),
    (True, 201), (False, 1401), (True, 1401), (False, 2001), (True, 2001)])
@pytest.mark.parametrize("axis", [0, 1])
def test_sep_corr_matches_plain(dev, axis, gaussian, winsize):
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps
    taps = farneback_window_taps(winsize, gaussian)
    R0, R1 = _expansions(dev, 2, 37, 53)
    M = fk.fb_warp_neq_plain(R0, R1, torch.zeros((2, 2, 37, 53), device=dev))
    n, n_solve = fk.sep_corr.launches, fk.sep_corr.launches_solve
    assert torch.equal(fk.sep_corr(M, taps, axis),
                       fk.sep_corr_plain(M, taps, axis))
    assert torch.equal(fk.sep_corr(M[:, :3].contiguous(), taps, axis),
                       fk.sep_corr_plain(M[:, :3], taps, axis))
    got = fk.sep_corr(M, taps, axis, solve=True)
    assert fk.sep_corr.launches == n + 3
    assert fk.sep_corr.launches_solve == n_solve + 1
    assert got.shape == (2, 2, 37, 53)
    assert torch.equal(got, fk.sep_corr_plain(M, taps, axis, solve=True))


@pytest.mark.parametrize("b,h,w", [(3, 540, 960), (2, 135, 240),
                                   (1, 300, 7)])
@pytest.mark.parametrize("winsize", [201, 1401])
def test_sep_corr_large_planes_match_plain(dev, b, h, w, winsize):
    """Planes of many blocks along and across the axis, at both of the
    kernel's outputs-per-thread (the grid at 540x960 gives every SM four
    blocks, the 1/8 level of 1080p does not), with and without the solve."""
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps
    g = torch.Generator(dev).manual_seed(h + winsize)
    M = torch.randn((b, 5, h, w), device=dev, generator=g)
    M[:, :3] = M[:, :3].abs()
    taps = farneback_window_taps(winsize, True)
    for axis in (0, 1):
        assert torch.equal(fk.sep_corr(M, taps, axis),
                           fk.sep_corr_plain(M, taps, axis))
        assert torch.equal(fk.sep_corr(M, taps, axis, solve=True),
                           fk.sep_corr_plain(M, taps, axis, solve=True))


@pytest.mark.parametrize("gaussian,winsize", [(False, 15), (True, 15),
                                              (False, 9), (True, 31)])
@pytest.mark.parametrize("h,w", [(37, 53), (8, 9), (64, 32), (5, 6),
                                 (70, 130)])
def test_fb_window_solve_matches_two_launches(dev, h, w, gaussian, winsize):
    """Both window passes and the solve in one launch: to the bit what the
    two launches of ``sep_corr`` give, also where the plane is smaller
    than the window's halo ((5, 6)) and where it spans several tiles."""
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps
    taps = farneback_window_taps(winsize, gaussian)
    g = torch.Generator(dev).manual_seed(h * w)
    M = torch.randn((3, 5, h, w), device=dev, generator=g)
    M[:, :3] = M[:, :3].abs()
    n = fk.fb_window_solve.launches
    got = fk.fb_window_solve(M, taps)
    assert fk.fb_window_solve.launches == n + 1
    assert got.shape == (3, 2, h, w)
    two = fk.sep_corr(fk.sep_corr(M, taps, 0), taps, 1, solve=True)
    assert torch.equal(got, two)
    assert torch.equal(got, fk.fb_window_solve_plain(M, taps))


@pytest.mark.parametrize("h,w", [(37, 53), (8, 9), (64, 32), (70, 130)])
def test_fb_iteration_matches_two_launches(dev, h, w):
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps
    taps = farneback_window_taps(15, False)
    R0, R1 = _expansions(dev, 3, h, w)
    g = torch.Generator(dev).manual_seed(4)
    flow = 3.0 * torch.randn((3, 2, h, w), device=dev, generator=g)
    flow[0, :, : h // 2] = torch.round(flow[0, :, : h // 2])
    flow[1, 0, :, :4] = -50.0
    flow[1, 1, -3:] = 50.0
    flow[2] = 0.0
    n = fk.fb_iteration.launches
    got = fk.fb_iteration(R0, R1, flow, taps)
    assert fk.fb_iteration.launches == n + 1
    assert torch.equal(
        got, fk.fb_window_solve(fk.fb_warp_neq(R0, R1, flow), taps))
    assert torch.equal(got, fk.fb_iteration_plain(R0, R1, flow, taps))


def test_fb_window_solve_refuses_what_it_cannot_launch(dev):
    M = torch.zeros((2, 5, 16, 24), device=dev)
    flow = torch.zeros((2, 2, 16, 24), device=dev)
    n = fk.fb_window_solve.launches, fk.fb_iteration.launches
    with pytest.raises(ValueError, match="odd number of taps"):
        fk.fb_window_solve(M, [0.5, 0.5])
    with pytest.raises(ValueError, match="shared memory"):
        fk.fb_window_solve(M, [1.0 / 195] * 195)
    with pytest.raises(ValueError, match="shared memory"):
        fk.fb_iteration(M, M, flow, [1.0 / 75] * 75)
    with pytest.raises(ValueError, match="shape"):
        fk.fb_window_solve(flow, [1.0])
    with pytest.raises(ValueError, match="dtype"):
        fk.fb_window_solve(M.double(), [1.0])
    with pytest.raises(ValueError, match="on cpu"):
        fk.fb_iteration(M, M.cpu(), flow, [1.0])
    with pytest.raises(ValueError, match="h, w >= 2"):
        fk.fb_iteration(M[:, :, :1].contiguous(), M[:, :, :1].contiguous(),
                        flow[:, :, :1].contiguous(), [1.0])
    assert (fk.fb_window_solve.launches, fk.fb_iteration.launches) == n


@pytest.mark.parametrize("kw", [{}, {"poly_n": 7, "poly_sigma": 1.5},
                                {"gaussian_window": True, "winsize": 9},
                                {"pyr_scale": 0.6}])
def test_farneback_kernels_match_plain(dev, kw):
    cfg = FarnebackConfig(**kw)
    i0, i1 = _images(dev, 3, 67, 93, seed=6)
    got = farneback(i0, i1, cfg)
    assert torch.equal(got, farneback(i0, i1, cfg, plain=True))
    seq = torch.cat([i0[:1], i1])
    assert torch.equal(farneback_sequence(seq, cfg),
                       farneback(seq[:-1], seq[1:], cfg))


def test_farneback_wrappers_reject_bad_tensors(dev):
    R0, R1 = _expansions(dev, 2, 16, 24)
    flow = torch.zeros((2, 2, 16, 24), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fk.fb_warp_neq(R0.double(), R1, flow)
    with pytest.raises(ValueError, match="on cpu"):
        fk.fb_warp_neq(R0, R1.cpu(), flow)
    with pytest.raises(ValueError, match="odd number of taps"):
        fk.sep_corr(R0, [0.5, 0.5], 0)
    with pytest.raises(ValueError, match="C = 5"):
        fk.sep_corr(flow, [1.0], 1, solve=True)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fb_prologue(torch.zeros((2, 24, 16), device=dev).transpose(1, 2),
                       1.0, (16, 24), 5, 1.2)


# -- the training path --------------------------------------------------------

@pytest.mark.parametrize("algo", ["tvl1", "farneback"])
def test_build_examples_kernels_match_plain(dev, algo):
    """Both streams' examples of a batch of windows through the kernels
    equal those through their plain versions, with the launches of the
    sequence form: one ``tvl1_scale`` per pyramid scale, or per level one
    K-D and an ``fb_iteration`` per iteration."""
    from video_analytics_tpu_torch.config import (
        PipelineConfig, PreprocessConfig)
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    cfg = PipelineConfig(
        preprocess=PreprocessConfig(resize_short=36, crop=32, flow_stack=5,
                                    random_crop=True, random_flip=True),
        flow_algo=algo, tvl1=FAST,
        farneback=FarnebackConfig(levels=2, iterations=2, winsize=9))
    i0, _ = _images(dev, 6, 40, 56)
    frames = torch.stack([i0.roll(t, dims=2) for t in range(6)], dim=1)
    windows = frames[..., None].expand(-1, -1, -1, -1, 3).round().to(
        torch.uint8)
    crops = tts.draw_crops(torch.Generator().manual_seed(0), windows, cfg)
    counters = ([ts.pd_solve_scale] if algo == "tvl1"
                else [fk.fb_prologue, fk.fb_iteration])
    before = [c.launches for c in counters]
    got = tts.build_examples(windows, cfg, "both", crops)
    runs = [c.launches - b for c, b in zip(counters, before)]
    want = tts.build_examples(windows, cfg, "both", crops, plain=True)
    from video_analytics_tpu_torch.flow import farneback as fb_flow
    from video_analytics_tpu_torch.flow import tvl1 as tv_flow
    if algo == "tvl1":
        assert runs == [len(tv_flow._level_sizes(32, 32, FAST))]
    else:
        levels = len(fb_flow._level_sizes(32, 32, cfg.farneback))
        assert runs == [levels, levels * cfg.farneback.iterations]
    for k in ("rgb", "flow"):
        assert got[k].is_cuda and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("depth", [1, 2])
def test_device_prefetcher_exact_bytes_with_slow_consumer(dev, depth):
    """Batches of 48 MB through a prefetcher of depth 1 and 2: its pinned
    buffers are refilled many times while the consumer is slow and keeps
    the card busy; every batch arrives byte for byte."""
    import time

    from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher
    rng = np.random.default_rng(0)
    host = [rng.integers(0, 256, (16, 1024, 1024, 3), dtype=np.uint8)
            for _ in range(3)]
    n = 10

    def batches():
        for i in range(n):
            yield host[i % 3], np.int64(i), f"b{i}"

    pf = DevicePrefetcher(batches(), depth=depth, device=dev)
    got = 0
    a = torch.randn((2048, 2048), device=dev)
    for i, (x, j, name) in enumerate(pf):
        for _ in range(20):
            a = a @ a / 2048.0                    # keep the card busy
        time.sleep(0.02)
        assert x.is_cuda and int(j) == i and name == f"b{i}"
        assert torch.equal(x.cpu(), torch.from_numpy(host[i % 3]))
        got += 1
    assert got == n and pf.stats["batches"] == n


@pytest.mark.parametrize("shape", [(2, 57, 75), (3, 224, 224)])
def test_spynet_on_the_card_matches_the_cpu(dev, shape):
    """SpyNet on the bundled weights (cuDNN, float32, TF32 off) against
    the same network on the CPU: every level within 1e-4 px, at odd sizes
    and at the serve path's 224²; it reaches no hand-written kernel."""
    import copy

    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, default_spynet_checkpoint)
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables

    cpu_net = SpyNet(levels=4)
    cpu_net.load_flax_variables(load_variables(
        default_spynet_checkpoint(), cpu_net.flax_variables())).eval()
    net = copy.deepcopy(cpu_net).to(dev)
    b, h, w = shape
    prev, nxt = (t.cpu() for t in _images(dev, b, h, w, seed=4))
    ts.pd_solve_scale.launches = fk.fb_iteration.launches = 0
    with torch.no_grad():
        _, got = net(prev.to(dev), nxt.to(dev), train_all_levels=True)
        _, want = cpu_net(prev, nxt, train_all_levels=True)
    torch.cuda.synchronize()
    assert ts.pd_solve_scale.launches == fk.fb_iteration.launches == 0
    for g, c in zip(got, want):
        assert g.shape == c.shape
        assert float((g.cpu() - c).abs().max()) <= 1e-4


def test_async_checkpoint_stages_cuda_leaves(dev, tmp_path):
    """``AsyncCheckpointer.save`` of CUDA tensors: staged into pinned host
    buffers before it returns (the caller's next in-place change is not
    saved), and restored onto the card with each template leaf's dtype."""
    from video_analytics_tpu_torch.runtime.checkpoint import (
        AsyncCheckpointer)

    g = torch.Generator(dev).manual_seed(0)
    tree = {"w": torch.randn((1024, 513), device=dev, generator=g),
            "n": {"b": torch.arange(7, device=dev),
                  "h": torch.ones(3, dtype=torch.float16, device=dev)}}
    want = {"w": tree["w"].cpu(), "b": tree["n"]["b"].cpu()}
    path = str(tmp_path / "ck")
    with AsyncCheckpointer() as ck:
        ck.save(path, tree)
        tree["w"].add_(1.0)
        tree["n"]["b"].mul_(3)
        ck.wait()
        back = ck.restore(path, {"w": torch.zeros((1024, 513), device=dev),
                                 "n": {"b": torch.zeros(7, device=dev),
                                       "h": torch.zeros(3, device="cpu")}})
    assert back["w"].is_cuda and torch.equal(back["w"].cpu(), want["w"])
    assert back["n"]["b"].is_cuda and back["n"]["b"].dtype == torch.float32
    assert torch.equal(back["n"]["b"].cpu(), want["b"].float())
    assert back["n"]["h"].device.type == "cpu"
    assert torch.equal(back["n"]["h"], torch.ones(3))


# Kernels of cuDNN's float32 NCHW fallback for 3-D convolutions and its
# layout conversions around it.
FALLBACK_KERNELS = ("f32f32", "nchwToNhwc", "nhwcToNchw")
# BF16_REL of tests/test_torch_r2plus1d.py: bfloat16 R(2+1)D-34 logits
# against float32 ones, as a share of the largest.
R2P1D_BF16_REL = 0.015


def test_r2p1d_stage1_block_runs_no_fallback_kernel(dev):
    """A bfloat16 stage-1 ``VideoBasicBlock`` (64 channels, 144 midplanes,
    32×56², channels-last-3d) launches only bfloat16 channels-last
    convolutions: its 3×1×1 convolutions take ``Conv3d``'s 2-D route."""
    from torch.profiler import ProfilerActivity, profile

    from video_analytics_tpu_torch.models.video_resnet import (
        VideoBasicBlock)
    from video_analytics_tpu_torch.ops.layers import Conv3d

    block = VideoBasicBlock(64, 64, dtype=torch.bfloat16).to(dev).eval()
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((4, 64, 32, 56, 56), device=dev, dtype=torch.bfloat16,
                    generator=g).contiguous(
                        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        block(x)
        torch.cuda.synchronize()
        before = Conv3d.as_conv2d
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = block(x)
            torch.cuda.synchronize()
    assert Conv3d.as_conv2d - before == 2
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler recorded no kernel"
    slow = [n for n in names if any(k in n for k in FALLBACK_KERNELS)]
    assert not slow, slow


def test_r2p1d_logits_on_the_card_equal_the_3d_call(dev, monkeypatch):
    """A narrow bfloat16 R(2+1)D-34 on 112² clips on the card, its stem's
    and stage 1's temporal convolutions on the 2-D route, against the same
    network with every convolution as ``nn.Conv3d``'s own 3-D call:
    within the bfloat16 tolerance the CPU tests hold it to against the
    float32 reference."""
    import torch.nn as nn

    from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34
    from video_analytics_tpu_torch.ops.layers import Conv3d

    model = r2plus1d_34(7, width=8, dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.randn(2, 8, 112, 112, 3, generator=torch.Generator()
                    .manual_seed(1)).to(dev)
    before = Conv3d.as_conv2d
    with torch.no_grad():
        got = model(x)
    assert Conv3d.as_conv2d - before == 7
    monkeypatch.setattr(Conv3d, "_conv_forward", nn.Conv3d._conv_forward)
    with torch.no_grad():
        want = model(x)
    assert Conv3d.as_conv2d - before == 7
    scale = want.abs().max()
    assert scale > 0.05
    assert (got - want).abs().max() <= R2P1D_BF16_REL * scale


# Every channel count R(2+1)D-34 and ResNet-18 normalise: widths 64-512,
# the stem's 45, the midplanes 144-1152.
BN_CHANNELS = [45, 64, 128, 144, 230, 256, 288, 460, 512, 576, 921, 1152]
# (residual, relu): the kernel's forms; a residual add is always followed
# by the ReLU.
BN_CASES = [(False, False), (False, True), (True, True)]


def _bn_inputs(dev, shape, dtype, seed=0):
    """A channels-last activation of `shape`, a residual like it and a
    BatchNorm's (mean, var, weight, bias, eps) away from the identity."""
    g = torch.Generator(dev).manual_seed(seed)
    C = shape[1]
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d

    def act():
        return (3 * torch.randn(shape, device=dev, generator=g)).to(
            dtype).contiguous(memory_format=fmt)

    def par(lo, hi):
        return torch.empty(C, device=dev).uniform_(lo, hi, generator=g)

    return (act(), act(),
            (par(-1, 1), par(0.5, 2), par(-1.5, 1.5), par(-1, 1), 1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rank", [4, 5])
@pytest.mark.parametrize("C", BN_CHANNELS)
def test_bn_act_matches_plain(dev, C, rank, dtype):
    """Bit for bit at every channel count, on 105 rows (an odd count, so
    an odd C leaves a tail of elements past the last 16-byte vector)."""
    from video_analytics_tpu_torch.ops.cuda.bn_act import (
        bn_act, bn_act_plain)

    shape = (3, C, 5, 7) if rank == 4 else (1, C, 3, 5, 7)
    x, r, params = _bn_inputs(dev, shape, dtype, seed=C)
    for residual, relu in BN_CASES:
        res = r if residual else None
        want = bn_act_plain(x, *params, res, relu)
        n, nr = bn_act.launches, bn_act.launches_residual
        y = x.clone()
        got = bn_act(y, *params, res, relu)
        assert got is y
        assert bn_act.launches == n + 1
        assert bn_act.launches_residual == nr + int(residual)
        assert torch.equal(got, want), (residual, relu)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 144, 8, 56, 56), (2, 921, 4, 14, 15),
                                   (5, 45, 3, 17, 19), (4, 230, 29, 31)])
def test_bn_act_matches_plain_on_large_tensors(dev, shape, dtype):
    """Tensors with more vectors than the grid has threads, so every
    thread walks several strides of the period."""
    from video_analytics_tpu_torch.ops.cuda.bn_act import (
        bn_act, bn_act_plain)

    x, r, params = _bn_inputs(dev, shape, dtype, seed=len(shape))
    for residual, relu in BN_CASES:
        res = r if residual else None
        want = bn_act_plain(x, *params, res, relu)
        assert torch.equal(bn_act(x.clone(), *params, res, relu), want)


@pytest.mark.parametrize("rank", [4, 5])
@pytest.mark.parametrize("residual,relu", BN_CASES)
def test_bn_act_keeps_one_ulp_of_aten(dev, rank, residual, relu):
    """Against the module path it replaces on the card (eval BatchNorm,
    ATen's add and ReLU) in bfloat16: within one bfloat16 ulp of the
    largest operand of each element (ATen's kernel may fuse a multiply-add
    where the kernel rounds twice), and equal almost everywhere."""
    import torch.nn as nn

    from video_analytics_tpu_torch.ops.cuda.bn_act import bn_act

    shape = (4, 144, 9, 15) if rank == 4 else (2, 144, 3, 9, 15)
    x, r, (mean, var, w, b, eps) = _bn_inputs(dev, shape, torch.bfloat16, 7)
    norm = (nn.BatchNorm2d if rank == 4 else nn.BatchNorm3d)(144).to(dev)
    with torch.no_grad():
        for buf, val in ((norm.running_mean, mean), (norm.running_var, var),
                         (norm.weight, w), (norm.bias, b)):
            buf.copy_(val)
        norm.eval()
        res = r if residual else None
        want = norm(x)
        if residual:
            want = want + res
        want = (torch.relu(want) if relu else want).float()
        got = bn_act(x.clone(), mean, var, w, b, eps, res, relu).float()
    per = (1, -1) + (1,) * (rank - 2)
    largest = torch.maximum(
        ((x.float() - mean.view(per)) * torch.rsqrt(var + eps).view(per)
         * w.view(per)).abs(), b.view(per).abs())
    if residual:
        largest = torch.maximum(largest, r.float().abs())
    ulp = torch.ldexp(torch.ones_like(largest), torch.frexp(largest)[1] - 8)
    diff = (got - want).abs()
    assert (diff <= ulp).all(), diff.max()
    assert (diff == 0).float().mean() > 0.95


def test_bn_act_rejects_bad_tensors(dev):
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda.bn_act import bn_act

    x, r, params = _bn_inputs(dev, (2, 64, 3, 5, 7), torch.bfloat16)
    bad = [(x.contiguous(), params, None, True),      # not channels-last
           (x.half(), params, None, True),            # dtype
           (x, params, r.float(), True),              # residual dtype
           (x, params, r.contiguous(), True),         # residual strides
           (x, params, r, False),                     # residual, no ReLU
           (x, (params[0][:32],) + params[1:], None, True),  # mean's shape
           (x, (params[0].double(),) + params[1:], None, True),
           (x, (params[0].cpu(),) + params[1:], None, True)]
    for t, p, res, relu in bad:
        n = bn_act.launches
        with pytest.raises(ValueError):
            bn_act(t, *p, res, relu)
        assert bn_act.launches == n
    # The entry point refuses the form the kernel lacks on its own.
    mean, var, w, b, eps = params
    y = x.clone()
    err = _build.library().va_bn_act(
        y.data_ptr(), r.data_ptr(), mean.data_ptr(), var.data_ptr(),
        w.data_ptr(), b.data_ptr(), eps, y.numel(), 64, 1, 0,
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and torch.equal(y, x)


@pytest.mark.parametrize("arch,launches,residual", [
    ("r2plus1d_34", 69, 16), ("resnet18", 20, 8)])
def test_cnn_stream_runs_every_norm_as_bn_act(dev, arch, launches, residual):
    """One eval forward of a bfloat16 stream on the card launches the fused
    norm pass at each of its BatchNorms (R(2+1)D-34: 69, 16 with the
    block's residual; ResNet-18: 20 and 8), and no ATen batch-norm or
    clamp kernel."""
    from torch.profiler import ProfilerActivity, profile

    from video_analytics_tpu_torch.models.resnet import resnet18
    from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34
    from video_analytics_tpu_torch.ops.cuda.bn_act import bn_act

    if arch == "resnet18":
        model = resnet18(7, dtype=torch.bfloat16)
        x = torch.randn(2, 64, 64, 3)
    else:
        model = r2plus1d_34(7, width=16, dtype=torch.bfloat16)
        x = torch.randn(2, 8, 32, 32, 3)
    model.init(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = x.to(dev)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        n, nr = bn_act.launches, bn_act.launches_residual
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    assert (bn_act.launches - n, bn_act.launches_residual - nr) == (
        launches, residual)
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("bn_act_kernel" in k for k in names) == launches
    aten = [k for k in names if "batch_norm" in k or "clamp" in k]
    assert not aten, aten


# Kernel names that look like attention's: chip_smoke.py's SDPA_MARKS.
SDPA_MARKS = ("sdpa", "flash", "fmha", "attention", "attn", "softmax")
# (L, heads) of the short-sequence kernel's tests: 1 token (every weight
# 1), odd counts and the time half's 8 within one 8-key block, 13 and 16
# in two (one tile of queries), 24 in three and the longest 32 in four
# (two tiles); 1 head (three warps of the block idle), 12 and 16 (three
# and four heads a warp).
SHORT_ATTN_SHAPES = [(L, heads) for L in (1, 2, 7, 8, 13, 16, 24, 32)
                     for heads in (1, 12, 16)]


def _short_attn_inputs(dev, B, L, heads, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    W = 3 * 64 * heads
    y = torch.randn((B, L, W), device=dev, generator=g).to(torch.bfloat16)
    bias = 0.3 * torch.randn(W, device=dev, generator=g)
    return y, bias


def _short_attn_errors(y, bias, heads, got):
    """(whether every element of `got` is within one bfloat16 ulp of the
    float64 attention of the same rounded operands, `got`'s largest error,
    SDPA's largest error on those operands); the ulp is taken at no less
    than 2^-12 of the element's Σ_j w_ij·|v_j|, as
    tests/test_torch_short_attn.within_one_ulp takes it."""
    import torch.nn.functional as F

    B, L, W = y.shape
    D = W // 3
    qkv = (y.float() + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
    q, k, v = qkv.view(B, L, 3, heads, 64).permute(2, 0, 3, 1, 4)
    w = torch.softmax(q.double() @ k.double().transpose(-1, -2) * 0.125, -1)
    want = (w @ v.double()).transpose(1, 2).reshape(B, L, D)
    terms = (w @ v.double().abs()).transpose(1, 2).reshape(B, L, D)
    at = torch.maximum(want.abs(), terms * 2.0 ** -12)
    ulp = torch.ldexp(torch.ones_like(at), torch.frexp(at)[1] - 8)
    err = (got.double() - want).abs()
    with torch.no_grad():
        sdpa = F.scaled_dot_product_attention(q, k, v).transpose(1, 2
                                                                 ).reshape(
            B, L, D)
    return (bool((err <= ulp).all()), float(err.max()),
            float((sdpa.double() - want).abs().max()))


@pytest.mark.parametrize("B,L,heads", [(64, L, heads)
                                        for L, heads in SHORT_ATTN_SHAPES]
                         + [(3136, 8, 12)])
def test_short_attn_is_within_one_ulp_and_no_worse_than_sdpa(dev, B, L,
                                                              heads):
    """Every output within one bfloat16 ulp of the float64 attention, and
    the largest error no larger than SDPA's on the same operands; the last
    case at the time half's full shape, 3136 sequences of 8 tokens at 768
    widths."""
    from video_analytics_tpu_torch.ops.cuda.short_attn import short_attn

    y, bias = _short_attn_inputs(dev, B, L, heads, seed=L * 17 + heads)
    n = short_attn.launches
    got = short_attn(y, bias, heads)
    torch.cuda.synchronize()
    assert short_attn.launches == n + 1
    assert got.shape == (B, L, 64 * heads) and got.is_contiguous()
    ok, err, sdpa_err = _short_attn_errors(y, bias, heads, got)
    assert ok, (err, sdpa_err)
    assert err <= sdpa_err, (err, sdpa_err)


def test_short_attn_adds_the_bias_with_two_roundings(dev):
    """At L = 1 every weight is 1: the output is the v third of
    round(y + round(bias)) bit for bit (-0 + 0 gives +0), and not that of
    the one rounding round(y + bias)."""
    from video_analytics_tpu_torch.ops.cuda.short_attn import (
        short_attn, short_attn_plain)

    y, bias = _short_attn_inputs(dev, 300, 1, 12, seed=3)
    y[:7, 0, 1536:1600] = -0.0
    bias[1536:1600] = 0.0
    D = 768
    got = short_attn(y, bias, 12)
    want = (y.float() + bias.to(torch.bfloat16).float()).to(
        torch.bfloat16)[..., 2 * D:]
    once = (y.float() + bias).to(torch.bfloat16)[..., 2 * D:]
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16),
                       short_attn_plain(y, bias, 12).view(torch.int16))
    assert not torch.equal(got, once)


def test_short_attn_rejects_bad_tensors(dev):
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda.short_attn import short_attn

    y, bias = _short_attn_inputs(dev, 4, 8, 12)
    long = torch.cat([y] * 4 + [y[:, :1]], 1)
    bad = [(y.float(), bias, 12),                   # dtype
           (long, bias, 12),                        # 33 tokens
           (y, bias, 24),                           # heads of 32
           (y.transpose(0, 1).contiguous().transpose(0, 1), bias, 12),
           (y, bias.double(), 12),                  # bias dtype
           (y, bias[:768], 12),                     # bias shape
           (y, bias.cpu(), 12),                     # bias device
           (y, bias.clone().requires_grad_(), 12)]  # autograd on
    for t, b, heads in bad:
        n = short_attn.launches
        with pytest.raises(ValueError):
            short_attn(t, b, heads)
        assert short_attn.launches == n
    # The entry point refuses 33 tokens on its own.
    out = torch.empty((4, 33, 768), dtype=torch.bfloat16, device=dev)
    err = _build.library().va_short_attn(
        long.data_ptr(), bias.data_ptr(), out.data_ptr(), 4, 33, 12,
        torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def test_time_half_launches_short_attn_and_no_sdpa(dev):
    """A full-width bfloat16 TimeSformer block: its time half launches the
    short-sequence kernel and no kernel that looks like SDPA's; its space
    half (197 tokens) still launches SDPA's."""
    from video_analytics_tpu_torch.models.timesformer import Block
    from video_analytics_tpu_torch.ops.cuda.short_attn import short_attn

    blk = Block(768, 12, 3072, torch.bfloat16).to(dev).eval()
    g = torch.Generator(dev).manual_seed(0)
    h = torch.randn((2 * 196, 8, 768), device=dev, generator=g).to(
        torch.bfloat16)
    s = torch.randn((2 * 8, 197, 768), device=dev, generator=g).to(
        torch.bfloat16)
    n = short_attn.launches
    time_names = _kernel_names(lambda: blk.temporal_attn(h))
    assert short_attn.launches == n + 2
    space_names = _kernel_names(lambda: blk.attn(s))
    assert short_attn.launches == n + 2
    assert sum("short_mha_kernel" in k for k in time_names) == 1
    sdpa = [k for k in time_names if any(m in k.lower() for m in SDPA_MARKS)]
    assert not sdpa, sdpa
    assert any(any(m in k.lower() for m in SDPA_MARKS) for k in space_names)
    assert not any("short_mha_kernel" in k for k in space_names)


def test_short_attn_counts_twelve_a_stream(dev):
    """A full-width bfloat16 TimeSformer-Base stream's eval forward
    launches the kernel once a block (the time half), 12 in all; with
    autograd on it launches none."""
    from video_analytics_tpu_torch.models.timesformer import (
        TimeSformer, timesformer_base)
    from video_analytics_tpu_torch.ops.cuda.short_attn import short_attn

    net = timesformer_base(101, 2, dtype=torch.bfloat16)
    net.init(torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    x = torch.rand((1, 8, 224, 224, 2), device=dev) * 2 - 1
    n, calls = short_attn.launches, dict(TimeSformer.attn_calls)
    with torch.no_grad():
        logits = net(x)
    assert short_attn.launches - n == 12
    assert TimeSformer.attn_calls["time"] - calls["time"] == 12
    with torch.enable_grad():
        again = net(x)
    assert short_attn.launches - n == 12
    assert torch.isfinite(logits).all() and again.requires_grad


def test_video_swin_b_stream_equals_the_reference_at_published_widths(dev):
    """One clip of 32 frames at 224² through a bfloat16 Video Swin-B flow
    stream at published widths (tables of spread 4, so the relative
    position bias weighs in every block) against the float32 reference on
    the card, TF32 off: within the CPU tests' bfloat16 tolerance, 2 % of
    the largest logit (``tests/test_torch_video_swin.py``, ``BF16_REL``),
    12 unshifted and 12 shifted blocks and 3 merges."""
    import importlib.util
    import os

    from video_analytics_tpu_torch.models.video_swin import (
        VideoSwin, WindowAttention, video_swin_b)

    path = os.path.join(os.path.dirname(__file__), "torch_video_swin.py")
    spec = importlib.util.spec_from_file_location("torch_video_swin", path)
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)

    net = video_swin_b(101, 2, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    net.init(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, WindowAttention):
                m.relative_position_bias_table.normal_(0, 4, generator=g)
    net = net.to(dev).eval()
    x = torch.rand((1, 32, 224, 224, 2), device=dev,
                   generator=torch.Generator(dev).manual_seed(1)) * 2 - 1
    calls = dict(VideoSwin.calls)
    with torch.no_grad():
        got = net(x)
        want = plain.VideoSwin(net.state_dict())(x)
    assert {k: v - calls[k] for k, v in VideoSwin.calls.items()} == {
        "window": 12, "shifted": 12, "merge": 3}
    assert got.dtype == torch.float32 and got.shape == (1, 101)
    gap = float((got - want).abs().max() / want.abs().max())
    assert 0 < gap <= 0.02, gap
