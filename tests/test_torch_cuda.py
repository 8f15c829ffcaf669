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


@pytest.mark.parametrize("k", [3, 5])
def test_median5_bit_exact_with_mask(dev, k):
    _, _, uv = _level(dev, b=4)
    active = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=dev)
    for mask in (None, active):
        assert torch.equal(ts.median5(uv, k, mask),
                           ts.median5_plain(uv, k, mask))


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


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("b,h,w,band,n_part", [(1, 61, 96, 16, 6),
                                              (45, 40, 33, 40, 1),
                                              (3, 1080, 53, 24, 70)])
def test_band_flags_matches_plain(dev, b, h, w, band, n_part, adaptive):
    """Flags equal; the kept band sums to 1e-5 relative (their order
    differs).  Sums are drawn on both sides of the thresholds, none within
    rounding of one."""
    g = torch.Generator(dev).manual_seed(h + n_part)
    n_bands = -(-h // band)
    eps = 0.05
    scale = eps * eps * band * w
    partial = torch.rand((b, n_bands, n_part), device=dev,
                         generator=g) * (2 * scale / n_part)
    partial[0] *= 0.05
    act = (torch.rand((b, n_bands), device=dev, generator=g) < 0.7).to(
        torch.int32)
    old = torch.rand((b, n_bands), device=dev, generator=g) * 2 * scale
    old[-1, :1] = float("inf")
    act[-1, :1] = 0
    errs = [old.clone(), old.clone()]
    nxt = [torch.full_like(act, -1), torch.full_like(act, -1)]
    n = ts.band_flags.launches
    ts.band_flags(partial, act, errs[0], nxt[0], band, h, w, eps, adaptive)
    assert ts.band_flags.launches == n + 1
    ts.band_flags_plain(partial, act, errs[1], nxt[1], band, h, w, eps,
                        adaptive)
    assert torch.equal(nxt[0], nxt[1])
    finite = errs[1].isfinite()
    assert torch.equal(errs[0].isfinite(), finite)
    assert ((errs[0] - errs[1])[finite].abs()
            <= 1e-5 * errs[1][finite].abs()).all()
    with pytest.raises(ValueError, match="alias"):
        ts.band_flags(partial, act, errs[0], act, band, h, w, eps, adaptive)


# -- K-H: one warp in one launch, an image per thread-block cluster ----------

@pytest.mark.parametrize("k", [0, 3, 5])
@pytest.mark.parametrize("b,h,w", [
    (1, 37, 53),         # strips of 5 rows, the last of 2
    (3, 17, 40),         # strips of 3, 3, 3, 3, 3, 2 and two empty ones
    (45, 19, 23),        # more clusters than the card holds; a 1-row strip
    (2, 150, 201),       # 10 pixels a thread in registers
    (1, 248, 296),       # over 8,192 px a strip: constants through L2
])
def test_pd_solve_warp_matches_plain(dev, b, h, w, k):
    """ε = 0: bit for bit (same operations in the same order, no FMA
    contraction).  With the test engaged a round may flip at the threshold
    on the order of the sum, which moves the flow by less than 10·ε."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, median_filtering=k,
                              outer_iterations=2)
    i0, i13, uv = _level(dev, b, h, w)
    prep = warp_prep_plain(i13, i0, uv)
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    n = ts.pd_solve_warp.launches
    got = ts.pd_solve_warp(prep, uv, cfg, rounds)
    assert ts.pd_solve_warp.launches == n + 1
    assert torch.equal(got, ts.pd_solve_plain(prep, uv, cfg))
    assert (rounds == 2).all()
    gated = dataclasses.replace(cfg, epsilon=0.05, outer_iterations=6)
    got = ts.pd_solve_warp(prep, uv, gated, rounds)
    want = ts.pd_solve_plain(prep, uv, gated)
    assert (got - want).abs().max().item() <= 10 * gated.epsilon
    assert (got - ts.pd_solve(prep, uv, gated)).abs().max().item() \
        <= 10 * gated.epsilon
    assert ((rounds >= 1) & (rounds <= 6)).all()


def test_pd_solve_warp_refuses_what_it_cannot_launch(dev):
    cfg = TVL1Config()
    z = lambda *shape: torch.zeros(shape, device=dev)
    n = ts.pd_solve_warp.launches
    with pytest.raises(ValueError, match="does not fit"):
        ts.pd_solve_warp(z(1, 4, 20, 4000), z(1, 2, 20, 4000), cfg)
    with pytest.raises(ValueError, match="dtype"):
        ts.pd_solve_warp(z(1, 4, 32, 32).double(), z(1, 2, 32, 32), cfg)
    with pytest.raises(ValueError, match="median"):
        ts.pd_solve_warp(z(1, 4, 32, 32), z(1, 2, 32, 32),
                         TVL1Config(median_filtering=7))
    with pytest.raises(ValueError, match="active"):
        ts.pd_solve_warp(z(1, 4, 32, 32), z(1, 2, 32, 32), cfg,
                         torch.zeros(2, dtype=torch.int32, device=dev))
    assert ts.pd_solve_warp.launches == n


# -- tvl1_scale: every warp of one pyramid scale in one launch ----------------

def _chain_scale(i13, i0, uv, cfg):
    """One scale as three kernels: K-A and K-H per warp, then K-C."""
    for _ in range(cfg.warps):
        uv = ts.pd_solve_warp(warp_prep(i13, i0, uv), uv, cfg)
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
    three kernels it fuses.  ε = 0: bit for bit.  With the test engaged it
    still equals the three kernels to the bit (same strips, same order of
    the ε sum); against the plain version a round may flip at the
    threshold, which moves the flow by less than 10·ε a warp."""
    cfg = dataclasses.replace(FAST, epsilon=0.0, median_filtering=k,
                              outer_iterations=2, warps=3)
    i0, i13, uv = _level(dev, b, h, w)
    rounds = torch.zeros((b, 3), dtype=torch.int32, device=dev)
    before = (ts.pd_solve_scale.launches, warp_prep.launches,
              ts.pd_solve_warp.launches, ts.median5.launches)
    got = ts.pd_solve_scale(i13, i0, uv, cfg, rounds)
    assert (ts.pd_solve_scale.launches, warp_prep.launches,
            ts.pd_solve_warp.launches, ts.median5.launches) \
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
    got = ts.pd_solve_scale(i13, i0, uv, gated, rounds)
    assert torch.equal(got, _chain_scale(i13, i0, uv, gated))
    want = ts.pd_solve_scale_plain(i13, i0, uv, gated)
    assert (got - want).abs().max().item() <= 10 * gated.epsilon * 3
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
    counts = lambda: (ts.pd_solve_scale.launches, ts.pd_solve_warp.launches,
                      warp_prep.launches, ts.median5.launches,
                      fk.fb_prologue.launches, fk.fb_warp_neq.launches,
                      fk.fb_window_solve.launches, fk.fb_iteration.launches,
                      fk.sep_corr.launches)
    before = counts()
    calls = [
        lambda: ts.pd_solve_scale(z(n, 3, 8, 8), z(n, 8, 8), z(n, 2, 8, 8),
                                  FAST),
        lambda: ts.pd_solve_warp(z(n, 4, 8, 8), z(n, 2, 8, 8), FAST),
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
    assert ts.median5.launches == before[3] + 1


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


@pytest.mark.parametrize("winsize", [33, 75, 201])
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


@pytest.mark.parametrize("gaussian,winsize", [(False, 15), (True, 15),
                                              (False, 9), (True, 31)])
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
