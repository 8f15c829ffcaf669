"""The port's chunked large-plane TV-L1 solver (K-G) against the JAX
package's banded solver.

``pd_solve_chunked_plain`` is the plain version the CUDA kernel
``pd_chunk`` is held against on the card; here it goes through the same
inputs, from a numpy seed, as JAX's ``tvl1_solve_warp_banded`` with its
Pallas kernel in interpret mode (as tests/test_tvl1.py runs it), at the
sizes and (cfg, band, chunk) cases of that file.  Then the whole pyramid
with the chunked path forced at a small size, and ``use_initial_flow``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import smooth_pair
from video_analytics_tpu.config import TVL1Config as JaxTVL1Config
from video_analytics_tpu.flow.tvl1 import tvl1 as jax_tvl1
from video_analytics_tpu.ops.pallas.tvl1_solve import (
    solver_fits_vmem, tvl1_solve_warp_banded)
from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.flow import tvl1 as flow_tvl1
from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts

torch.set_num_threads(1)

B, H, W = 2, 61, 96


def _jax(cfg: TVL1Config) -> JaxTVL1Config:
    return JaxTVL1Config(**dataclasses.asdict(cfg))


def _planes(seed: int):
    """The inputs of tests/test_tvl1.py's banded-solver tests: random
    warp constants and a random start flow, (B, H, W) each."""
    rng = np.random.default_rng(seed)
    I1wx = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    I1wy = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    grad = I1wx ** 2 + I1wy ** 2
    rho = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    u = rng.normal(0, 0.5, (B, H, W)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, H, W)).astype(np.float32)
    return I1wx, I1wy, grad, rho, u, v


def _both(planes, cfg, band, chunk, adaptive):
    """(JAX banded solver in interpret mode, the port's plain chunked
    solver) on the same planes, each as (B, 2, H, W) numpy."""
    I1wx, I1wy, grad, rho, u, v = planes
    ju, jv = tvl1_solve_warp_banded(
        *(jnp.asarray(a) for a in planes), _jax(cfg), band=band,
        chunk=chunk, adaptive=adaptive)
    prep = torch.from_numpy(np.stack([I1wx, I1wy, grad, rho], axis=1))
    uv = torch.from_numpy(np.stack([u, v], axis=1))
    ours = ts.pd_solve_chunked_plain(prep, uv, cfg, band, chunk, adaptive)
    return np.stack([np.asarray(ju), np.asarray(jv)], axis=1), ours.numpy()


# The three cases of tests/test_tvl1.py:126-139.
CASES = [
    # no early exit, ragged last band, chunk not dividing K
    (TVL1Config(inner_iterations=7, outer_iterations=3, epsilon=1e-6,
                median_filtering=0), 16, 3),
    # median + convergence gate engaged mid-run
    (TVL1Config(inner_iterations=5, outer_iterations=4, epsilon=0.05,
                median_filtering=5), 24, 2),
    # chunk == K: a whole round in one launch
    (TVL1Config(inner_iterations=6, outer_iterations=2, epsilon=1e-6,
                median_filtering=5), 24, 6),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_chunked_plain_matches_banded_reference(case):
    """adaptive=False: atol 1e-6 against JAX (its own bound against its
    whole-plane kernel: the two programs may contract single operations
    differently), and against the port's per-iteration pd_solve_plain,
    where only the order of the ε sum differs."""
    cfg, band, chunk = CASES[case]
    planes = _planes(case)
    ref, ours = _both(planes, cfg, band, chunk, adaptive=False)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    uv = torch.from_numpy(np.stack(planes[4:], axis=1))
    chain = ts.pd_solve_plain(prep, uv, cfg).numpy()
    np.testing.assert_allclose(ours, chain, atol=1e-6, rtol=0)


def test_chunked_plain_does_not_depend_on_tiling_without_gating():
    """adaptive=False and ε = 0: any (band, chunk) gives the bits of the
    per-iteration chain."""
    cfg = TVL1Config(inner_iterations=7, outer_iterations=2, epsilon=0.0,
                     median_filtering=5)
    planes = _planes(7)
    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    uv = torch.from_numpy(np.stack(planes[4:], axis=1))
    chain = ts.pd_solve_plain(prep, uv, cfg)
    for band, chunk in [(16, 3), (61, 7), (8, 1), (40, 4)]:
        out = ts.pd_solve_chunked_plain(prep, uv, cfg, band, chunk,
                                        adaptive=False)
        assert torch.equal(out, chain), (band, chunk)


def test_chunked_adaptive_equals_non_adaptive_until_a_band_converges():
    """tests/test_tvl1.py:198-206: while no band meets ε the adaptive
    flags are all set, and the result is the non-adaptive one exactly;
    both agree with JAX at atol 1e-6."""
    cfg = TVL1Config(inner_iterations=7, outer_iterations=3, epsilon=1e-6,
                     median_filtering=0)
    planes = _planes(3)
    ref, adaptive = _both(planes, cfg, 16, 3, adaptive=True)
    _, plain = _both(planes, cfg, 16, 3, adaptive=False)
    assert np.array_equal(adaptive, plain)
    np.testing.assert_allclose(adaptive, ref, atol=1e-6, rtol=0)


def _gated_planes():
    """Planes on which the band gate engages: the upper rows carry a
    residual and a flow of 1e-3 of the lower rows', so their squared
    updates are about six orders of magnitude under those of the lower
    rows and three under ε² with ε = 0.05."""
    I1wx, I1wy, grad, rho, u, v = _planes(4)
    for a in (rho, u, v):
        a[:, :37] *= 1e-3
    return I1wx, I1wy, grad, rho, u, v


def test_chunked_adaptive_matches_reference_with_gate_engaged():
    """tests/test_tvl1.py:208-218's config (at ε = 0.02) and (band,
    chunk), atol 1e-6 against JAX with bands frozen.  A band's sum that lands within
    rounding of ε²·band_px could flip with the order of the sum, which
    differs between the packages: the rounds are replayed here and every
    band's sum is held to be at least 5 % away from the threshold, so
    both packages take the same flags."""
    cfg = TVL1Config(inner_iterations=5, outer_iterations=6, epsilon=0.02,
                     median_filtering=5)
    band, chunk = 16, 5
    planes = _gated_planes()
    ref, ours = _both(planes, cfg, band, chunk, adaptive=True)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    _, non_adaptive = _both(planes, cfg, band, chunk, adaptive=False)
    assert np.abs(ours - non_adaptive).max() > 1e-6    # the gate did act
    assert np.abs(ours - non_adaptive).max() < 10 * cfg.epsilon

    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    state = torch.from_numpy(np.concatenate(
        [np.stack(planes[4:], axis=1), np.zeros((B, 4, H, W), np.float32)],
        axis=1))
    eps2 = cfg.epsilon ** 2
    band_px = torch.tensor([16 * W, 16 * W, 16 * W, 13 * W],
                           dtype=torch.float32)
    err_band = torch.full((B, 4), float("inf"))
    frozen_rounds = 0
    for _ in range(cfg.outer_iterations):
        run = ts._band_flags(err_band, band_px, H * W, eps2, True)
        frozen_rounds += int((~run).any() and run.any())
        state, err = ts.pd_chunk_plain(prep, state, run.to(torch.int32), cfg,
                                       chunk, band, True)
        err_band = torch.where(run, err, err_band)
        ratio = err_band / (eps2 * band_px)
        assert bool(((ratio < 0.95) | (ratio > 1.05)).all()), ratio
        total = err_band.sum(1) / (H * W) / eps2
        assert bool(((total < 0.95) | (total > 1.05)).all()), total
    assert frozen_rounds >= 2
    assert np.array_equal(state[:, :2].numpy(), ours)


def _rounds_with_the_launch_test(prep, uv, cfg, band, chunk, adaptive):
    """The rounds of ``pd_solve_chunked`` on the card, restated on the
    CPU: each round is its ``pd_chunk_plain`` launches, and the bands' test
    that the round's last launch runs on the card, ``band_flags_plain`` on
    that launch's band sums, decides the next round's flags; the warp's
    last round runs no test."""
    B, _, H, W = uv.shape
    K = cfg.inner_iterations
    n_bands = -(-H // band)
    state = torch.cat([uv, torch.zeros((B, 4, H, W))], dim=1)
    err_band = torch.full((B, n_bands), float("inf"))
    act = torch.ones((B, n_bands), dtype=torch.int32)
    for o in range(cfg.outer_iterations):
        for c0 in range(0, K, chunk):
            state, sums = ts.pd_chunk_plain(prep, state, act, cfg,
                                            min(chunk, K - c0), band,
                                            c0 == 0)
        if o + 1 < cfg.outer_iterations:
            act_next = torch.full_like(act, -1)
            ts.band_flags_plain(sums[..., None], act, err_band, act_next,
                                band, H, W, cfg.epsilon, adaptive)
            act = act_next
    return state[:, :2]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("gated", [True, False])
def test_rounds_with_the_launch_test_match_reference(gated, adaptive):
    """A warp whose rounds end with ``band_flags_plain``, as the card's
    rounds end with the test in their last launch, equals the reference's
    banded solver (its rule at ops/pallas/tvl1_solve.py:1054-1070, Pallas
    in interpret mode) to atol 1e-6, and the port's plain chunked solver to
    the bit: the gated planes at ε = 0.02 (bands freeze and thaw), and
    the median case of tests/test_tvl1.py with its gate engaged."""
    if gated:
        cfg = TVL1Config(inner_iterations=5, outer_iterations=6,
                         epsilon=0.02, median_filtering=5)
        band, chunk, planes = 16, 5, _gated_planes()
    else:
        (cfg, band, chunk), planes = CASES[1], _planes(1)
    ref, plain = _both(planes, cfg, band, chunk, adaptive)
    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    uv = torch.from_numpy(np.stack(planes[4:], axis=1))
    ours = _rounds_with_the_launch_test(prep, uv, cfg, band, chunk,
                                        adaptive).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    assert np.array_equal(ours, plain)


def test_pd_chunk_plain_freezes_inactive_bands():
    cfg = TVL1Config(median_filtering=3)
    planes = _planes(5)
    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    state = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.3, (B, 6, H, W)).astype(np.float32))
    act = torch.tensor([[1, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.int32)
    new, err = ts.pd_chunk_plain(prep, state, act, cfg, 3, 16, True)
    full, err_full = ts.pd_chunk_plain(prep, state, torch.ones_like(act),
                                       cfg, 3, 16, True)
    for b in range(B):
        for i in range(4):
            rows = slice(16 * i, min(16 * i + 16, H))
            want = full if act[b, i] else state
            assert torch.equal(new[b, :, rows], want[b, :, rows])
            assert err[b, i] == (err_full[b, i] if act[b, i] else 0.0)


def test_chunk_params_fit_the_kernel():
    """Every (band, chunk) ``chunk_params`` picks gives a tile that divides
    the band and a window that fits a block's shared memory."""
    for h, w in [(1080, 1920), (864, 1536), (691, 1229), (553, 983),
                 (442, 786), (512, 512), (2160, 3840), (300, 300)]:
        for cfg in (TVL1Config(), TVL1Config(median_filtering=0),
                    TVL1Config(inner_iterations=7, median_filtering=3)):
            band, chunk = ts.chunk_params(h, w, cfg)
            tile, halo = ts.chunk_tile(chunk, cfg)
            assert 1 <= chunk <= cfg.inner_iterations
            assert band % tile == 0 and tile >= 8
            assert halo >= chunk + (cfg.median_filtering // 2
                                    if cfg.median_filtering > 1 else 0)
            side = tile + 2 * halo
            assert (11 * side * side + 1024) * 4 <= 227 * 1024


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors pd_solve_chunked is its plain version and launches
    nothing; pd_chunk, which has no CPU form, refuses them."""
    cfg = TVL1Config(inner_iterations=4, outer_iterations=2)
    planes = _planes(6)
    prep = torch.from_numpy(np.stack(planes[:4], axis=1))
    uv = torch.from_numpy(np.stack(planes[4:], axis=1))
    n = ts.pd_chunk.launches
    assert torch.equal(ts.pd_solve_chunked(prep, uv, cfg, 16, 2),
                       ts.pd_solve_chunked_plain(prep, uv, cfg, 16, 2))
    assert ts.pd_chunk.launches == n
    state = torch.zeros((B, 6, H, W))
    with pytest.raises(ValueError, match="CUDA"):
        ts.pd_chunk(prep, state, torch.ones((B, 4), dtype=torch.int32), cfg,
                    2, 16, 16, 4, True, torch.empty_like(state))


# -- the whole pyramid ------------------------------------------------------

@pytest.mark.parametrize("h,w,median", [(295, 296, 5), (296, 296, 5),
                                        (224, 224, 5), (1080, 1920, 5),
                                        (532, 533, 0), (533, 533, 1),
                                        (300, 300, 3)])
def test_size_rule_matches_reference(h, w, median):
    assert (flow_tvl1.whole_plane_level(h, w, median)
            == solver_fits_vmem(h, w, median))


def test_pyramid_with_chunked_path_forced(monkeypatch):
    """tests/test_tvl1.py:221-266 on the port: every level sent to the
    chunked solver with (band, chunk) = (16, 4), against JAX's XLA ``tvl1``
    at batch 1.  Non-adaptive it is the same algorithm (max EPE < 1e-4);
    with the default adaptive bands the skipped updates are each under
    the ε stop, so the deviation is bounded at 10·ε."""
    cfg = TVL1Config(nscales=2, warps=2, outer_iterations=3,
                     inner_iterations=6, median_filtering=5)
    f1, f2 = smooth_pair(np.random.default_rng(0), 48, 64, dx=1.0, dy=0.5)
    ref = np.asarray(jax_tvl1(jnp.asarray(f1[None]), jnp.asarray(f2[None]),
                              _jax(cfg), use_pallas=False))
    prev, nxt = torch.from_numpy(f1[None]), torch.from_numpy(f2[None])
    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(k["band"])
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(flow_tvl1, "chunk_params", lambda h, w, c: (16, 4))
    monkeypatch.setattr(flow_tvl1, "pd_solve_chunked",
                        counted(ts.pd_solve_chunked))
    never = lambda h, w, k: False
    adaptive = flow_tvl1.tvl1(prev, nxt, cfg, whole_plane=never).numpy()
    assert len(calls) == cfg.nscales * cfg.warps
    monkeypatch.setattr(flow_tvl1, "pd_solve_chunked", functools.partial(
        ts.pd_solve_chunked, adaptive=False))
    exact = flow_tvl1.tvl1(prev, nxt, cfg, whole_plane=never).numpy()
    assert np.linalg.norm(exact - ref, axis=-1).max() < 1e-4
    assert np.linalg.norm(adaptive - ref, axis=-1).max() < 10 * cfg.epsilon
    # Under the size rule the default path is the per-iteration chain.
    default = flow_tvl1.tvl1(prev, nxt, cfg).numpy()
    assert len(calls) == cfg.nscales * cfg.warps
    assert np.linalg.norm(default - ref, axis=-1).max() < 1e-4


def test_use_initial_flow_matches_reference():
    """The seed is resized to the coarsest level and scaled by
    scale_step ** s (flow/tvl1.py:261-266); without the flag it is
    ignored.  Max EPE 1e-4 against JAX at batch 1."""
    cfg = TVL1Config(nscales=3, warps=1, outer_iterations=2,
                     inner_iterations=5, use_initial_flow=True)
    rng = np.random.default_rng(1)
    f1, f2 = smooth_pair(rng, 48, 64, dx=2.0, dy=-1.0)
    seed = np.stack([np.full((48, 64), 2.0) + rng.normal(0, 0.2, (48, 64)),
                     np.full((48, 64), -1.0)], axis=-1)[None].astype(np.float32)
    ref = np.asarray(jax_tvl1(jnp.asarray(f1[None]), jnp.asarray(f2[None]),
                              _jax(cfg), initial_flow=jnp.asarray(seed),
                              use_pallas=False))
    prev, nxt = torch.from_numpy(f1[None]), torch.from_numpy(f2[None])
    ours = flow_tvl1.tvl1(prev, nxt, cfg, torch.from_numpy(seed)).numpy()
    assert np.linalg.norm(ours - ref, axis=-1).max() < 1e-4
    unseeded = flow_tvl1.tvl1(prev, nxt, cfg).numpy()
    assert np.abs(ours - unseeded).max() > 1e-3
    off = dataclasses.replace(cfg, use_initial_flow=False)
    assert np.array_equal(
        flow_tvl1.tvl1(prev, nxt, off, torch.from_numpy(seed)).numpy(),
        unseeded)
