"""The port's TV-L1 (video_analytics_tpu_torch) against the JAX package.

Same inputs, from numpy seeds, go through the JAX function (CPU, XLA
path) and its port: the ops/kernels.py primitives and the median, the
plain versions of the CUDA kernels (K-A warp_prep, K-B pd_solve, K-C
median5), and the whole pyramid.  The port stops each image on its own
ε test, as the JAX package's Pallas solvers do, while its XLA solver
runs a batch until the slowest image converges: so flows are compared
with JAX one pair per call, or at epsilon=0 where the two agree.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import smooth_pair
from tests.np_tvl1 import tvl1_np
from video_analytics_tpu.config import TVL1Config as JaxTVL1Config
from video_analytics_tpu.flow.tvl1 import _solve_warp, _warp_step, tvl1_jit
from video_analytics_tpu.ops import kernels as jk
from video_analytics_tpu.ops.median import median_filter2d as jax_median
from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.flow.tvl1 import tvl1
from video_analytics_tpu_torch.ops import kernels as tk
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep, warp_prep_plain
from video_analytics_tpu_torch.ops.median import (
    _median_network, median_filter2d, separable_median_schedule)

torch.set_num_threads(1)

# Small config keeps the CPU reference fast; same spec as the defaults.
def _jax(cfg: TVL1Config) -> JaxTVL1Config:
    """The JAX package's config with the port config's values."""
    return JaxTVL1Config(**dataclasses.asdict(cfg))


FAST = TVL1Config(nscales=3, warps=2, outer_iterations=4,
                  inner_iterations=10, median_filtering=5)
PAIRS = [(1.4, -0.8), (0.3, 0.1), (3.5, -2.4)]


def _pair(seed, dx, dy, h=48, w=64):
    return smooth_pair(np.random.default_rng(seed), h, w, dx=dx, dy=dy)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ops/kernels.py primitives and the median -------------------------------

@pytest.mark.parametrize("name", ["centered_gradient", "forward_gradient",
                                  "divergence", "blur_edge", "blur_reflect",
                                  "bilinear_sample"])
def test_primitive_matches_reference(name, rng):
    x = rng.uniform(0, 255, (2, 21, 27)).astype(np.float32)
    y = rng.uniform(0, 255, (2, 21, 27)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    if name == "divergence":
        pairs = [(jk.divergence(xj, yj), tk.divergence(xt, yt))]
    elif name.startswith("blur"):
        border = name.split("_")[1]
        pairs = [(jk.gaussian_blur(xj, s, border=border),
                  tk.gaussian_blur(xt, s, border=border))
                 for s in (0.45, 1.3)]
    elif name == "bilinear_sample":
        img = rng.uniform(0, 255, (2, 21, 27, 3)).astype(np.float32)
        ys = rng.uniform(-3, 24, (2, 21, 27)).astype(np.float32)
        xs = rng.uniform(-3, 30, (2, 21, 27)).astype(np.float32)
        pairs = [(jk.bilinear_sample(jnp.asarray(img), jnp.asarray(ys),
                                     jnp.asarray(xs)),
                  tk.bilinear_sample(torch.from_numpy(img),
                                     torch.from_numpy(ys),
                                     torch.from_numpy(xs)))]
    else:
        pairs = list(zip(getattr(jk, name)(xj), getattr(tk, name)(xt)))
    for ref, ours in pairs:
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(17, 22), (30, 40), (21, 27), (13, 31)])
def test_resize_area_like_matches_reference(out_hw, rng):
    x = rng.uniform(0, 255, (3, 21, 27)).astype(np.float32)
    ref = jk.resize_area_like(jnp.asarray(x), out_hw)
    ours = tk.resize_area_like(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_median_bit_exact(k, rng):
    x = rng.normal(0, 3, (2, 19, 23)).astype(np.float32)
    ref = np.asarray(jax_median(jnp.asarray(x), k))
    assert np.array_equal(median_filter2d(torch.from_numpy(x), k).numpy(),
                          ref)


@pytest.mark.parametrize("k2", [9, 25])
def test_generated_median_network_selects_median(k2, rng):
    """The CUDA median runs the network as C source generated from
    _median_network: interpret that source and check it picks the
    median."""
    src = _build.median_network_header()
    body = src.split(f"va_median{k2}(float* w) {{")[1].split("\n}")[0]
    net, _ = _median_network(k2)
    assert body.count("fminf") == sum(j >= 0 for _, j in net)
    for _ in range(50):
        data = list(rng.normal(0, 1, k2))
        w = list(data)
        result = None
        for line in body.strip().splitlines():
            if m := re.match(r"\s*w\[(\d+)\] = w\[(\d+)\];", line):
                w[int(m[1])] = w[int(m[2])]
            elif m := re.search(r"fminf\(w\[(\d+)\], w\[(\d+)\]\)", line):
                i, j = int(m[1]), int(m[2])
                w[i], w[j] = min(w[i], w[j]), max(w[i], w[j])
            else:
                m = re.match(r"\s*return w\[(\d+)\];", line)
                assert m, line
                result = w[int(m[1])]
        assert result == sorted(data)[k2 // 2]


def _tile_schedule(k):
    """The generated C of va_median_tile{k} as (tile rows, ops, outputs):
    ops as (out, fn, a, b), wires named as in the source (v[i], tN)."""
    src = _build.median_network_header()
    th = int(re.search(r"#define VA_MEDIAN_TILE_ROWS (\d+)", src)[1])
    assert re.search(r"#define VA_MEDIAN_TILE_COLS 1\b", src)
    body = src.split(f"va_median_tile{k}(const float* v, float* o) {{")[1]
    body = body.split("\n}")[0]
    wire = r"(v\[\d+\]|t\d+)"
    ops, outs = [], {}
    for line in body.strip().splitlines():
        if m := re.fullmatch(rf"\s*const float (t\d+) = (fminf|fmaxf)"
                             rf"\({wire}, {wire}\);", line):
            ops.append(m.groups())
        else:
            m = re.fullmatch(rf"\s*o\[(\d+)\] = {wire};", line)
            assert m, line
            outs[int(m[1])] = m[2]
    assert sorted(outs) == list(range(th))
    return th, ops, [outs[i] for i in range(th)]


def _median_by_tile_schedule(x, k):
    """Interpret the generated tile schedule over whole (B, H, W) planes:
    every thread's column of outputs from its clamped (replicate)
    neighbourhood, as csrc/median.cu stages it."""
    th, ops, outs = _tile_schedule(k)
    B, H, W = x.shape
    r = k // 2
    y0 = np.arange(0, H, th)
    rows = np.clip(y0[:, None] - r + np.arange(th + k - 1), 0, H - 1)
    cols = np.clip(np.arange(W)[:, None] - r + np.arange(k), 0, W - 1)
    # (B, tiles down, W, th + k - 1, k) inputs, row-major per tile.
    grid = x[:, rows[:, None, :, None], cols[None, :, None, :]]
    wires = {f"v[{i}]": grid[..., i // k, i % k]
             for i in range((th + k - 1) * k)}
    for out, fn, a, b in ops:
        wires[out] = (np.minimum if fn == "fminf" else np.maximum)(
            wires[a], wires[b])
    col = np.stack([wires[o] for o in outs], axis=-1)  # (B, tiles, W, th)
    return col.transpose(0, 1, 3, 2).reshape(B, -1, W)[:, :H]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h,w", [(37, 53), (16, 24), (5, 7), (2, 3), (1, 1),
                                 (9, 2)])
def test_generated_median_tile_schedule_selects_medians(k, h, w, rng):
    """The CUDA median runs the separable tile schedule as C source
    generated from separable_median_schedule: interpret that source over
    whole planes (ties, a constant region, zeros of both signs; planes
    smaller than a thread's column of outputs or than k) and hold it
    against median_filter2d and the JAX package's median by value, and
    the schedule well under half the Batcher network's min/max."""
    x = np.round(rng.normal(0, 2, (3, h, w)) * 2).astype(np.float32) / 2
    x[:, : h // 2, : w // 2] = 1.5
    zero = rng.uniform(size=x.shape) < 0.2
    x[zero] = np.where(rng.uniform(size=x.shape) < 0.5, -0.0, 0.0)[zero]
    got = _median_by_tile_schedule(x, k)
    assert np.array_equal(got, median_filter2d(torch.from_numpy(x), k).numpy())
    assert np.array_equal(got, np.asarray(jax_median(jnp.asarray(x), k)))
    th, ops, _ = _tile_schedule(k)
    rows, cols, sched, outs = separable_median_schedule(k)
    assert len(ops) == len(sched) and (rows, cols) == (th + k - 1, k)
    batcher = 2 * sum(j >= 0 for _, j in _median_network(k * k)[0])
    assert len(ops) / th < batcher / 2


# -- the plain versions of the kernels -------------------------------------

def _level_inputs(seed, dx, dy, h=40, w=52):
    """I0, (I1, I1x, I1y) and a smooth flow at one level, as numpy."""
    rng = np.random.default_rng(seed)
    f1, f2 = _pair(seed, dx, dy, h, w)
    I1x, I1y = (np.asarray(g) for g in jk.centered_gradient(
        jnp.asarray(f2[None])))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    uv = np.stack([dx + 0.5 * np.sin(5 * yy + rng.uniform(0, 6)),
                   dy + 0.5 * np.cos(4 * xx)])[None].astype(np.float32)
    i13 = np.stack([f2[None], I1x, I1y], axis=1)
    return f1[None], i13, uv


def test_warp_prep_plain_matches_reference():
    i0, i13, uv = _level_inputs(1, 1.2, -0.7)
    I1w, I1wx, I1wy = _warp_step(*(jnp.asarray(i13[:, c]) for c in range(3)),
                                 jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]),
                                 use_pallas=False)
    u0, v0 = uv[:, 0], uv[:, 1]
    ref = np.stack([I1wx, I1wy, np.asarray(I1wx * I1wx + I1wy * I1wy),
                    np.asarray(I1w - I1wx * u0 - I1wy * v0 - i0)], axis=1)
    ours = warp_prep_plain(torch.from_numpy(i13), torch.from_numpy(i0),
                           torch.from_numpy(uv))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("epsilon", [0.01, 0.0])
def test_pd_solve_plain_matches_solve_warp(epsilon):
    cfg = dataclasses.replace(FAST, epsilon=epsilon)
    i0, i13, uv = _level_inputs(2, 0.8, 0.4)
    prep = warp_prep_plain(torch.from_numpy(i13), torch.from_numpy(i0),
                           torch.from_numpy(uv))
    I1w = jk.bilinear_sample(
        jnp.asarray(i13[:, 0, :, :, None]),
        jnp.arange(i0.shape[1], dtype=jnp.float32)[:, None] + uv[:, 1],
        jnp.arange(i0.shape[2], dtype=jnp.float32)[None, :] + uv[:, 0])[..., 0]
    u0, v0 = jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])
    ref_u, ref_v = _solve_warp(jnp.asarray(i0), I1w,
                               jnp.asarray(prep[:, 0].numpy()),
                               jnp.asarray(prep[:, 1].numpy()),
                               u0, v0, u0, v0, _jax(cfg))
    ours = ts.pd_solve_plain(prep, torch.from_numpy(uv), cfg)
    np.testing.assert_allclose(ours[:, 0].numpy(), np.asarray(ref_u),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours[:, 1].numpy(), np.asarray(ref_v),
                               rtol=1e-5, atol=1e-5)


def test_median5_plain_masks_images(rng):
    x = torch.from_numpy(rng.normal(0, 2, (3, 2, 17, 21)).astype(np.float32))
    active = torch.tensor([1, 0, 1], dtype=torch.int32)
    out = ts.median5_plain(x, 5, active)
    assert torch.equal(out[1], x[1])
    for b in (0, 2):
        ref = jax_median(jnp.asarray(x[b].numpy()), 5)
        assert np.array_equal(out[b].numpy(), np.asarray(ref))


def test_eps_reduce_plain_clears_converged(rng):
    """The plain version of the ε test that a round's last ``pd_step``
    launch runs: the mean of each active image's partials, its flag
    cleared under ε², a frozen image's error kept."""
    partial = torch.from_numpy(rng.uniform(0, 1, (4, 6)).astype(np.float32))
    partial[1] *= 1e-6
    active = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    err = torch.full((4,), float("inf"))
    ts.eps_reduce_plain(partial, active, err, n_px=30, epsilon=0.01)
    assert active.tolist() == [1, 0, 0, 1]
    assert err[2] == float("inf")
    np.testing.assert_allclose(err[[0, 1, 3]].numpy(),
                               (partial.sum(1) / 30)[[0, 1, 3]].numpy(),
                               rtol=1e-6)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; pd_step, which has no CPU form, refuses them, with
    the round's ε test or without."""
    i0, i13, uv = _level_inputs(3, -0.6, 0.9, h=20, w=24)
    i0, i13, uv = (torch.from_numpy(a) for a in (i0, i13, uv))
    counts = (warp_prep.launches, ts.pd_step.launches, ts.median5.launches,
              ts.pd_step.launches_test)
    prep = warp_prep(i13, i0, uv)
    assert torch.equal(prep, warp_prep_plain(i13, i0, uv))
    assert torch.equal(ts.median5(uv, 3), ts.median5_plain(uv, 3))
    assert torch.equal(ts.pd_solve(prep, uv, FAST),
                       ts.pd_solve_plain(prep, uv, FAST))
    assert counts == (warp_prep.launches, ts.pd_step.launches,
                      ts.median5.launches, ts.pd_step.launches_test)
    p = torch.zeros((1, 4, 20, 24))
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ts.pd_step(prep, uv, p, one, FAST, torch.empty_like(uv),
                   torch.empty_like(p))
    with pytest.raises(ValueError, match="CUDA"):
        ts.pd_step(prep, uv, p, one, FAST, torch.empty_like(uv),
                   torch.empty_like(p), torch.empty((1, ts.pd_blocks(20, 24))),
                   torch.zeros(1, dtype=torch.int32), torch.empty(1))
    assert counts == (warp_prep.launches, ts.pd_step.launches,
                      ts.median5.launches, ts.pd_step.launches_test)


# -- the whole pyramid ------------------------------------------------------

@pytest.mark.parametrize("seed,motion", list(enumerate(PAIRS)))
def test_tvl1_matches_reference_one_pair(seed, motion):
    f1, f2 = _pair(seed, *motion)
    ref = np.asarray(tvl1_jit(jnp.asarray(f1[None]), jnp.asarray(f2[None]),
                              _jax(FAST)))[0]
    ours = tvl1(torch.from_numpy(f1[None]), torch.from_numpy(f2[None]),
                FAST)[0].numpy()
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-3, epe.mean()
    assert epe.max() < 0.05, epe.max()


def test_tvl1_matches_numpy_oracle():
    """The independent numpy TV-L1 the JAX package is tested against,
    at the bounds tests/test_tvl1.py holds JAX to."""
    f1, f2 = _pair(0, *PAIRS[0])
    ref = tvl1_np(f1, f2, FAST)
    ours = tvl1(torch.from_numpy(f1[None]), torch.from_numpy(f2[None]),
                FAST)[0].numpy()
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 5e-3, epe.mean()
    assert epe.max() < 0.1, epe.max()


def test_tvl1_batch_matches_reference_at_epsilon_zero():
    cfg = dataclasses.replace(FAST, epsilon=0.0)
    pairs = [_pair(s, *m) for s, m in enumerate(PAIRS)]
    prev = np.stack([p[0] for p in pairs])
    nxt = np.stack([p[1] for p in pairs])
    ref = np.asarray(tvl1_jit(jnp.asarray(prev), jnp.asarray(nxt),
                              _jax(cfg)))
    ours = tvl1(torch.from_numpy(prev), torch.from_numpy(nxt), cfg).numpy()
    assert ours.shape == (3, 48, 64, 2)
    assert np.abs(ours - ref).max() < 1e-3, np.abs(ours - ref).max()


def test_tvl1_pair_independent_of_its_batch():
    """Per-image ε stop: an easy pair's flow is the same alone and
    batched with a hard pair (the reference's XLA solver changes it)."""
    easy, hard = _pair(0, 0.3, 0.1), _pair(1, 3.5, -2.4)
    prev = torch.from_numpy(np.stack([easy[0], hard[0]]))
    nxt = torch.from_numpy(np.stack([easy[1], hard[1]]))
    both = tvl1(prev, nxt, FAST)
    assert torch.equal(both[0], tvl1(prev[:1], nxt[:1], FAST)[0])
    assert torch.equal(both[1], tvl1(prev[1:], nxt[1:], FAST)[0])
