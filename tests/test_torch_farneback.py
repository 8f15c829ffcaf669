"""The port's Farneback path against the JAX package on the CPU: the same
numpy inputs, made from a seed, through both.

The JAX side runs as its own tests run it here: the XLA branch
(``use_pallas=False``) and, for the Pallas kernels, interpret mode.  On
CPU tensors the port's kernel wrappers take their plain PyTorch versions.

Tolerances (float32 throughout):
- constants (taps, Gramian coefficients, attenuation, level sizes):
  equal to the bit, both sides compute them in float64 numpy;
- one stage (expansion, normal equations, window average + solve):
  1e-5 relative to the stage's largest value.  XLA on the CPU may
  contract a·b + c into one fused multiply-add where PyTorch rounds
  twice;
- a Pallas kernel in interpret mode against the port: the bound the JAX
  package's own tests hold that kernel to (1e-4 for the expansion, 5e-5
  + 1e-5 relative for the fused prologue, whose resize halves x first,
  1e-5 for the solve);
- whole flows: max end-point error < 1e-4 against JAX, < 3e-4 against
  ``cv2.calcOpticalFlowFarneback`` (``EXACT`` of tests/test_farneback.py);
- fused class probabilities: 1e-4.
"""

import dataclasses
import functools
import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import moving_square_frames, smooth_pair
from video_analytics_tpu import config as jax_config
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.ops import kernels as jk
from video_analytics_tpu.ops.pallas import farneback_kernels as jpk
from video_analytics_tpu.runtime import pipeline as jax_pipeline
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.flow import farneback as tfb
from video_analytics_tpu_torch.models.convert import two_stream_flax_to_torch
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import kernels as tk
from video_analytics_tpu_torch.ops.cuda import farneback as fk
from video_analytics_tpu_torch.runtime import pipeline

# The package exports the function under the module's name.
jfb = importlib.import_module("video_analytics_tpu.flow.farneback")

torch.set_num_threads(1)

EXACT = 3e-4           # tests/test_farneback.py: the bound against cv2
FLOW_TOL = 1e-4        # max end-point error, port vs JAX
SIZES = [(96, 128), (67, 93)]


def _jax_fb(cfg: FarnebackConfig) -> jax_config.FarnebackConfig:
    return jax_config.FarnebackConfig(**dataclasses.asdict(cfg))


def _jax_cfg(cfg: PipelineConfig) -> jax_config.PipelineConfig:
    """The JAX package's config with the port config's values."""
    return jax_config.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jax_config.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": _jax_fb(cfg.farneback),
        "tvl1": jax_config.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


def _frames(seed, n, h, w):
    """n smooth gray frames in [0, 255], each the previous one moved."""
    rng = np.random.default_rng(seed)
    f1, f2 = smooth_pair(rng, h, w, dx=1.7, dy=-0.9)
    out = [f1, f2]
    while len(out) < n:
        out.append(np.roll(out[-1], (1, -2), axis=(0, 1)))
    return np.stack(out[:n]).astype(np.float32)


def _cf(x):
    """JAX (B, H, W, C) → numpy (B, C, H, W), writable."""
    return np.array(x).transpose(0, 3, 1, 2)


def _jax_farneback(prev, nxt, cfg: FarnebackConfig, **kw):
    """The JAX package's farneback on its XLA branch, jitted as its own
    tests and pipelines run it (and quicker here than op by op)."""
    fn = jax.jit(functools.partial(jfb.farneback, cfg=_jax_fb(cfg),
                                   use_pallas=False))
    return fn(jnp.asarray(prev), jnp.asarray(nxt),
              **{k: jnp.asarray(v) for k, v in kw.items()})


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(np.asarray(ours) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# -- (a) constants ----------------------------------------------------------

@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5), (5, 1.1)])
def test_poly_exp_setup_equal(n, sigma):
    for a, b in zip(tfb._poly_exp_setup(n, sigma),
                    jfb._poly_exp_setup(n, sigma)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("winsize,gaussian", [(15, False), (15, True),
                                              (9, False), (9, True)])
def test_window_taps_equal(winsize, gaussian):
    assert tk.farneback_window_taps(winsize, gaussian) == \
        jk.farneback_window_taps(winsize, gaussian)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25, 0.36, 0.8])
def test_smooth_taps_equal(scale):
    assert tfb._smooth_taps(scale) == jfb._smooth_taps(scale)


@pytest.mark.parametrize("h,w", [(96, 128), (67, 93), (7, 9), (3, 40)])
def test_border_attenuation_equal(h, w):
    assert np.array_equal(tfb._border_attenuation(h, w).numpy(),
                          np.asarray(jfb._border_attenuation(h, w)))


@pytest.mark.parametrize("h,w,kw", [
    (224, 224, {}), (240, 320, {}), (96, 128, {}), (67, 93, {}),
    (96, 128, {"pyr_scale": 0.8, "levels": 5}), (40, 50, {}),
    (67, 93, {"pyr_scale": 0.6}), (96, 128, {"levels": 0})])
def test_level_sizes_equal(h, w, kw):
    cfg = FarnebackConfig(**kw)
    assert tfb._level_sizes(h, w, cfg) == jfb._level_sizes(h, w, _jax_fb(cfg))


def test_serve_and_native_pyramids():
    """The level sizes the kernels are measured at."""
    cfg = FarnebackConfig()
    assert [s[:2] for s in tfb._level_sizes(224, 224, cfg)] == \
        [(56, 56), (112, 112), (224, 224)]
    assert [s[:2] for s in tfb._level_sizes(240, 320, cfg)] == \
        [(60, 80), (120, 160), (240, 320)]


@pytest.mark.parametrize("op", ["sepcorr_box", "bilinear_sample",
                                "sepcorr_reflect"])
def test_kernel_helpers_match(op, rng):
    """ops/kernels helpers of the Farneback path against the JAX
    package's (1e-5 relative: the same float32 sums, XLA may contract)."""
    img = rng.uniform(0, 255, (2, 23, 31)).astype(np.float32)
    if op == "sepcorr_box":
        k = np.array(tk.farneback_window_taps(15, False), np.float32)
        ref = jk.box_blur(jnp.asarray(img), 15)
        ours = tk.sepcorr(torch.from_numpy(img), k, k)
    elif op == "sepcorr_reflect":
        k = np.array(tfb._smooth_taps(0.25), np.float32)
        ref = jk.sepcorr(jnp.asarray(img), k, k, border="reflect")
        ours = tk.sepcorr(torch.from_numpy(img), k, k, border="reflect")
    else:
        flow = rng.normal(0, 3, (2, 23, 31, 2)).astype(np.float32)
        planes = np.stack([img, img[:, ::-1]], axis=-1)
        ref = jk.warp_by_flow(jnp.asarray(planes), jnp.asarray(flow))
        yy, xx = np.mgrid[0:23, 0:31].astype(np.float32)
        ours = tk.bilinear_sample(torch.from_numpy(planes.copy()),
                                  torch.from_numpy(yy + flow[..., 1]),
                                  torch.from_numpy(xx + flow[..., 0]))
    _close(ours.numpy(), ref)


# -- (b) K-D: blur + resize + expansion -------------------------------------

@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("scale,poly", [(1.0, (5, 1.2)), (0.5, (5, 1.2)),
                                        (0.25, (7, 1.5)), (0.6, (5, 1.2))])
def test_fb_prologue_plain_matches_xla_chain(h, w, scale, poly):
    frames = _frames(1, 3, h, w)
    out_hw = (int(round(h * scale)), int(round(w * scale)))
    ref = jfb.poly_expansion(
        jfb._smooth_and_resize(jnp.asarray(frames), scale, out_hw), *poly)
    ours = fk.fb_prologue(torch.from_numpy(frames), scale, out_hw, *poly)
    assert ours.shape == (3, 5, *out_hw)
    _close(ours.numpy(), _cf(ref))


@pytest.mark.parametrize("scale,out_hw,poly", [(1.0, (96, 128), (5, 1.2)),
                                               (0.5, (48, 64), (5, 1.2)),
                                               (0.25, (24, 32), (7, 1.5))])
def test_fb_prologue_plain_matches_pallas_prologue(scale, out_hw, poly):
    """Row 14 of the TPU kernel table: poly_prologue_pallas (interpret
    mode), at 2^k sizes, which are all it takes.  It halves x first, the
    port y first: the tolerance is the one the JAX package's own test
    holds it to against the y-first chain."""
    frames = _frames(2, 3, 96, 128)
    ref = jpk.poly_prologue_pallas(jnp.asarray(frames),
                                   jfb._smooth_taps(scale), *poly, out_hw,
                                   layout="cf")
    ours = fk.fb_prologue_plain(torch.from_numpy(frames), scale, out_hw,
                                *poly)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=5e-5)


def test_poly_expansion_matches_pallas_twin():
    """The unfused twin, poly_expansion_pallas (interpret mode), at the
    bound tests/test_pallas_farneback.py holds it to."""
    img = np.random.default_rng(0).uniform(0, 255, (2, 48, 64)).astype(
        np.float32)
    ref = jpk.poly_expansion_pallas(jnp.asarray(img), 5, 1.2, cf=True)
    ours = tfb.poly_expansion(torch.from_numpy(img), 5, 1.2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


# -- (c) K-E: warp + normal equations ---------------------------------------

def _pair_expansions(h, w, seed=3, b=2):
    frames = _frames(seed, b + 1, h, w)
    R = jfb.poly_expansion(jnp.asarray(frames), 5, 1.2)
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 2.0, (b, h, w, 2)).astype(np.float32)
    flow[0, : h // 2] = np.round(flow[0, : h // 2])   # exact integers
    flow[1, :, :3, 0] = -40.0                         # far out of bounds
    flow[1, -2:, :, 1] = 40.0
    return R[:-1], R[1:], flow


@pytest.mark.parametrize("h,w", SIZES)
def test_fb_warp_neq_plain_matches_update_matrices(h, w):
    """Rows 8, 9, 11, 12 and the warp half of 13: one 2-D gather + the
    normal equations, against update_matrices with the exact gather."""
    R0, R1, flow = _pair_expansions(h, w)
    ref = jfb.update_matrices(R0, R1, jnp.asarray(flow), use_pallas=False)
    ours = fk.fb_warp_neq(torch.from_numpy(_cf(R0)),
                          torch.from_numpy(_cf(R1)),
                          torch.from_numpy(flow.transpose(0, 3, 1, 2)))
    _close(ours.numpy(), _cf(ref))


@pytest.mark.parametrize("h,w", SIZES)
def test_oob_mask_equal(h, w):
    _, _, flow = _pair_expansions(h, w)
    ref = jfb._oob_mask(jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]),
                        h, w)
    ours = tfb._oob_mask(torch.from_numpy(flow[..., 0]),
                         torch.from_numpy(flow[..., 1]))
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    still = tfb._oob_mask(torch.zeros(1, h, w), torch.zeros(1, h, w))
    assert not still[:, -1].any() and not still[:, :, -1].any()
    assert still[:, :-1, :-1].all()


# -- (d) K-F: window average + solve ----------------------------------------

def _matrices(h, w):
    R0, R1, flow = _pair_expansions(h, w)
    return jfb.update_matrices(R0, R1, jnp.zeros_like(flow),
                               use_pallas=False)


def _window_solve(M, cfg):
    """The port's iteration tail: K-F along y, then along x with the
    solve epilogue."""
    taps = tk.farneback_window_taps(cfg.winsize, cfg.gaussian_window)
    x = torch.from_numpy(_cf(M))
    return fk.sep_corr(fk.sep_corr(x, taps, 0), taps, 1, solve=True)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("kw", [{}, {"gaussian_window": True},
                                {"winsize": 9}])
def test_sep_corr_plain_matches_blur_and_solve(h, w, kw):
    cfg = FarnebackConfig(**kw)
    M = _matrices(h, w)
    ref = jfb._solve_flow(jfb._blur_M(M, _jax_fb(cfg)))
    _close(_window_solve(M, cfg).numpy(), _cf(ref))
    # sepcorr (vertical, then horizontal) is the same sums in the same
    # order.
    Mt = torch.from_numpy(_cf(M))
    k = tfb._window_taps(cfg)
    blurred = tk.sepcorr(Mt.reshape(-1, h, w), k, k).reshape(Mt.shape)
    assert torch.equal(_window_solve(M, cfg), tfb._solve_flow(blurred))


@pytest.mark.parametrize("gaussian", [False, True])
def test_sep_corr_plain_matches_pallas_update_flow(gaussian):
    """Rows 7 and 10: update_flow_pallas (sep_corr2d_pallas with the
    solve2x2 epilogue) in interpret mode, at its own test's bound."""
    cfg = FarnebackConfig(gaussian_window=gaussian)
    M = _matrices(48, 64)
    ref = jpk.update_flow_pallas(M, _jax_fb(cfg))
    np.testing.assert_allclose(_window_solve(M, cfg).numpy(), _cf(ref),
                               atol=1e-5)


def test_sep_corr_plain_matches_pallas_sep_corr2d():
    """Row 7 without the epilogue: two passes of the box window."""
    x = np.random.default_rng(4).uniform(0, 1, (1, 2, 40, 256)).astype(
        np.float32)
    taps = tk.farneback_window_taps(15, False)
    plan = tuple((c, taps) for c in range(2))
    ref = jpk.sep_corr2d_pallas(jnp.asarray(x), plan, plan)
    ours = fk.sep_corr(fk.sep_corr(torch.from_numpy(x), taps, 0), taps, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"gaussian_window": True},
                                {"winsize": 9}])
def test_fb_window_solve_plain_is_sep_corr_twice(kw):
    """Both window passes and the solve as one function: to the bit what
    ``sep_corr`` along y and ``sep_corr`` along x with the solve give, and
    what one iteration of the pyramid loop computes from M."""
    cfg = FarnebackConfig(**kw)
    taps = tfb._window_taps(cfg)
    M = torch.from_numpy(_cf(_matrices(67, 93)))
    n = fk.fb_window_solve.launches
    got = fk.fb_window_solve(M, taps)
    assert fk.fb_window_solve.launches == n      # a CPU tensor: no launch
    assert got.shape == (2, 2, 67, 93)
    want = fk.sep_corr_plain(fk.sep_corr_plain(M, taps, 0), taps, 1,
                             solve=True)
    assert torch.equal(got, want)
    assert torch.equal(got, fk.fb_window_solve_plain(M, taps))
    assert torch.equal(got, _window_solve(_matrices(67, 93), cfg))


@pytest.mark.parametrize("gaussian", [False, True])
def test_fb_iteration_matches_pallas_fused_iteration(gaussian):
    """One whole iteration against the JAX package's ``_fused_iteration``
    (banded Pallas warp, then normal equations, window average and solve
    in ``update_flow_fused_pallas``) in interpret mode.  Each pair's flow
    is uniform: the banded warp resamples rows, then columns, which is the
    exact 2-D sample only where the flow does not vary inside the band."""
    cfg = FarnebackConfig(gaussian_window=gaussian)
    h, w = 48, 64
    R0, R1, _ = _pair_expansions(h, w)
    flow = np.empty((2, 2, h, w), np.float32)
    flow[0, 0], flow[0, 1] = 1.3, -0.7
    flow[1, 0], flow[1, 1] = -2.0, 0.5
    R0, R1 = _cf(R0), _cf(R1)
    ref = jfb._fused_iteration(jnp.asarray(R0), jnp.asarray(R1),
                               jnp.asarray(flow), _jax_fb(cfg), None)
    args = (torch.from_numpy(R0), torch.from_numpy(R1),
            torch.from_numpy(flow), tfb._window_taps(cfg))
    n = fk.fb_iteration.launches
    ours = fk.fb_iteration(*args)
    assert fk.fb_iteration.launches == n
    assert torch.equal(ours, fk.fb_iteration_plain(*args))
    assert torch.equal(
        ours, fk.fb_window_solve(fk.fb_warp_neq(*args[:3]), args[3]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_wrappers_take_plain_versions_on_cpu():
    frames = torch.from_numpy(_frames(5, 3, 40, 48))
    counts = (fk.fb_prologue.launches, fk.fb_warp_neq.launches,
              fk.sep_corr.launches)
    R = fk.fb_prologue(frames, 0.5, (20, 24), 5, 1.2)
    assert torch.equal(R, fk.fb_prologue_plain(frames, 0.5, (20, 24), 5,
                                               1.2))
    flow = torch.zeros((2, 2, 20, 24))
    M = fk.fb_warp_neq(R[:-1], R[1:], flow)
    assert torch.equal(M, fk.fb_warp_neq_plain(R[:-1], R[1:], flow))
    taps = tk.farneback_window_taps(15, False)
    assert torch.equal(fk.sep_corr(M, taps, 1, solve=True),
                       fk.sep_corr_plain(M, taps, 1, solve=True))
    assert counts == (fk.fb_prologue.launches, fk.fb_warp_neq.launches,
                      fk.sep_corr.launches)


# -- (e) the whole flow -----------------------------------------------------

CONFIGS = {
    "default": ({}, (0.5, 3, 15, 3, 5, 1.2), 0),
    "poly7": ({"poly_n": 7, "poly_sigma": 1.5}, (0.5, 3, 15, 3, 7, 1.5), 0),
    "winsize9": ({"winsize": 9}, (0.5, 3, 9, 3, 5, 1.2), 0),
    "gaussian": ({"gaussian_window": True}, (0.5, 3, 15, 3, 5, 1.2),
                 cv2.OPTFLOW_FARNEBACK_GAUSSIAN),
    "pyr0.6": ({"pyr_scale": 0.6}, (0.6, 3, 15, 3, 5, 1.2), 0),
}


@pytest.fixture(scope="module")
def pair():
    f1, f2 = smooth_pair(np.random.default_rng(0), 96, 128, dx=2.3, dy=-1.1)
    return f1.astype(np.uint8), f2.astype(np.uint8)


def _epe(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_farneback_matches_reference(name, pair):
    kw, _, _ = CONFIGS[name]
    cfg = FarnebackConfig(**kw)
    u1, u2 = (a[None].astype(np.float32) for a in pair)
    ref = _jax_farneback(u1, u2, cfg)
    ours = tfb.farneback(torch.from_numpy(u1), torch.from_numpy(u2), cfg)
    assert ours.shape == (1, 96, 128, 2)
    assert _epe(ours.numpy(), ref) < FLOW_TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_farneback_matches_cv2(name, pair):
    kw, cv_args, cv_flags = CONFIGS[name]
    u1, u2 = pair
    ref = cv2.calcOpticalFlowFarneback(u1, u2, None, *cv_args, cv_flags)
    ours = tfb.farneback(torch.from_numpy(u1[None]),
                         torch.from_numpy(u2[None]),
                         FarnebackConfig(**kw))[0].numpy()
    assert _epe(ours, ref) < EXACT
    if name == "default":
        np.testing.assert_allclose(ours.reshape(-1, 2).mean(0), [2.3, -1.1],
                                   atol=0.25)


def test_use_initial_flow_matches_reference(pair):
    u1, u2 = (a[None].astype(np.float32) for a in pair)
    cfg = FarnebackConfig(levels=1, iterations=1, use_initial_flow=True)
    seed = np.full((1, 96, 128, 2), [2.3, -1.1], np.float32)
    ref = _jax_farneback(u1, u2, cfg, initial_flow=seed)
    ours = tfb.farneback(torch.from_numpy(u1), torch.from_numpy(u2), cfg,
                         initial_flow=torch.from_numpy(seed))
    assert _epe(ours.numpy(), ref) < FLOW_TOL
    unseeded = tfb.farneback(torch.from_numpy(u1), torch.from_numpy(u2), cfg)
    assert _epe(ours.numpy(), unseeded.numpy()) > 1e-3
    inner = ours[0, 10:-10, 10:-10].reshape(-1, 2).mean(0).numpy()
    np.testing.assert_allclose(inner, [2.3, -1.1], atol=0.3)


@pytest.mark.parametrize("name,kw,shape", [
    # The 1/16 level (32x32) pre-blurs with 39 taps.
    ("levels4", {"levels": 4, "iterations": 1}, (512, 512)),
    # A window of 33 taps.
    ("winsize33", {"winsize": 33, "levels": 1}, (96, 128)),
    # A window of 201 taps: the route through K-E and sep_corr twice.
    ("winsize201", {"winsize": 201, "levels": 1}, (48, 64)),
])
def test_farneback_beyond_31_taps_matches_reference(name, kw, shape):
    """Parameters the first kernels refused on the card (a blur or window
    longer than 31 taps) against the JAX package: the plain versions here,
    the kernels against them on the card (tests/test_torch_cuda.py)."""
    cfg = FarnebackConfig(**kw)
    if name == "levels4":
        assert max(len(tfb._smooth_taps(s))
                   for _, _, s in tfb._level_sizes(*shape, cfg)) == 39
    f1, f2 = smooth_pair(np.random.default_rng(3), *shape, dx=2.3, dy=-1.1)
    u1, u2 = (a[None].astype(np.float32) for a in (f1, f2))
    ref = _jax_farneback(u1, u2, cfg)
    ours = tfb.farneback(torch.from_numpy(u1), torch.from_numpy(u2), cfg)
    assert _epe(ours.numpy(), ref) < FLOW_TOL


def test_window_route_rule():
    """One launch while fb_iteration's five tiles and the taps fit a
    block (73 taps), K-E and fb_window_solve while its one tile does
    (193), else K-E and two launches of sep_corr; never a plain version."""
    assert [fk.window_route(n) for n in (1, 15, 33, 73, 75, 193, 195, 201,
                                         1001)] == \
        ["iteration"] * 4 + ["window_solve"] * 2 + ["sep_corr"] * 3
    for n in (73, 193):
        assert fk.window_smem(n, 5 if n == 73 else 1) <= 232448
        assert fk.window_smem(n + 2, 5 if n == 73 else 1) > 232448
    # The default window: 15 taps, a 32x32 tile with a halo of 7.
    assert fk.window_smem(15, 5) == 4 * (32 * 48 + 5 * 46 * 46 + 15)
    # sep_corr streams the taps in chunks: a block's shared memory does not
    # grow with the window, so the route beyond 193 taps has no end.
    for planes in (1, 5):
        assert fk.sep_corr_smem(195, 0, planes) <= 232448


@pytest.mark.parametrize("n", [1, 15, 195, 201, 1401, 2001, 100001])
def test_sep_corr_takes_any_odd_window(n):
    """F4: the shared memory of a block of sep_corr is a fixed chunk of
    taps and the samples they reach, the same for every window length
    and both axes, so no odd window is refused; an even one is."""
    for planes in (1, 5):
        smem = fk.sep_corr_smem(n, 0, planes)
        assert smem == fk.sep_corr_smem(n, 1, planes) \
            == fk.sep_corr_smem(15, 0, planes)
        assert smem <= 232448
        fk._expect_taps([1.0 / n] * n, "sep_corr", smem)
    with pytest.raises(ValueError, match="odd number of taps"):
        fk._expect_taps([0.5] * (n + 1), "sep_corr",
                        fk.sep_corr_smem(n + 1, 0, 1))
    assert fk.window_route(n) == ("sep_corr" if n > 193 else "iteration"
                                  if n <= 73 else "window_solve")


@pytest.mark.parametrize("hw,scale,form", [
    ((224, 224), 1.0, ("fused", 44)), ((224, 224), 0.5, ("fused", 86)),
    ((224, 224), 0.25, ("fused", 151)), ((240, 320), 0.25, ("fused", 174)),
    ((1080, 1920), 0.125, ("fused", 348)),
    ((1080, 1920), 0.0625, ("split", 0)), ((1080, 1920), 0.03125,
                                           ("split", 0)),
    ((2160, 3840), 0.015625, ("split", 0))])
def test_prologue_form_rule(hw, scale, form):
    """K-D fuses where the widest tile's reach fits a block: every level of
    the serve and native pyramids and 1080p down to 1/8; below (and at
    4K's 1/64, 159 taps), two launches."""
    H, W = hw
    lh, lw = int(round(H * scale)), int(round(W * scale))
    assert fk.prologue_form(H, W, lh, lw, scale, 5) == form
    if form[0] == "fused":
        assert fk.prologue_smem(len(tfb._smooth_taps(scale)), 11,
                                scale < 1, scale < 1, form[1]) <= 232448


def test_prologue_span_counts_the_taps_reach():
    """A 32-wide tile of a halved level reads 2 x (32 + 10) columns, and
    the blur's 1 on each side: 86; at scale 1 (no resize) 42 + 2 = 44."""
    assert fk.prologue_span(224, 112, 3, 11, True) == 86
    assert fk.prologue_span(224, 224, 3, 11, False) == 44
    # A zero-weight tap reads its first tap's column (frames >= 0).
    idx, wt = fk._resize_index(90, 30)
    assert (wt[1] == 0).any()
    assert ((wt[1] != 0) | (idx[1] == idx[0])).all()


# -- (f) sequences and batches ----------------------------------------------

@pytest.mark.parametrize("h,w", SIZES)
def test_sequence_is_the_pair_form(h, w):
    frames = torch.from_numpy(_frames(7, 4, h, w))
    seq = tfb.farneback_sequence(frames)
    assert seq.shape == (3, h, w, 2)
    assert torch.equal(seq, tfb.farneback(frames[:-1], frames[1:]))
    if (h, w) == (67, 93):      # the odd size, against the reference
        ref = jax.jit(functools.partial(
            jfb.farneback_sequence, cfg=jax_config.FarnebackConfig(),
            use_pallas=False))(jnp.asarray(frames.numpy()))
        assert _epe(seq.numpy(), ref) < FLOW_TOL


def test_batched_sequences_do_not_pair_across_windows():
    a = torch.from_numpy(_frames(8, 4, 40, 56))
    b = torch.from_numpy(_frames(9, 4, 40, 56))
    both = tfb.farneback_sequence(torch.stack([a, b]))
    assert both.shape == (2, 3, 40, 56, 2)
    assert torch.equal(both[0], tfb.farneback_sequence(a))
    assert torch.equal(both[1], tfb.farneback_sequence(b))


# -- (g) the pipeline -------------------------------------------------------

WIDTH, CLASSES, STACK = 8, 5, 3
CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=72, crop=64, flow_stack=STACK),
    window=5, num_classes=CLASSES, flow_algo="farneback")


@pytest.fixture(scope="module")
def two_stream():
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK, width=WIDTH)

    def init(module, in_channels, seed):
        return jax.jit(module.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 32, 32, in_channels)))

    variables = {"spatial": init(jm.spatial, 3, 0),
                 "temporal": init(jm.temporal, 2 * STACK, 1)}
    tm = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               width=WIDTH)
    tm.load_state_dict(two_stream_flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _clip(t=5, h=80, w=96, step=(2, 1)):
    return np.stack(moving_square_frames(t, h, w, step=step))


def test_classify_window_farneback_matches_reference(two_stream):
    jm, variables, tm = two_stream
    frames = _clip()
    ref = np.asarray(jax_pipeline.classify_window(
        jnp.asarray(frames), variables, jm, _jax_cfg(CFG)))
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, CFG)
    assert ours.shape == (CLASSES,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_classify_batch_farneback_is_per_window(two_stream):
    """A window's flow, and so its answer, is the same alone and beside
    another window."""
    _, _, tm = two_stream
    a, b = _clip(), _clip(step=(-1, 2))
    batch = pipeline.classify_batch(torch.from_numpy(np.stack([a, b])), tm,
                                    CFG)
    for i, w in enumerate((a, b)):
        one = pipeline.classify_window(torch.from_numpy(w), tm, CFG)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), atol=1e-6)
    x = pipeline._crop(torch.from_numpy(np.stack([a, b])), CFG)
    stacks = pipeline._flow_stacks(x, CFG, plain=False)
    assert torch.equal(stacks[1],
                       pipeline._flow_stacks(x[1:], CFG, plain=False)[0])


@pytest.mark.parametrize("algo", ["farneback", "tvl1"])
def test_flow_from_frames_matches_reference(algo):
    cfg = dataclasses.replace(CFG, flow_algo=algo, tvl1=dataclasses.replace(
        CFG.tvl1, nscales=2, warps=1, outer_iterations=2,
        inner_iterations=3, epsilon=0.0))
    # Smooth texture: on the flat background of the moving square the
    # 2x2 solve rests on its 1e-3 regulariser alone and amplifies
    # rounding, which says nothing about the port.
    gray = _frames(11, 3, 80, 96).round().astype(np.uint8)
    frames = np.repeat(gray[..., None], 3, axis=-1)
    ref = jax_pipeline.flow_from_frames(jnp.asarray(frames), _jax_cfg(cfg))
    ours = pipeline.flow_from_frames(torch.from_numpy(frames), cfg)
    assert ours.shape == (2, 80, 96, 2)
    # TV-L1 at the bound tests/test_torch_models.py holds its batch to.
    assert _epe(ours.numpy(), ref) < (FLOW_TOL if algo == "farneback"
                                      else 1e-3)


def test_compute_flow_pairs_matches_sequence():
    gray = torch.from_numpy(_frames(10, 3, 40, 56))
    pairs = pipeline.compute_flow(gray[:-1], gray[1:], CFG)
    assert pairs.shape == (2, 40, 56, 2)
    assert torch.equal(pairs, pipeline.compute_flow_sequence(gray, CFG))
