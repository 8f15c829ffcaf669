"""The cluster-resident TV-L1 solver (K-H ``pd_solve_warp``), the
whole-scale launch built on it (``pd_solve_scale``) and the bands'
device-side test (``band_flags``) of the port, on the CPU.

The CUDA kernels run only on a card (tests/test_torch_cuda.py,
chip_smoke.py).  Here: the size rule that picks the solver of a pyramid
level; the kernel's decomposition of an image into 8 or 16 strips, each
phase reading only the neighbour rows the kernel reads, restated in plain
PyTorch and held to ``pd_solve_plain`` to the bit; ``band_flags_plain``
against a numpy restatement of the reference's rule
(video_analytics_tpu/ops/pallas/tvl1_solve.py:1054-1070);
``pd_solve_scale_plain`` against the loop of three calls it replaces, and
``tvl1`` through it against the JAX package; and what the wrappers do
with CPU tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import smooth_pair
from video_analytics_tpu.config import TVL1Config as JaxTVL1Config
from video_analytics_tpu.flow.tvl1 import tvl1_jit
from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.flow import tvl1 as flow_tvl1
from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
from video_analytics_tpu_torch.ops.kernels import centered_gradient
from video_analytics_tpu_torch.ops.median import median_filter2d

torch.set_num_threads(1)

BLOCK_SMEM = 232448         # bytes of shared memory a block may have


# -- the size rule ------------------------------------------------------------

# (h, w, solver): the five serve sizes, 256², UCF101's native 240×320 and
# its pyramid, the sizes that need 16 blocks (up to the largest square
# level under the reference's whole-plane rule), the first size above that
# rule, two levels of 16 and 17 rows, and two wide ones: 20×4000 fits
# neither cluster size, 16×3200 fits 8 blocks without the constants.
LEVELS = [
    (224, 224, "warp"), (179, 179, "warp"), (143, 143, "warp"),
    (115, 115, "warp"), (92, 92, "warp"), (256, 256, "warp"),
    (240, 320, "warp"), (192, 256, "warp"), (154, 205, "warp"),
    (123, 164, "warp"), (98, 131, "warp"), (280, 280, "warp"),
    (280, 300, "warp"), (295, 296, "warp"), (296, 296, "chunked"),
    (1080, 1920, "chunked"), (16, 21, "warp"), (17, 40, "warp"),
    (20, 4000, "chain"), (16, 3200, "warp"),
]


def _state_bytes(h, w, blocks):
    """Shared memory of the six state planes of a strip, four halo rows
    and the scratch, in a cluster of `blocks`."""
    return 4 * ((6 * -(-h // blocks) + 4) * w + 64)


@pytest.mark.parametrize("h,w,solver", LEVELS)
def test_size_rule_names_the_solver(h, w, solver):
    assert flow_tvl1.level_solver(h, w, 5) == solver
    geom = ts.warp_geometry(h, w)
    if solver == "warp":
        rows, consts, smem, blocks = geom
        assert rows == -(-h // blocks)
        planes = 9 if consts else 6
        assert smem <= BLOCK_SMEM and smem >= (planes * rows + 4) * w * 4
        assert consts or (9 * rows + 4) * w * 4 > BLOCK_SMEM - 256
        # Eight blocks wherever eight hold the strips, else sixteen.
        assert blocks == 8 or (blocks == 16
                               and _state_bytes(h, w, 8) > BLOCK_SMEM)
        # The strips cover the rows exactly once; late ones may be empty.
        covered = []
        for r in range(blocks):
            y0 = min(r * rows, h)
            covered.extend(range(y0, min(y0 + rows, h)))
        assert covered == list(range(h))
        assert rows * w <= 20 * 512         # pixels a thread: 20 at most
    elif solver == "chain":
        assert geom is None
        assert flow_tvl1.whole_plane_level(h, w, 5)
        assert _state_bytes(h, w, 16) > BLOCK_SMEM


def test_pyramid_of_native_ucf101():
    """240x320 itself misses a cluster of eight by 3 KB (30 rows x 320 x 6
    planes and four halo rows of 320: 235,776 B of 232,448) and takes one
    of sixteen (15-row strips, the constants too: 178,176 B); the rest of
    its pyramid takes eight.  Every level runs the whole-scale launch."""
    cfg = TVL1Config()
    sizes = flow_tvl1._level_sizes(240, 320, cfg)
    assert sizes == [(240, 320), (192, 256), (154, 205), (123, 164),
                     (98, 131)]
    assert [flow_tvl1.level_solver(h, w, cfg.median_filtering)
            for h, w in sizes] == ["warp"] * 5
    assert _state_bytes(240, 320, 8) == 235776
    assert ts.warp_geometry(240, 320) == (15, True, 178176, 16)
    assert [ts.warp_geometry(h, w)[3] for h, w in sizes[1:]] == [8] * 4
    assert ts.warp_geometry(232, 320) == (29, False, 4 * (178 * 320 + 64), 8)
    assert ts.warp_geometry(224, 224) == (28, True, 229632, 8)
    assert ts.warp_geometry(256, 256) == (32, False, 200960, 8)
    assert ts.warp_geometry(280, 300) == (18, True, 199456, 16)
    assert ts.warp_geometry(295, 296) == (19, True, 207456, 16)
    assert ts.warp_geometry(20, 4000) is None


def test_level_solver_honours_a_caller_s_size_rule():
    never = lambda h, w, k: False
    assert flow_tvl1.level_solver(64, 64, 5, never) == "chunked"
    assert flow_tvl1.level_solver(1080, 1920, 5, lambda h, w, k: True) \
        == "chain"


# -- the strip decomposition --------------------------------------------------

def _strip_solve(prep, uv, cfg, blocks=None):
    """``pd_solve_warp``'s algorithm in plain PyTorch, one image at a
    time: `blocks` strips (``warp_geometry``'s, unless given) of
    ceil(H / blocks) rows, each holding only its own rows
    of the six state planes; phase A reads the last row of p12, p22 of the
    strip above, phase B the first row of un, vn of the strip below, the
    median two rows of each neighbour (clamped to the image); the ε sum is
    the strips' sums added in strip order.  Returns (flow, rounds run)."""
    l_t, theta, taut = ts._solver_constants(cfg)
    B, _, H, W = uv.shape
    blocks = blocks or ts.warp_geometry(H, W)[3]
    rows = -(-H // blocks)
    bounds = [(min(r * rows, H), min(min(r * rows, H) + rows, H))
              for r in range(blocks)]
    k = cfg.median_filtering if cfg.median_filtering > 1 else 0
    out, rounds_run = torch.empty_like(uv), []
    for b in range(B):
        const = [[prep[b, c, y0:y1] for c in range(4)] for y0, y1 in bounds]
        u = [uv[b, 0, y0:y1].clone() for y0, y1 in bounds]
        v = [uv[b, 1, y0:y1].clone() for y0, y1 in bounds]
        p = [[torch.zeros_like(s) for _ in range(4)] for s in u]
        rounds = 0
        for _ in range(cfg.outer_iterations):
            if k:
                # Rows y0-2 .. y1+1 of the raw planes, gathered from the
                # neighbours' strips, replicate border at the image's edges.
                new_u, new_v = [], []
                for r, (y0, y1) in enumerate(bounds):
                    if y0 == y1:
                        new_u.append(u[r]), new_v.append(v[r])
                        continue
                    ys = [min(max(y, 0), H - 1)
                          for y in range(y0 - k // 2, y1 + k // 2)]
                    for src, dst in ((u, new_u), (v, new_v)):
                        for y in ys:       # only own and adjacent strips
                            assert abs(y // rows - r) <= 1
                        win = torch.stack(
                            [src[y // rows][y % rows] for y in ys])
                        # median_filter2d pads by replication itself; its
                        # inner rows see exactly the gathered ones.
                        dst.append(median_filter2d(win[None], k)[0][
                            k // 2: k // 2 + (y1 - y0)])
                u, v = new_u, new_v
            for it in range(cfg.inner_iterations):
                sums = []
                for r, (y0, y1) in enumerate(bounds):       # phase A
                    if y0 == y1:
                        sums.append(torch.zeros(()))
                        continue
                    wx, wy, grad, rho_c = const[r]
                    p11, p12, p21, p22 = p[r]
                    th = l_t * grad
                    inv_grad = 1.0 / torch.clamp(grad, min=1e-10)
                    rho = rho_c + wx * u[r] + wy * v[r]
                    d = torch.where(rho < -th, l_t, torch.where(
                        rho > th, -l_t, -rho * inv_grad))
                    v1, v2 = u[r] + d * wx, v[r] + d * wy

                    def div(pa, pb, up):
                        d1 = torch.cat([pa[:, :1], pa[:, 1:] - pa[:, :-1]], 1)
                        top = pb[:1] if up is None else pb[:1] - up[None]
                        return d1 + torch.cat([top, pb[1:] - pb[:-1]], 0)

                    up12 = None if y0 == 0 else p[r - 1][1][-1]
                    up22 = None if y0 == 0 else p[r - 1][3][-1]
                    un = v1 + theta * div(p11, p12, up12)
                    vn = v2 + theta * div(p21, p22, up22)
                    sums.append(((un - u[r]) ** 2 + (vn - v[r]) ** 2).sum())
                    u[r], v[r] = un, vn
                for r, (y0, y1) in enumerate(bounds):       # phase B
                    if y0 == y1:
                        continue

                    def grad_of(x, below):
                        gx = torch.cat([x[:, 1:] - x[:, :-1],
                                        torch.zeros_like(x[:, :1])], 1)
                        last = (torch.zeros_like(x[:1]) if below is None
                                else below[None] - x[-1:])
                        return gx, torch.cat([x[1:] - x[:-1], last], 0)

                    ux, uy = grad_of(u[r], None if y1 == H else u[r + 1][0])
                    vx, vy = grad_of(v[r], None if y1 == H else v[r + 1][0])
                    inv_u = 1.0 / (1.0 + taut * torch.sqrt(ux * ux + uy * uy))
                    inv_v = 1.0 / (1.0 + taut * torch.sqrt(vx * vx + vy * vy))
                    p11, p12, p21, p22 = p[r]
                    p[r] = [(p11 + taut * ux) * inv_u,
                            (p12 + taut * uy) * inv_u,
                            (p21 + taut * vx) * inv_v,
                            (p22 + taut * vy) * inv_v]
            rounds += 1
            total = torch.zeros(())
            for s in sums:
                total = total + s
            if bool(total / (H * W) < cfg.epsilon * cfg.epsilon):
                break
        out[b, 0], out[b, 1] = torch.cat(u), torch.cat(v)
        rounds_run.append(rounds)
    return out, rounds_run


def _warp_inputs(seed, b, h, w, still=()):
    """Random warp constants and start flow; the images in `still` carry a
    residual and a flow of 1e-3 of the others', so they pass the ε test in
    the first rounds."""
    rng = np.random.default_rng(seed)
    wx = rng.normal(0, 1, (b, h, w)).astype(np.float32)
    wy = rng.normal(0, 1, (b, h, w)).astype(np.float32)
    rho = rng.normal(0, 1, (b, h, w)).astype(np.float32)
    uv = rng.normal(0, 0.5, (b, 2, h, w)).astype(np.float32)
    for i in still:
        rho[i] *= 1e-3
        uv[i] *= 1e-3
    prep = np.stack([wx, wy, wx ** 2 + wy ** 2, rho], axis=1)
    return torch.from_numpy(prep), torch.from_numpy(uv)


@pytest.mark.parametrize("h,w,median,blocks", [
    (16, 21, 5, None),  # eight strips of two rows
    (17, 24, 5, None),  # strips of 3, 3, 3, 3, 3, 2 and two empty ones
    (19, 16, 3, None),  # a last strip of one row
    (37, 29, 5, None),  # a last strip shorter than the others (2 of 5)
    (40, 33, 0, None),  # no median
    (37, 29, 5, 16),    # sixteen strips: 3 rows, the 13th of 1, 3 empty
    (64, 20, 3, 16),    # sixteen strips of four rows
])
def test_strip_decomposition_equals_plain_without_the_test(h, w, median,
                                                           blocks):
    """ε = 0: every round runs, every bit agrees."""
    cfg = TVL1Config(inner_iterations=4, outer_iterations=3, epsilon=0.0,
                     median_filtering=median)
    prep, uv = _warp_inputs(h, 2, h, w)
    got, rounds = _strip_solve(prep, uv, cfg, blocks)
    assert rounds == [3, 3]
    assert torch.equal(got, ts.pd_solve_plain(prep, uv, cfg))


@pytest.mark.parametrize("h,w,blocks", [(17, 24, None), (37, 29, None),
                                        (48, 40, None), (48, 40, 16)])
def test_strip_decomposition_equals_plain_with_per_image_stops(h, w, blocks):
    """With ε engaged each image leaves on its own round, and the state
    it leaves with is the plain version's to the bit."""
    cfg = TVL1Config(inner_iterations=5, outer_iterations=6, epsilon=0.05,
                     median_filtering=5)
    prep, uv = _warp_inputs(h + 1, 3, h, w, still=(1,))
    got, rounds = _strip_solve(prep, uv, cfg, blocks)
    assert rounds[1] < rounds[0] and rounds[1] < cfg.outer_iterations
    assert torch.equal(got, ts.pd_solve_plain(prep, uv, cfg))
    # An image's result does not depend on its batch.
    alone, r1 = _strip_solve(prep[1:2], uv[1:2], cfg, blocks)
    assert r1 == rounds[1:2] and torch.equal(alone[0], got[1])


# -- band_flags ---------------------------------------------------------------

def _reference_rule(err_band, band_px, n_px, eps2, adaptive):
    """numpy restatement of tvl1_solve_warp_banded's flags
    (ops/pallas/tvl1_solve.py:1054-1070): the image has converged when
    its bands' errors sum to under ε² a pixel; a band runs unless the image
    has converged or, when adaptive, it and its neighbours are each under
    ε² a pixel."""
    conv = err_band.sum(axis=1, dtype=np.float32) / np.float32(n_px) \
        < np.float32(eps2)
    if not adaptive:
        return np.repeat(~conv[:, None], err_band.shape[1], axis=1)
    active = err_band >= np.float32(eps2) * band_px
    padded = np.pad(active, ((0, 0), (1, 1)))
    run = padded[:, :-2] | padded[:, 1:-1] | padded[:, 2:]
    return run & ~conv[:, None]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("h,w,band,n_part", [(61, 96, 16, 6), (40, 33, 40, 1),
                                            (200, 50, 24, 9)])
def test_band_flags_plain_matches_reference_rule(h, w, band, n_part, adaptive):
    rng = np.random.default_rng(h + n_part)
    n_bands = -(-h // band)
    eps = 0.05
    band_px = np.array([min(band, h - band * i) * w for i in range(n_bands)],
                       dtype=np.float32)
    B = 4
    # Band sums on both sides of the band threshold, images on both sides of
    # theirs; image 3 did not run its odd bands and keeps their old errors.
    partial = (rng.uniform(0, 2, (B, n_bands, n_part)) * eps * eps * band * w
               / n_part).astype(np.float32)
    partial[0] *= 0.05
    partial[1] *= 5.0
    act = np.ones((B, n_bands), np.int32)
    act[3, 1::2] = 0
    act[2, 0] = 0                         # keeps the first round's inf
    old = (rng.uniform(0, 2, (B, n_bands)) * eps * eps * band * w
           ).astype(np.float32)
    old[2] = np.inf                       # the first round's state
    err_band = torch.from_numpy(old.copy())
    act_next = torch.full((B, n_bands), -1, dtype=torch.int32)
    ts.band_flags_plain(torch.from_numpy(partial), torch.from_numpy(act),
                        err_band, act_next, band, h, w, eps, adaptive)
    want_err = np.where(act.astype(bool),
                        partial.sum(axis=2, dtype=np.float32), old)
    np.testing.assert_allclose(err_band.numpy(), want_err, rtol=1e-6)
    want = _reference_rule(err_band.numpy(), band_px, h * w, eps * eps,
                           adaptive)
    assert np.array_equal(act_next.numpy().astype(bool), want)
    assert not want[0].any() and want[1].all() and want[2][:2].all()
    # The wrapper takes the plain version for CPU tensors.
    n = ts.band_flags.launches
    err2 = torch.from_numpy(old.copy())
    act2 = torch.empty_like(act_next)
    ts.band_flags(torch.from_numpy(partial), torch.from_numpy(act), err2,
                  act2, band, h, w, eps, adaptive)
    assert ts.band_flags.launches == n
    assert torch.equal(act2, act_next) and torch.equal(err2, err_band)


# -- the wrappers -------------------------------------------------------------

def test_pd_solve_warp_takes_the_plain_version_on_cpu():
    cfg = TVL1Config(inner_iterations=3, outer_iterations=2)
    prep, uv = _warp_inputs(0, 2, 20, 24)
    n = ts.pd_solve_warp.launches
    assert torch.equal(ts.pd_solve_warp(prep, uv, cfg),
                       ts.pd_solve_plain(prep, uv, cfg))
    assert ts.pd_solve_warp.launches == n
    # Even at a size no cluster holds: the rule is the CUDA launch's.
    prep, uv = _warp_inputs(1, 1, 20, 4000)
    one = dataclasses.replace(cfg, inner_iterations=1, outer_iterations=1)
    assert torch.equal(ts.pd_solve_warp(prep, uv, one),
                       ts.pd_solve_plain(prep, uv, one))


def test_tvl1_takes_each_level_s_solver(monkeypatch):
    """``tvl1`` asks ``level_solver`` for every level and calls the solver
    it names: here the finest level the chain, once per warp, the coarser
    one the whole-scale launch, once."""
    cfg = TVL1Config(nscales=2, warps=2, outer_iterations=2,
                     inner_iterations=3)
    calls = []

    def counted(name, fn):
        def wrapper(*args):
            calls.append((name, tuple(args[-2].shape[2:])))
            return fn(*args)
        return wrapper

    monkeypatch.setattr(flow_tvl1, "pd_solve_scale",
                        counted("warp", ts.pd_solve_scale))
    monkeypatch.setattr(flow_tvl1, "pd_solve", counted("chain", ts.pd_solve))
    monkeypatch.setattr(flow_tvl1, "warp_geometry",
                        lambda h, w: None if h * w > 1000
                        else (1, True, 0, 8))
    rng = np.random.default_rng(2)
    prev = torch.from_numpy(rng.uniform(0, 255, (1, 32, 40)).astype(np.float32))
    nxt = torch.roll(prev, 1, dims=2)
    out = flow_tvl1.tvl1(prev, nxt, cfg)
    assert calls == [("warp", (26, 32))] + [("chain", (32, 40))] * 2
    assert torch.equal(out, flow_tvl1.tvl1(prev, nxt, cfg, plain=True))


class _OnCard:
    """Stands in for a CUDA tensor where there is no card: what a wrapper
    reads before it checks its arguments."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, *shape):
        self.shape = torch.Size(shape)


def test_cuda_wrappers_refuse_what_they_cannot_launch():
    """For a tensor on the card a wrapper launches or raises; it never
    turns to the plain version.  A level that fits no cluster, and
    arguments the kernels do not take, raise before any launch."""
    cfg = TVL1Config()
    n = ts.pd_solve_warp.launches, ts.band_flags.launches
    n_scale = ts.pd_solve_scale.launches
    with pytest.raises(ValueError, match="does not fit"):
        ts.pd_solve_warp(_OnCard(1, 4, 20, 4000), _OnCard(1, 2, 20, 4000),
                         cfg)
    with pytest.raises(ValueError, match="does not fit"):
        ts.pd_solve_scale(_OnCard(1, 3, 20, 4000), _OnCard(1, 20, 4000),
                          _OnCard(1, 2, 20, 4000), cfg)
    with pytest.raises(ValueError, match="H, W >= 2"):
        ts.pd_solve_scale(_OnCard(1, 3, 1, 32), _OnCard(1, 1, 32),
                          _OnCard(1, 2, 1, 32), cfg)
    with pytest.raises(TypeError, match="expected a tensor"):
        ts.pd_solve_scale(_OnCard(1, 3, 224, 224), _OnCard(1, 224, 224),
                          _OnCard(1, 2, 224, 224), cfg)
    assert ts.pd_solve_scale.launches == n_scale
    with pytest.raises(TypeError, match="expected a tensor"):
        ts.pd_solve_warp(_OnCard(1, 4, 224, 224), _OnCard(1, 2, 224, 224),
                         cfg)
    with pytest.raises(ValueError, match="bands"):
        ts.band_flags(_OnCard(2, 3, 8), None, None, None, 16, 61, 96, 0.01,
                      True)
    with pytest.raises(TypeError, match="expected a tensor"):
        ts.band_flags(_OnCard(2, 4, 8), None, None, None, 16, 61, 96, 0.01,
                      True)
    assert (ts.pd_solve_warp.launches, ts.band_flags.launches) == n


# -- the whole-scale launch ---------------------------------------------------

def _scale_inputs(seed, b, h, w):
    """(i13, i0, uv) of one level: b smooth pairs a few pixels apart, the
    second frame with its centred gradient, and a start flow off by up to
    two pixels (some samples land outside the frame and are clamped)."""
    rng = np.random.default_rng(seed)
    pairs = [smooth_pair(np.random.default_rng(seed + i), h, w,
                         dx=1.5 - i, dy=0.8 * i - 1.0) for i in range(b)]
    i0 = torch.from_numpy(np.stack([p[0] for p in pairs]))
    i1 = torch.from_numpy(np.stack([p[1] for p in pairs]))
    i1x, i1y = centered_gradient(i1)
    i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
    uv = torch.from_numpy(rng.normal(0, 1.0, (b, 2, h, w)).astype(np.float32))
    return i13, i0, uv


@pytest.mark.parametrize("h,w,median,warps", [
    (20, 24, 5, 3), (17, 40, 3, 2), (33, 29, 0, 2), (24, 20, 5, 1),
    (20, 24, 3, 0)])
def test_pd_solve_scale_plain_is_the_three_call_loop(h, w, median, warps):
    """One scale through ``pd_solve_scale`` (its plain version, on the
    CPU) is the loop it replaces in ``flow/tvl1.py`` to the bit: per warp
    ``warp_prep`` and one warp's solve, then the scale-end median."""
    cfg = TVL1Config(warps=warps, inner_iterations=4, outer_iterations=3,
                     epsilon=0.02, median_filtering=median)
    i13, i0, uv = _scale_inputs(h, 2, h, w)
    want = uv
    for _ in range(warps):
        want = ts.pd_solve_warp(warp_prep(i13, i0, want), want, cfg)
    if median > 1:
        want = ts.median5(want, median)
    n = ts.pd_solve_scale.launches
    got = ts.pd_solve_scale(i13, i0, uv, cfg)
    assert ts.pd_solve_scale.launches == n       # a CPU tensor: no launch
    assert torch.equal(got, want)
    assert torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, cfg))
    assert not torch.equal(got, uv)
    # An image's result does not depend on its batch.
    alone = ts.pd_solve_scale(i13[1:], i0[1:], uv[1:], cfg)
    assert torch.equal(alone[0], got[1])


def test_pd_solve_scale_takes_the_plain_version_at_any_size_on_cpu():
    """Even at a size no cluster holds: the rule is the CUDA launch's."""
    cfg = TVL1Config(warps=1, inner_iterations=1, outer_iterations=1)
    i13, i0, uv = _scale_inputs(3, 1, 20, 4000)
    assert ts.warp_geometry(20, 4000) is None
    assert torch.equal(ts.pd_solve_scale(i13, i0, uv, cfg),
                       ts.pd_solve_scale_plain(i13, i0, uv, cfg))


FAST = TVL1Config(nscales=3, warps=2, outer_iterations=4,
                  inner_iterations=10, median_filtering=5)


@pytest.mark.parametrize("batch,epsilon", [(1, 0.01), (2, 0.0)])
def test_tvl1_through_the_scale_launch_matches_reference(batch, epsilon,
                                                         monkeypatch):
    """Every level of a 48x64 pair fits a cluster, so ``tvl1`` is
    ``pd_solve_scale`` per level and nothing else; against the JAX package
    at batch 1, and at ε = 0 in one batch (its solver couples the images
    of a batch through the ε test), at the bounds tests/test_torch_tvl1.py
    holds the flow to."""
    cfg = dataclasses.replace(FAST, epsilon=epsilon)
    levels = []
    real = ts.pd_solve_scale

    def counted(i13, i0, uv, c):
        levels.append(tuple(uv.shape[2:]))
        return real(i13, i0, uv, c)

    def never(*args, **kwargs):
        raise AssertionError("a level left the whole-scale launch")

    monkeypatch.setattr(flow_tvl1, "pd_solve_scale", counted)
    for name in ("pd_solve", "pd_solve_chunked", "warp_prep", "median5"):
        monkeypatch.setattr(flow_tvl1, name, never)
    pairs = [smooth_pair(np.random.default_rng(s), 48, 64, dx=dx, dy=dy)
             for s, (dx, dy) in zip(range(batch), [(1.2, -0.8), (-2.0, 1.5)])]
    prev = np.stack([p[0] for p in pairs])
    nxt = np.stack([p[1] for p in pairs])
    ours = flow_tvl1.tvl1(torch.from_numpy(prev), torch.from_numpy(nxt),
                          cfg).numpy()
    assert levels == [(31, 41), (38, 51), (48, 64)]
    ref = np.asarray(tvl1_jit(jnp.asarray(prev), jnp.asarray(nxt),
                              JaxTVL1Config(**dataclasses.asdict(cfg))))
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-3, epe.mean()
    assert epe.max() < 0.05, epe.max()


def test_grid_batch_guard_arithmetic():
    """The wrappers refuse a batch that would put more than 65,535 blocks
    on a grid's y or z dimension (``_build.expect_grid_batch``); the
    largest batch ``eval-ucf101 --batched`` gives one ``tvl1`` call, 8
    clips x 3 windows x 15 frame pairs, is far inside it."""
    from video_analytics_tpu_torch.ops.cuda import _build
    assert _build.GRID_YZ_MAX == 2 ** 16 - 1
    _build.expect_grid_batch(_build.GRID_YZ_MAX, "pd_solve_scale")
    _build.expect_grid_batch(8 * 3 * 15, "pd_solve_scale")
    with pytest.raises(ValueError, match="batch of 65536 .* holds 65535"):
        _build.expect_grid_batch(_build.GRID_YZ_MAX + 1, "pd_solve_scale")
    # On the CPU the wrappers take their plain versions, whatever the batch.
    x = torch.zeros((2, 1, 4, 4))
    assert torch.equal(ts.median5(x, 3), x)
