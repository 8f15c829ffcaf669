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

from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.flow.tvl1 import tvl1
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
