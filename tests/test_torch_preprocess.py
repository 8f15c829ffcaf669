"""The port's preprocessing and host-side clip shaping against the JAX
package: same uint8 frames from numpy seeds through both.  Resizes are
held to 1e-3 on [0, 255], the bound the reference states for its fused
resize + crop (ops/preprocess.py, resize_short_center_crop)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_analytics_tpu import config as jax_config
from video_analytics_tpu.ingest import windows as jw
from video_analytics_tpu.ops import preprocess as jp
from video_analytics_tpu.runtime.pipeline import sample_window as jax_sample
from video_analytics_tpu_torch.config import PipelineConfig, PreprocessConfig
from video_analytics_tpu_torch.ingest import windows as tw
from video_analytics_tpu_torch.ops import preprocess as tp
from video_analytics_tpu_torch.runtime.pipeline import sample_window

torch.set_num_threads(1)

# (H, W, short, crop): landscape, portrait, square, upscale, and the
# rounding-parity cases of the transport crop.
GEOMETRIES = [(120, 160, 72, 64), (160, 120, 72, 64), (96, 96, 72, 64),
              (50, 70, 72, 64), (121, 161, 64, 58), (90, 73, 64, 55),
              (256, 256, 256, 224)]


def _frames(rng, t, h, w):
    return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w,short,crop", GEOMETRIES)
def test_crop_source_geometry_matches(h, w, short, crop):
    assert tp.crop_source_geometry(h, w, short, crop) == \
        jp.crop_source_geometry(h, w, short, crop)


@pytest.mark.parametrize("h,w,short,crop", GEOMETRIES)
def test_resize_short_center_crop_matches(h, w, short, crop, rng):
    x = _frames(rng, 2, h, w)
    ref = np.asarray(jp.resize_short_center_crop(jnp.asarray(x), short,
                                                 crop))
    ours = tp.resize_short_center_crop(torch.from_numpy(x), short, crop)
    assert ours.shape == (2, crop, crop, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("h,w,short,crop", GEOMETRIES)
def test_resize_short_side_and_center_crop_match(h, w, short, crop, rng):
    """The two steps the stored-flow branch of extract-features takes one
    after the other, on two-channel float fields of about ±60: the resize
    within 1e-3 (the bound this file holds every resize to: the same
    weights, sums in another order), the crop the same window."""
    x = rng.normal(0, 15, (3, h, w, 2)).astype(np.float32)
    ref = jp.resize_short_side(jnp.asarray(x), short)
    ours = tp.resize_short_side(torch.from_numpy(x), short)
    assert tuple(ours.shape) == ref.shape and min(ours.shape[1:3]) == short
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)
    ref_c = np.asarray(jp.center_crop(ref, crop))
    ours_c = tp.center_crop(torch.from_numpy(np.array(ref)), crop)
    assert np.array_equal(ours_c.numpy(), ref_c)
    with pytest.raises(ValueError, match="center-crop"):
        tp.center_crop(ours, max(ours.shape[1:3]) + 1)


@pytest.mark.parametrize("fmt", ["flo", "jpg"])
def test_read_flow_dir_round_trip(fmt, tmp_path, rng):
    """What compute-flow writes, read back: .flo files to the bit, the
    quantized JPEG pairs within the quantization step plus JPEG's loss,
    and as the JAX package's reader reads them."""
    import cv2
    from video_analytics_tpu.io import flowio as jf
    from video_analytics_tpu_torch.io import flowio as tf
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    flows = np.stack([np.stack([8 * np.sin(xx / 9 + t), 6 * np.cos(yy / 7)],
                               axis=-1) for t in range(4)]).astype(np.float32)
    d = str(tmp_path / "flow")
    os.makedirs(d)
    for i, f in enumerate(flows):
        if fmt == "flo":
            tf.write_flo(os.path.join(d, f"flow_{i + 1:06d}.flo"), f)
        else:
            q = tf.quantize_flow(f, bound=20.0)
            assert np.array_equal(q, jf.quantize_flow(f, bound=20.0))
            for path, plane in zip(tf.flow_pair_paths(d, i + 1),
                                   (q[..., 0], q[..., 1])):
                cv2.imwrite(path, plane)
    assert tf.flow_pair_paths(d, 3) == jf.flow_pair_paths(d, 3)
    back = tf.read_flow_dir(d, bound=20.0)
    assert back.shape == flows.shape and back.dtype == np.float32
    assert np.array_equal(back, jf.read_flow_dir(d, bound=20.0))
    if fmt == "flo":
        assert np.array_equal(back, flows)
    else:
        assert np.abs(back - flows).max() < 0.5
        q = rng.integers(0, 256, (5, 6, 2), dtype=np.uint8)
        assert np.array_equal(tf.dequantize_flow(q, 20.0),
                              jf.dequantize_flow(q, 20.0))
    assert tf.read_flow_dir(d, max_flows=2).shape == (2, 40, 56, 2)
    with pytest.raises(IOError, match="no .flo"):
        tf.read_flow_dir(str(tmp_path))


@pytest.mark.parametrize("h,w", [(120, 160), (90, 73)])
def test_transport_crop_is_exact(h, w, rng):
    """Slicing on the host (ingest.windows.apply_transport_crop) and
    passing src_hw gives the same crop as the full frame, as in JAX."""
    cfg = PipelineConfig(preprocess=PreprocessConfig(resize_short=64,
                                                     crop=56))
    x = _frames(rng, 2, h, w)
    sl, cfg2 = tw.apply_transport_crop(x, cfg)
    ref_sl, ref_cfg2 = jw.apply_transport_crop(
        x, jax_config.PipelineConfig(preprocess=jax_config.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess))))
    assert np.array_equal(sl, ref_sl)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(ref_cfg2)
    full = tp.resize_short_center_crop(torch.from_numpy(x), 64, 56)
    via = tp.resize_short_center_crop(torch.from_numpy(sl), 64, 56,
                                      src_hw=cfg2.preprocess.src_hw)
    assert torch.equal(full, via)
    assert tw.apply_transport_crop(sl, cfg2) == (sl, cfg2)


def test_preprocess_clip_matches(rng):
    cfg = PreprocessConfig(resize_short=72, crop=64)
    x = _frames(rng, 3, 80, 100)
    ref = np.asarray(jp.preprocess_clip(
        jnp.asarray(x),
        jax_config.PreprocessConfig(**dataclasses.asdict(cfg))))
    ours = tp.preprocess_clip(torch.from_numpy(x), cfg).numpy()
    # 1e-3 on [0, 255] is 1e-3 / 255 / min(std) after normalisation.
    np.testing.assert_allclose(ours, ref, atol=1e-3 / 255 / 0.224)
    # The training branch: resize, then the crop and flip that the
    # reference draws from its key (split in 3: top, left, flip).
    import jax
    train = dataclasses.replace(cfg, random_crop=True, random_flip=True)
    with pytest.raises(ValueError, match="crops"):
        tp.preprocess_clip(torch.from_numpy(x), train)
    h, w = tp.short_side_hw(80, 100, 72)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        crops = (torch.tensor([int(jax.random.randint(k1, (), 0,
                                                      h - 64 + 1))]),
                 torch.tensor([int(jax.random.randint(k2, (), 0,
                                                      w - 64 + 1))]),
                 torch.tensor([bool(jax.random.bernoulli(k3))]))
        ref = np.asarray(jp.preprocess_clip(
            jnp.asarray(x),
            jax_config.PreprocessConfig(**dataclasses.asdict(train)), key))
        ours = tp.preprocess_clip(torch.from_numpy(x), train, crops).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-3 / 255 / 0.224)


def test_rgb_to_gray_and_flow_stacks_match(rng):
    x = _frames(rng, 2, 9, 11)
    np.testing.assert_allclose(
        tp.rgb_to_gray(torch.from_numpy(x)).numpy(),
        np.asarray(jp.rgb_to_gray(jnp.asarray(x))), atol=1e-3)
    flow = rng.normal(0, 15, (7, 9, 11, 2)).astype(np.float32)
    for stack, stride in ((3, 1), (2, 2)):
        ref = np.asarray(jp.stacked_flow_input(jnp.asarray(flow), stack,
                                               20.0, stride=stride))
        ours = tp.stacked_flow_input(torch.from_numpy(flow), stack, 20.0,
                                     stride=stride).numpy()
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("h,w,short,crop", [(120, 160, 64, 56),
                                            (160, 120, 64, 58),
                                            (64, 200, 64, 55),
                                            (256, 256, 256, 224)])
def test_host_normalize_square_matches(h, w, short, crop, rng):
    x = _frames(rng, 2, h, w)
    assert np.array_equal(tw.host_normalize_square(x, short, crop=crop),
                          jw.host_normalize_square(x, short, crop=crop))
    assert np.array_equal(tw.host_normalize_square(x, short),
                          jw.host_normalize_square(x, short))


def test_sample_window_matches():
    for n, win in ((40, 16), (16, 16), (5, 16)):
        assert np.array_equal(sample_window(n, win), jax_sample(n, win))
        assert np.array_equal(
            sample_window(n, win, np.random.default_rng(3)),
            jax_sample(n, win, np.random.default_rng(3)))


def test_normalize_and_gray_make_their_constants_once():
    """``normalize`` and ``rgb_to_gray`` make their constants on a device
    once: made from a host list on every call, each synchronised the
    device's stream."""
    x = torch.rand(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    x = x * 255
    tp._constant.cache_clear()
    for _ in range(2):
        got = tp.normalize(x, (0.1, 0.2, 0.3), (0.5, 0.25, 0.5))
        gray = tp.rgb_to_gray(x)
    info = tp._constant.cache_info()
    assert (info.misses, info.hits) == (3, 3)
    torch.testing.assert_close(got, (x / 255.0 - torch.tensor([0.1, 0.2, 0.3]))
                               / torch.tensor([0.5, 0.25, 0.5]))
    torch.testing.assert_close(gray, x @ torch.tensor([0.299, 0.587, 0.114]))
