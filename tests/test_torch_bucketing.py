"""The port's 64-pixel bucket ladder (``ops/bucketing.py``) and
``compute-flow``'s default, which pads each pair to it, against the JAX
package: ``bucket_hw`` equal over a grid of shapes, ``bucketed_flow``
bit-equal on a flow function of the pixel values, and the default command
on the tiny clip (120×160, bucket 128×192) against the JAX command's
default.  Farneback and SpyNet within 1e-4 px where the flow is defined,
as tests/test_torch_cli.py holds them at the native size (measured 1.5e-6
and 2.4e-6); TV-L1 at ε = 0 (with ε > 0 the reference's XLA solver stops a
batch on its slowest pair) within tests/test_torch_tvl1.py's mean 1e-3 /
max 0.05 px (measured 2.6e-6 / 3.1e-4).  Bucketing moves the flow by up to
1.06 px against the native computation on this clip.  ``--no-bucket``
gives the native flow of the port's ``compute_flow`` bit for bit, and
``--exact`` changes nothing."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_analytics_tpu.cli.main import main as jax_main
from video_analytics_tpu.ops.bucketing import bucket_hw as jax_bucket_hw
from video_analytics_tpu.ops.bucketing import bucketed_flow as jax_bucketed
from video_analytics_tpu_torch.cli.main import _load_frames, main
from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.io.flowio import read_flo
from video_analytics_tpu_torch.ops.bucketing import (
    BUCKET_MULTIPLE, bucket_hw, bucketed_flow)
from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray
from video_analytics_tpu_torch.runtime.pipeline import compute_flow

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
CLIP = ["--max-frames", "3", "--batch", "2"]
ALGOS = {"farneback": ["--algo", "farneback", "--fb-levels", "1",
                       "--fb-iterations", "2"],
         "tvl1": ["--algo", "tvl1", "--tv-nscales", "2", "--tv-warps", "1",
                  "--tv-outer", "2", "--tv-inner", "3", "--tv-epsilon", "0"],
         "spynet": ["--algo", "spynet"]}       # the bundled weights


@pytest.mark.parametrize("hw", [(1, 1), (64, 64), (65, 129), (120, 160),
                                (240, 320), (1080, 1920)])
def test_bucket_hw_equals_the_reference(hw):
    assert BUCKET_MULTIPLE == 64
    assert bucket_hw(*hw) == jax_bucket_hw(*hw)
    assert bucket_hw(*hw, 16) == jax_bucket_hw(*hw, 16)


@pytest.mark.parametrize("hw", [(50, 70), (64, 128)])
def test_bucketed_flow_bit_equal(hw, rng):
    """Edge padding, one call of the flow function, the crop: bit-equal to
    the reference on a flow function of the pixel values, at a shape that
    pads on both axes and at one that is already a bucket (no padding)."""
    prev = rng.uniform(0, 255, (2, *hw)).astype(np.float32)
    nxt = rng.uniform(0, 255, (2, *hw)).astype(np.float32)
    shapes = []

    def ours_fn(a, b):
        shapes.append(tuple(a.shape))
        return torch.stack([b - a, a * 0.5], -1)

    ours = bucketed_flow(ours_fn, torch.from_numpy(prev),
                         torch.from_numpy(nxt))
    ref = jax_bucketed(lambda a, b: jnp.stack([b - a, a * 0.5], -1),
                       jnp.asarray(prev), jnp.asarray(nxt))
    assert shapes == [(2, *bucket_hw(*hw))]
    assert ours.shape == (2, *hw, 2)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def _flows(out_dir, n=2):
    return [read_flo(os.path.join(out_dir, f"flow_{i:06d}.flo"))
            for i in range(1, n + 1)]


@pytest.fixture()
def abstract_spynet_template(monkeypatch):
    """The JAX command restores SpyNet's weights into the structure of a
    freshly initialised model; an abstract one (``jax.eval_shape``) gives
    the same restored values without running the initialisation, which
    is ~20 s op by op on the CPU."""
    import jax
    from video_analytics_tpu.models import spynet as jax_spynet
    init = jax_spynet.init_spynet
    monkeypatch.setattr(jax_spynet, "init_spynet", lambda model, key: (
        jax.eval_shape(lambda k: init(model, k), key)))


@pytest.mark.parametrize("algo", ["farneback", "tvl1", "spynet"])
def test_default_compute_flow_matches_reference(tmp_path, tiny_clip, capsys,
                                                abstract_spynet_template,
                                                algo):
    """Both commands with their default bucketing on a 120×160 clip."""
    ours_dir, ref_dir = str(tmp_path / "ours"), str(tmp_path / "ref")
    args = [*CLIP, *ALGOS[algo]]
    assert main(["compute-flow", tiny_clip, ours_dir, *args, *CPU]) == 0
    assert jax_main(["compute-flow", tiny_clip, ref_dir, *args]) == 0
    capsys.readouterr()
    for ours, ref in zip(_flows(ours_dir), _flows(ref_dir)):
        assert ours.shape == ref.shape == (120, 160, 2)
        epe = np.linalg.norm(ours - ref, axis=-1)
        if algo == "tvl1":
            assert epe.mean() < 1e-3 and epe.max() < 0.05, (epe.mean(),
                                                            epe.max())
        elif algo == "spynet":
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
        else:
            # As at the native size: 1e-4 on the moving square, where the
            # flow is defined; the flat background rests on the regulariser.
            assert epe[12:30, 12:30].max() < 1e-4, epe[12:30, 12:30].max()
            assert np.abs(ours - ref).max() < 1e-2


def test_no_bucket_is_the_native_flow_and_exact_changes_nothing(
        tmp_path, tiny_clip, capsys):
    """--no-bucket writes compute_flow's flow at the native size to the
    bit; the default differs from it (in the border band the padding
    moves); --exact is accepted and leaves the output as it was."""
    from video_analytics_tpu_torch.cli.main import _flow_configs, build_parser
    argv = ["compute-flow", tiny_clip, "x", *CLIP, *ALGOS["farneback"], *CPU]
    fb, tv = _flow_configs(build_parser().parse_args(argv))
    cfg = PipelineConfig(flow_algo="farneback", farneback=fb, tvl1=tv)
    gray = rgb_to_gray(torch.from_numpy(_load_frames(tiny_clip, 3)))
    with torch.no_grad():
        native = compute_flow(gray[:2], gray[1:3], cfg).numpy()
    dirs = {}
    for name, extra in (("default", []), ("exact", ["--exact"]),
                        ("native", ["--no-bucket"]),
                        ("native_exact", ["--no-bucket", "--exact"])):
        dirs[name] = str(tmp_path / name)
        rc = main(["compute-flow", tiny_clip, dirs[name], *CLIP,
                   *ALGOS["farneback"], *extra, *CPU])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out["flows"] == 2
    flows = {name: np.stack(_flows(d)) for name, d in dirs.items()}
    assert np.array_equal(flows["native"], native)
    assert np.array_equal(flows["native_exact"], native)
    assert np.array_equal(flows["exact"], flows["default"])
    assert not np.array_equal(flows["default"], native)
