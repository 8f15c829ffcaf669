"""``tools/torch_flow_quality.py``, the port's flow-quality shoot-out, on the
CPU at 96², 2 pairs a batch, against ``tools/flow_quality.py`` and the JAX
package.

- Its four numpy families and its ``smooth_image`` are bit-equal to the
  reference tool's (loaded by path; it imports JAX only in ``main``) and to
  ``tests/fixtures.smooth_image``.
- Each algorithm's EPE per family, through the tool's ``measure_epe``, equals
  the EPE of the JAX package's flow on the same arrays (affine and blobs from
  the JAX ``synthetic_pair``, given to both): Farneback at
  ``FarnebackConfig()`` within 1e-4 px (measured ≤ 1.5e-6, on squares),
  TV-L1 at a small config with ε = 0 within 1e-3 (measured ≤ 2.5e-8; with
  ε > 0 the reference's XLA solver stops a batch on its slowest pair, the
  port each pair on its own), SpyNet on the bundled weights within 1e-4
  (measured ≤ 1.1e-7).
- ``main`` with ``--device cpu`` prints the reference's per-algorithm lines,
  JSON keys and table header."""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import smooth_image as fixture_smooth_image
from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH, VAL_BATCHES = 96, 2, 2
TV_SMALL = TVL1Config(nscales=2, warps=1, outer_iterations=2,
                      inner_iterations=3, epsilon=0.0)
TOL = {"farneback": 1e-4, "tvl1": 1e-3, "spynet": 1e-4}
KEYS = {"epe_affine", "epe_blobs", "epe_rotzoom", "epe_squares",
        "epe_largedisp", "epe_brightness", "pairs_per_sec"}
HEADER = ("| algo | EPE affine | EPE blobs | EPE rotzoom | EPE squares | "
          "EPE largedisp† | EPE brightness† | pairs/s @224² |")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    env = dict(os.environ)
    try:
        spec.loader.exec_module(mod)
    finally:
        # The reference tool sets a JAX cache directory when imported.
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("torch_flow_quality", "tools/torch_flow_quality.py")


@pytest.fixture(scope="module")
def ref_tool():
    return _load("flow_quality", "tools/flow_quality.py")


@pytest.mark.parametrize("family", ["rotzoom", "squares", "largedisp",
                                    "brightness"])
def test_numpy_families_are_the_references(tool, ref_tool, family):
    ours = getattr(tool, f"{family}_batch")
    ref = getattr(ref_tool, f"_{family}_batch")
    a = ours(np.random.default_rng(123), BATCH, HW, HW)
    b = ref(np.random.default_rng(123), BATCH, HW, HW)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert next(name for name, _, _ in tool.HELD_OUT
                if name == family) == family
    rng = [np.random.default_rng(5) for _ in range(2)]
    assert np.array_equal(tool.smooth_image(rng[0], 30, 40, blur=7, pad=3),
                          fixture_smooth_image(rng[1], 30, 40, blur=7, pad=3))


@pytest.fixture(scope="module")
def shared_families(tool):
    """The tool's families with affine and blobs replaced by the JAX
    ``synthetic_pair``'s batches (the reference tool's keys)."""
    from video_analytics_tpu.models.spynet import synthetic_pair
    fams = tool.families(HW, BATCH, VAL_BATCHES)
    for regime, blobs in (("affine", 0), ("blobs", 2)):
        draw = jax.jit(lambda key, n=blobs: synthetic_pair(
            key, BATCH, HW, HW, local_blobs=n))
        fams[regime] = (0, [tuple(np.array(t) for t in draw(
            jax.random.fold_in(jax.random.PRNGKey(777 + blobs), i)))
            for i in range(VAL_BATCHES)])
    assert [len(b) for _, b in fams.values()] == [2, 2, 1, 1, 1, 1]
    return fams


def _jax_flow(algo):
    """The JAX package's flow function as the reference tool builds it,
    on torch tensors; SpyNet's weights restored into an abstract template
    (the values are the checkpoint's either way)."""
    from video_analytics_tpu.config import FarnebackConfig as JFb
    from video_analytics_tpu.config import TVL1Config as JTv
    from video_analytics_tpu.flow.farneback import farneback_jit
    from video_analytics_tpu.flow.tvl1 import tvl1_jit
    from video_analytics_tpu.models.spynet import (
        SpyNet, default_spynet_checkpoint, init_spynet)
    from video_analytics_tpu.runtime.checkpoint import load_variables

    if algo == "spynet":
        model = SpyNet(levels=4)
        tmpl = jax.eval_shape(lambda k: init_spynet(model, k),
                              jax.random.PRNGKey(0))
        params = load_variables(default_spynet_checkpoint(),
                                {"params": tmpl["params"]})["params"]
        fn = jax.jit(lambda a, b: model.apply({"params": params}, a, b))
    elif algo == "tvl1":
        cfg = JTv(nscales=2, warps=1, outer_iterations=2, inner_iterations=3,
                  epsilon=0.0)
        fn = jax.jit(lambda a, b: tvl1_jit(a, b, cfg))
    else:
        fn = jax.jit(lambda a, b: farneback_jit(a, b, JFb()))
    return lambda a, b: torch.from_numpy(np.array(
        fn(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))


@pytest.mark.parametrize("algo", ["farneback", "tvl1", "spynet"])
def test_epe_per_family_matches_the_jax_flow(tool, shared_families, algo):
    fns, _ = tool.flow_functions("cpu", tvl1_cfg=TV_SMALL,
                                 fb_cfg=FarnebackConfig())
    ours = tool.measure_epe(fns[algo], shared_families, "cpu")
    ref = tool.measure_epe(_jax_flow(algo), shared_families, "cpu")
    assert set(ours) == set(ref) == KEYS - {"pairs_per_sec"}
    for k in ours:
        assert np.isfinite(ours[k]) and ours[k] > 0, (k, ours[k])
        assert abs(ours[k] - ref[k]) < TOL[algo], (k, ours[k], ref[k])


def test_main_prints_the_references_lines(tool, monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(["--hw", str(HW), "--batch", "1", "--val-batches",
                        "1", "--reps", "1", "--device", "cpu"],
                       tvl1_cfg=TV_SMALL,
                       fb_cfg=FarnebackConfig(levels=1, iterations=1))
    lines = out.getvalue().strip().splitlines()
    assert rc == 0
    assert [ln.split(":")[0] for ln in lines[:3]] == ["spynet", "tvl1",
                                                      "farneback"]
    device = json.loads(lines[3])
    assert device["device"] == "cpu" and device["card"] == "cpu"
    assert device["launches_per_call"] == {"spynet": {}, "tvl1": {},
                                           "farneback": {}}
    res = json.loads(lines[4])
    assert set(res) == {"hw", "batch", "spynet_checkpoint", "spynet", "tvl1",
                        "farneback"}
    assert res["hw"] == HW and res["batch"] == 1
    for algo in ("spynet", "tvl1", "farneback"):
        assert set(res[algo]) == KEYS and res[algo]["pairs_per_sec"] > 0
    assert HEADER in lines
    assert lines[lines.index(HEADER) + 1] == "|---" * 7 + "|---|"
    assert [ln.split(" | ")[0] for ln in lines[lines.index(HEADER) + 2:][:3]
            ] == ["| spynet", "| tvl1", "| farneback"]
    # The default device is the card; without one the tool fails.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main([])
