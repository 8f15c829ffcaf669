"""The port's ResNets (18, 34, 50 and the folded-BatchNorm form),
two-stream model and classifier against the JAX package, on the same
weights: flax variables converted with
video_analytics_tpu_torch.models.convert.flax_to_torch.  Tolerances are
those tests/test_resnet.py holds the flax ResNet to against its torch
oracle (2e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_analytics_tpu import config as jax_config
from video_analytics_tpu.models import resnet as jax_resnet
from video_analytics_tpu.models.convert import fold_batchnorm as jax_fold
from video_analytics_tpu.models.convert import torch_resnet_to_flax
from video_analytics_tpu.models.resnet import flow_stream_resnet18 as jax_flow
from video_analytics_tpu.models.resnet import resnet18 as jax_resnet18
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.runtime import pipeline as jax_pipeline
from video_analytics_tpu_torch.config import (
    PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.models import resnet as port_resnet
from video_analytics_tpu_torch.models.convert import (
    flax_to_torch, fold_batchnorm, torch_to_flax, two_stream_flax_to_torch)
from video_analytics_tpu_torch.models.resnet import (
    flow_stream_resnet18, resnet18)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime import pipeline

torch.set_num_threads(1)

WIDTH = 8
CLASSES = 5
STACK = 3
CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=72, crop=64, flow_stack=STACK),
    window=4, num_classes=CLASSES,
    tvl1=TVL1Config(nscales=3, warps=2, outer_iterations=3,
                    inner_iterations=5, median_filtering=5, epsilon=0.0))


def _jax(cfg: PipelineConfig) -> jax_config.PipelineConfig:
    """The JAX package's config with the port config's values."""
    return jax_config.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jax_config.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": jax_config.FarnebackConfig(
            **dataclasses.asdict(cfg.farneback)),
        "tvl1": jax_config.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


JAX_CFG = _jax(CFG)


def _init(module, in_channels, seed):
    """flax variables, initialised jitted at a small input (the weights
    do not depend on the input size)."""
    x = jnp.zeros((1, 32, 32, in_channels))
    return jax.jit(module.init)(jax.random.PRNGKey(seed), x)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_batch_stats(variables, seed):
    """Non-trivial BatchNorm statistics, so the conversion of mean and
    var is exercised (flax initialises them to 0 and 1)."""
    rng = np.random.default_rng(seed)
    v = _numpy(variables)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                   else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def two_stream():
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK, width=WIDTH)
    variables = {"spatial": _init(jm.spatial, 3, 0),
                 "temporal": _init(jm.temporal, 2 * STACK, 1)}
    tm = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               width=WIDTH)
    tm.load_state_dict(two_stream_flax_to_torch(_numpy(variables)))
    return jm, variables, tm.eval()


@pytest.mark.parametrize("stream", ["rgb", "flow"])
def test_resnet_matches_flax(stream, rng):
    in_ch = 3 if stream == "rgb" else 2 * STACK
    jm = (jax_resnet18(num_classes=CLASSES, width=WIDTH) if stream == "rgb"
          else jax_flow(stack=STACK, num_classes=CLASSES, width=WIDTH))
    tm = (resnet18(num_classes=CLASSES, width=WIDTH) if stream == "rgb"
          else flow_stream_resnet18(stack=STACK, num_classes=CLASSES,
                                    width=WIDTH))
    variables = _randomize_batch_stats(_init(jm, in_ch, 2), 3)
    tm.load_state_dict(flax_to_torch(variables))
    tm.eval()
    x = rng.normal(0, 1, (2, 48, 48, in_ch)).astype(np.float32)
    apply = jax.jit(jm.apply, static_argnames="return_features")
    for features, shape in ((False, (2, CLASSES)),
                            (True, (2, tm.feature_dim))):
        ref = np.asarray(apply(variables, jnp.asarray(x),
                               return_features=features))
        with torch.no_grad():
            ours = tm(torch.from_numpy(x), return_features=features).numpy()
        assert ours.shape == ref.shape == shape
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("arch", ["resnet34", "resnet50"])
def test_deeper_resnets_match_flax(arch, rng):
    """ResNet-34 (BasicBlocks, 3-4-6-3) and ResNet-50 (Bottlenecks) on
    flax's weights: logits and penultimate features within 2e-4; and
    ``torch_to_flax`` gives the flax tree back, leaf for leaf."""
    jm = getattr(jax_resnet, arch)(num_classes=CLASSES, width=WIDTH,
                                   in_channels=4)
    tm = getattr(port_resnet, arch)(num_classes=CLASSES, width=WIDTH,
                                    in_channels=4)
    variables = _randomize_batch_stats(_init(jm, 4, 5), 6)
    tm.load_state_dict(flax_to_torch(variables))
    tm.eval()
    assert tm.feature_dim == jm.feature_dim == WIDTH * 8 * (
        4 if arch == "resnet50" else 1)
    _assert_same_tree(torch_to_flax(tm.state_dict()), variables)
    x = rng.normal(0, 1, (2, 40, 40, 4)).astype(np.float32)
    apply = jax.jit(jm.apply, static_argnames="return_features")
    for features in (False, True):
        ref = np.asarray(apply(variables, jnp.asarray(x),
                               return_features=features))
        with torch.no_grad():
            ours = tm(torch.from_numpy(x), return_features=features).numpy()
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_folded_resnet_matches_flax(arch, rng):
    """The folded-BatchNorm form: the port's ``fold_batchnorm`` gives the
    JAX package's folded tree (1e-6: the two divide and take the root in
    their own libraries), the folded port model agrees with the folded
    flax model on it within 2e-4, and both with the unfolded model."""
    jm = getattr(jax_resnet, arch)(num_classes=CLASSES, width=WIDTH)
    variables = _randomize_batch_stats(_init(jm, 3, 7), 8)
    folded_ref = _numpy(jax_fold(jax.tree_util.tree_map(jnp.asarray,
                                                        variables)))
    folded = fold_batchnorm(variables)
    assert set(folded) == {"params"}
    flat_ref = jax.tree_util.tree_leaves_with_path(folded_ref)
    flat = jax.tree_util.tree_leaves_with_path(folded)
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat, flat_ref):
        assert a.dtype == np.float32, path
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    tm = getattr(port_resnet, arch)(num_classes=CLASSES, width=WIDTH)
    tm.load_state_dict(flax_to_torch(variables))
    tf = tm.clone(fold_bn=True)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in tf.modules())
    tf.load_state_dict(flax_to_torch(folded))
    _assert_same_tree(torch_to_flax(tf.state_dict()), folded)
    tm.eval(), tf.eval()
    x = rng.normal(0, 1, (2, 40, 40, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.clone(fold_bn=True).apply)(
        folded_ref, jnp.asarray(x)))
    with torch.no_grad():
        ours = tf(torch.from_numpy(x)).numpy()
        unfolded = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours, unfolded, rtol=2e-4, atol=2e-4)


def test_two_stream_folded_matches_unfolded(two_stream, rng):
    """``TwoStreamModel.folded()`` answers as the model it was made from
    (2e-4) and as the JAX package's folded model on folded variables."""
    jm, variables, tm = two_stream
    tf = tm.folded()
    assert not tf.training
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in tf.modules())
    frames = rng.normal(0, 1, (3, 48, 48, 3)).astype(np.float32)
    stacks = rng.normal(0, 0.5, (2, 48, 48, 2 * STACK)).astype(np.float32)
    jf, fv = jm.folded(), JaxTS.fold_variables(variables)
    ref = jf.classify(fv, jnp.asarray(frames), jnp.asarray(stacks))
    with torch.no_grad():
        probs = [m.fuse(m.spatial_logits(torch.from_numpy(frames)),
                        m.temporal_logits(torch.from_numpy(stacks))).numpy()
                 for m in (tf, tm)]
    np.testing.assert_allclose(probs[0], np.asarray(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(probs[0], probs[1], rtol=2e-4, atol=2e-4)
    _assert_same_tree(tf.flax_variables(),
                      TwoStreamModel.fold_variables(tm.flax_variables()))


def test_flax_variables_round_trip(two_stream):
    """``flax_variables`` is the reference's tree: the one the model was
    loaded from, leaf for leaf; loading it again changes nothing."""
    _, variables, tm = two_stream
    _assert_same_tree(tm.flax_variables(), _numpy(variables))
    other = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                                  width=WIDTH)
    other.load_flax_variables(tm.flax_variables())
    for k, v in tm.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_flax_to_torch_inverts_torch_resnet_to_flax():
    """flax_to_torch is the inverse of the JAX package's converter."""
    tm = resnet18(num_classes=CLASSES, width=WIDTH).init(
        torch.Generator().manual_seed(4))
    sd = {k: v for k, v in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    back = flax_to_torch(_numpy(torch_resnet_to_flax(sd)))
    assert set(back) == set(tm.state_dict())
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_seeded_init_repeats():
    a = TwoStreamModel.create(CLASSES, STACK, width=WIDTH).init(
        torch.Generator().manual_seed(0))
    b = TwoStreamModel.create(CLASSES, STACK, width=WIDTH).init(
        torch.Generator().manual_seed(0))
    c = TwoStreamModel.create(CLASSES, STACK, width=WIDTH).init(
        torch.Generator().manual_seed(1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["spatial.conv1.weight"],
                           sc["spatial.conv1.weight"])


def test_two_stream_heads_match(two_stream, rng):
    jm, variables, tm = two_stream
    frames = rng.normal(0, 1, (3, 48, 48, 3)).astype(np.float32)
    stacks = rng.normal(0, 0.5, (2, 48, 48, 2 * STACK)).astype(np.float32)
    s_ref = jax.jit(jm.spatial_logits)(variables, jnp.asarray(frames))
    t_ref = jax.jit(jm.temporal_logits)(variables, jnp.asarray(stacks))
    with torch.no_grad():
        s = tm.spatial_logits(torch.from_numpy(frames))
        t = tm.temporal_logits(torch.from_numpy(stacks))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tm.fuse(s, t).numpy(),
                               np.asarray(jm.fuse(s_ref, t_ref)),
                               rtol=2e-4, atol=2e-4)


def _clip(t=4, h=80, w=96):
    from tests.fixtures import moving_square_frames
    return np.stack(moving_square_frames(t, h, w, step=(2, 1)))


def test_classify_window_matches_reference(two_stream):
    """The whole two-stream classifier at epsilon=0, where the port's
    per-image ε stop and the reference's batch-wide one agree."""
    jm, variables, tm = two_stream
    frames = _clip()
    ref = np.asarray(jax_pipeline.classify_window(jnp.asarray(frames),
                                                  variables, jm, JAX_CFG))
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, CFG)
    assert ours.shape == (CLASSES,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("stage", ["compute_flow_sequence", "rgb_features",
                                   "flow_features"])
def test_pipeline_stage_matches_reference(stage, two_stream):
    """Each stage the pipeline exposes, at epsilon=0: flow within the
    TV-L1 batch tolerance (1e-3 abs), features within 2e-4."""
    jm, variables, tm = two_stream
    frames = _clip()
    if stage == "compute_flow_sequence":
        gray = (frames.astype(np.float32) @ np.float32([0.299, 0.587, 0.114]))
        ref = jax_pipeline.compute_flow_sequence(jnp.asarray(gray), JAX_CFG)
        ours = pipeline.compute_flow_sequence(torch.from_numpy(gray), CFG)
        tol = dict(rtol=0, atol=1e-3)
    elif stage == "rgb_features":
        ref = jax_pipeline.rgb_features(jnp.asarray(frames),
                                        variables["spatial"], jm.spatial,
                                        JAX_CFG.preprocess)
        ours = pipeline.rgb_features(torch.from_numpy(frames), tm.spatial,
                                     CFG.preprocess)
        tol = dict(rtol=2e-4, atol=2e-4)
    else:
        ref = jax_pipeline.flow_features(jnp.asarray(frames),
                                         variables["temporal"], jm.temporal,
                                         JAX_CFG)
        ours = pipeline.flow_features(torch.from_numpy(frames), tm.temporal,
                                      CFG)
        tol = dict(rtol=2e-4, atol=2e-4)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)


def test_classify_batch_is_per_window(two_stream):
    """A batch of windows gives each window its own probabilities."""
    _, _, tm = two_stream
    a, b = _clip(), _clip()[::-1].copy()
    batch = pipeline.classify_batch(torch.from_numpy(np.stack([a, b])), tm,
                                    CFG)
    for i, w in enumerate((a, b)):
        one = pipeline.classify_window(torch.from_numpy(w), tm, CFG)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(),
                                   atol=1e-6)
    assert np.allclose(batch.sum(-1).numpy(), 1.0, atol=1e-5)


def test_unported_paths_raise(two_stream):
    _, _, tm = two_stream
    x = torch.from_numpy(_clip())
    with pytest.raises(ValueError, match="spynet"):
        pipeline.classify_window(
            x, tm, dataclasses.replace(CFG, flow_algo="spynet"))
    with pytest.raises(ValueError, match="unknown arch"):
        TwoStreamModel.create(arch="resnet101")
    for arch, dim in (("resnet34", 8 * WIDTH), ("resnet50", 32 * WIDTH)):
        m = TwoStreamModel.create(CLASSES, STACK, width=WIDTH, arch=arch)
        assert m.spatial.feature_dim == m.temporal.feature_dim == dim
        assert m.temporal.in_channels == 2 * STACK
