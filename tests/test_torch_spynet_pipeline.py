"""Learned flow through the port's two-stream pipeline
(``flow_algo="spynet"``), held against the JAX package on the same
two-stream weights (the port's, converted) and the bundled SpyNet weights
(each package reading its own copy): ``compute_flow_sequence``,
``classify_window``, ``flow_features`` and ``build_examples`` with the
reference's crops; the missing-weights ``ValueError``; and, on the port
alone, batched against serial evaluation, a served request and a train
step fed by the frozen SpyNet.  Port twins of
``tests/test_spynet_pipeline.py``, at its sizes (a crop of 56, windows of
6 frames, stacks of 3) with ResNets of width 8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import moving_square_frames
from tests.test_torch_train import jax_draws
from video_analytics_tpu import config as jc
from video_analytics_tpu.models import spynet as jsn
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.runtime import checkpoint as jckpt
from video_analytics_tpu.runtime import pipeline as jpipe
from video_analytics_tpu.runtime import train_two_stream as jtts
from video_analytics_tpu_torch.config import PipelineConfig, PreprocessConfig
from video_analytics_tpu_torch.io.dataset import ClipRecord
from video_analytics_tpu_torch.io.video import synthesize_video
from video_analytics_tpu_torch.models.spynet import (
    SpyNet, default_spynet_checkpoint)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.runtime import evaluate as ev
from video_analytics_tpu_torch.runtime import pipeline
from video_analytics_tpu_torch.runtime import train_two_stream as tts
from video_analytics_tpu_torch.runtime.checkpoint import load_variables
from video_analytics_tpu_torch.runtime.serve import ClipServer

torch.set_num_threads(1)

CLASSES, STACK, WIDTH = 5, 3, 8
CFG = PipelineConfig(
    flow_algo="spynet",
    preprocess=PreprocessConfig(resize_short=64, crop=56, flow_stack=STACK),
    window=6, num_classes=CLASSES)
# Flow in px (the forward measured 1.2e-6 against the reference);
# features and probabilities as the TV-L1 and Farneback pipelines hold them.
TOL_FLOW = 1e-5
TOL_FEATURES = 2e-4
TOL_PROBS = 1e-4


def _jax_cfg(cfg: PipelineConfig) -> jc.PipelineConfig:
    """The JAX package's config with the port config's values."""
    return jc.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jc.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": jc.FarnebackConfig(**dataclasses.asdict(cfg.farneback)),
        "tvl1": jc.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


JAX_CFG = _jax_cfg(CFG)


@pytest.fixture(scope="module")
def nets():
    """(port two-stream, port SpyNet, JAX two-stream, JAX variables with
    the SpyNet's under "flow")."""
    tm = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               width=WIDTH)
    tm.init(torch.Generator().manual_seed(0)).eval()
    flow_net = SpyNet(levels=4)
    flow_net.load_flax_variables(load_variables(
        default_spynet_checkpoint(), flow_net.flax_variables())).eval()
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK, width=WIDTH)
    variables = tm.flax_variables()
    variables["flow"] = jckpt.load_variables(
        jsn.default_spynet_checkpoint(),
        {"params": jax.tree_util.tree_map(
            np.asarray, flow_net.flax_variables()["params"])})
    return tm, flow_net, jm, variables


def _frames(seed: int, t: int = 6):
    return np.random.default_rng(seed).integers(
        0, 255, (t, 64, 80, 3), dtype=np.uint8)


def test_compute_flow_sequence_matches_reference(nets):
    _, flow_net, _, variables = nets
    gray = np.random.default_rng(0).uniform(0, 255, (4, 56, 56)).astype(
        np.float32)
    ref = jax.jit(lambda g, v: jpipe.compute_flow_sequence(
        g, JAX_CFG, flow_variables=v))(jnp.asarray(gray), variables["flow"])
    with torch.no_grad():
        ours = pipeline.compute_flow_sequence(torch.from_numpy(gray), CFG,
                                              flow_net=flow_net)
        pairs = pipeline.compute_flow(torch.from_numpy(gray[:-1]),
                                      torch.from_numpy(gray[1:]), CFG,
                                      flow_net=flow_net)
    assert ours.shape == (3, 56, 56, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL_FLOW)
    assert torch.equal(ours, pairs)
    # plain=True changes nothing for SpyNet (it reaches no kernel).
    with torch.no_grad():
        plain = pipeline._sequence_flow(torch.from_numpy(gray)[None], CFG,
                                        True, flow_net)[0]
    assert torch.equal(plain, ours)


def test_spynet_needs_its_weights(nets):
    """Without ``flow_net`` every SpyNet entry raises a ValueError that
    names spynet, as the reference does without ``flow_variables``."""
    tm = nets[0]
    gray = torch.zeros((3, 56, 56))
    with pytest.raises(ValueError, match="spynet"):
        pipeline.compute_flow_sequence(gray, CFG)
    with pytest.raises(ValueError, match="spynet"):
        pipeline.compute_flow(gray[:-1], gray[1:], CFG)
    with pytest.raises(ValueError, match="spynet"):
        pipeline.classify_window(torch.from_numpy(_frames(1)), tm, CFG)
    with pytest.raises(ValueError, match="spynet"):
        pipeline.flow_features(torch.from_numpy(_frames(1)), tm.temporal,
                               CFG)


def test_classify_window_matches_reference(nets):
    tm, flow_net, jm, variables = nets
    frames = _frames(1)
    ref = np.asarray(jpipe.classify_window(jnp.asarray(frames), variables,
                                           jm, JAX_CFG))
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, CFG,
                                    flow_net=flow_net)
    assert ours.shape == (CLASSES,)
    assert abs(float(ours.sum()) - 1.0) < 1e-5 and bool((ours >= 0).all())
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL_PROBS)
    # A window gives its own probabilities inside a batch.
    other = _frames(5)
    batch = pipeline.classify_batch(
        torch.from_numpy(np.stack([frames, other])), tm, CFG,
        flow_net=flow_net)
    np.testing.assert_allclose(batch[0].numpy(), ours.numpy(), atol=1e-6)


def test_flow_features_matches_reference(nets):
    tm, flow_net, jm, variables = nets
    frames = _frames(2)
    ref = np.asarray(jpipe.flow_features(
        jnp.asarray(frames), variables["temporal"], jm.temporal, JAX_CFG,
        flow_variables=variables["flow"]))
    ours = pipeline.flow_features(torch.from_numpy(frames), tm.temporal, CFG,
                                  flow_net=flow_net)
    # 6 frames → 5 flows → 3 stacks of L = 3.
    assert ours.shape == ref.shape == (3, 8 * WIDTH)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL_FEATURES,
                               atol=TOL_FEATURES)


def test_build_examples_matches_reference(nets):
    """The flow stream's training inputs from frozen SpyNet flow, given the
    crops the reference draws from its key."""
    _, flow_net, _, variables = nets
    windows = np.random.default_rng(4).integers(0, 255, (2, 4, 64, 80, 3),
                                                dtype=np.uint8)
    key = jax.random.PRNGKey(0)
    ref = jtts.build_examples(jnp.asarray(windows), key, JAX_CFG, "flow",
                              flow_variables=variables["flow"])
    h, w = pp.short_side_hw(64, 80, CFG.preprocess.resize_short)
    draws = jax_draws(key, 2, h, w, CFG.preprocess.crop, False)
    ours = tts.build_examples(torch.from_numpy(windows), CFG, "flow", draws,
                              flow_net=flow_net)
    assert ours["flow"].shape == (2, 56, 56, 2 * STACK)
    err = (np.abs(ours["flow"].numpy() - np.asarray(ref["flow"]))
           * CFG.preprocess.flow_bound)
    assert err.max() < TOL_FLOW, err.max()
    with pytest.raises(ValueError, match="spynet"):
        tts.build_examples(torch.from_numpy(windows), CFG, "flow", draws)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("spynet_clips")
    records = []
    for i in range(4):
        p = str(d / f"c{i}.mp4")
        synthesize_video(p, moving_square_frames(10, 64, 80,
                                                 step=(2 - i % 3, 1)),
                         fps=10)
        records.append(ClipRecord(path=p, label=i % 3, class_name=str(i)))
    return records


def test_evaluate_batched_matches_evaluate(nets, clips):
    """The throughput path (threaded decode, one classify call per batch of
    clips) gives the clip-by-clip loop's counts."""
    tm, flow_net, _, _ = nets
    serial = ev.evaluate(clips, tm, CFG, "cpu", num_windows=2,
                         flow_net=flow_net)
    batched = ev.evaluate_batched(clips, tm, CFG, "cpu", batch_clips=4,
                                  num_windows=2, flow_net=flow_net)
    assert batched.total == serial.total == 4
    assert batched.correct == serial.correct and batched.failed == 0
    probs = ev.classify_clip_file(clips[0].path, tm, CFG, "cpu",
                                  num_windows=2, flow_net=flow_net)
    assert probs.shape == (CLASSES,) and abs(probs.sum() - 1.0) < 1e-5


def test_server_answers_with_spynet(nets, clips):
    """A served request runs the SpyNet it was given: its probabilities
    are the clip's through ``classify_clip_file``'s windows."""
    tm, flow_net, _, _ = nets
    server = ClipServer(tm, CFG, torch.device("cpu"), topk=2,
                        flow_net=flow_net, normalize=False)
    resp = server.handle_request({"path": clips[1].path, "id": 4})
    assert resp["id"] == 4 and len(resp["topk"]) == 2, resp
    wins, wcfg = ev.load_clip_windows(clips[1].path, CFG)
    want = pipeline.classify_window(torch.from_numpy(wins[0]), tm, wcfg,
                                    flow_net=flow_net)
    assert resp["topk"][0]["prob"] == pytest.approx(float(want.max()),
                                                    abs=1e-6)
    bare = ClipServer(tm, CFG, torch.device("cpu"), normalize=False)
    assert "spynet" in bare.handle_request({"path": clips[1].path})["error"]


def test_train_iter_with_frozen_spynet(nets):
    """One flow-stream step on SpyNet flow: the loss is finite, the flow
    stream's weights move and SpyNet's do not."""
    tm, flow_net, _, _ = nets
    model = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                                  width=WIDTH)
    model.load_flax_variables(tm.flax_variables())
    cfg = dataclasses.replace(CFG, preprocess=dataclasses.replace(
        CFG.preprocess, random_crop=True, random_flip=True))
    states = tts.create_two_stream_states(model, 0.01, "flow")
    spy_before = [p.clone() for p in flow_net.parameters()]
    temporal_before = model.temporal.conv1.weight.clone()
    windows = torch.from_numpy(np.random.default_rng(6).integers(
        0, 255, (2, 4, 64, 80, 3), dtype=np.uint8))
    feed = [(windows, torch.tensor([0, 3]))]
    metrics = list(tts.train_iter(feed, tts.make_two_stream_train_steps(
        states), cfg, "flow", torch.Generator().manual_seed(0),
        flow_net=flow_net))
    assert len(metrics) == 1 and np.isfinite(float(metrics[0]["flow"]["loss"]))
    assert not torch.equal(model.temporal.conv1.weight, temporal_before)
    assert all(torch.equal(a, b)
               for a, b in zip(flow_net.parameters(), spy_before))
    assert all(p.grad is None for p in flow_net.parameters())
