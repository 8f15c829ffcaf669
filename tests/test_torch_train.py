"""The port's training path on the CPU, held against the JAX package on
the same inputs and weights: the random crop and flip given JAX's draws,
BatchNorm in training mode (flax's running statistics), ``build_examples``
(Farneback, and TV-L1 at ε = 0: with ε > 0 the reference's XLA solver
stops a batch on its slowest pair, the port each pair on its own), three
SGD steps per stream, and a trained checkpoint read back by the JAX
package.  Small sizes: crop 32, ``flow_stack`` 5, width 16, batch 4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.fixtures import moving_square_frames
from video_analytics_tpu import config as jc
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.ops import preprocess as jpp
from video_analytics_tpu.runtime import train_two_stream as jtts
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.models.resnet import BatchNorm2d
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.runtime import train_two_stream as tts
from video_analytics_tpu_torch.runtime.pipeline import classify_window

torch.set_num_threads(1)

CLASSES = 3
STACK = 5
WIDTH = 16
BATCH = 4
LR = 0.05
PRE = PreprocessConfig(resize_short=36, crop=32, flow_stack=STACK,
                       random_crop=True, random_flip=True)
CFGS = {"farneback": PipelineConfig(
            preprocess=PRE, window=STACK + 1, num_classes=CLASSES,
            flow_algo="farneback",
            farneback=FarnebackConfig(levels=2, iterations=2, winsize=9)),
        "tvl1": PipelineConfig(
            preprocess=PRE, window=STACK + 1, num_classes=CLASSES,
            flow_algo="tvl1",
            tvl1=TVL1Config(nscales=2, warps=1, outer_iterations=2,
                            inner_iterations=3, epsilon=0.0))}
# Flow tolerances in px (PERF.md section 2's parity limits), applied to
# stacks divided by flow_bound: Farneback max 1e-4; TV-L1 at ε = 0 mean
# 1e-3, max 0.05.  They hold the port against the reference's steps run
# one by one.  The reference's jitted build_examples is itself a little
# off those steps: XLA fuses the whole program's Farneback operations
# otherwise than compute_flow's alone, and on this scene its stacks
# differ from its own compute_flow's by up to 6.6e-3 px (mean 4e-5).
# Against it the port is held to mean 1e-4 and max 0.01 px.
FB_TOL = 1e-4
FB_JIT_MEAN_TOL, FB_JIT_MAX_TOL = 1e-4, 0.01
TV_MEAN_TOL, TV_MAX_TOL = 1e-3, 0.05
# RGB inputs: both resize with float32 weights; 1e-3 on [0, 255] is
# 1e-3 / 255 / min(std) after normalisation.
RGB_TOL = 1e-3 / 255 / 0.224


def _jax_cfg(cfg: PipelineConfig) -> jc.PipelineConfig:
    """The JAX package's config with the port config's values."""
    return jc.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jc.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": jc.FarnebackConfig(**dataclasses.asdict(cfg.farneback)),
        "tvl1": jc.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


def jax_draws(key, batch: int, h: int, w: int, crop: int, flip: bool):
    """The (tops, lefts, flips) that the reference's ``build_examples``
    draws from `key` for a batch: ``split(key, batch)``, then per window
    ``split(k, 3)`` and ``randint`` / ``randint`` / ``bernoulli``, as
    ``random_crop_flip`` draws them."""
    tops, lefts, flips = [], [], []
    for k in jax.random.split(key, batch):
        k1, k2, k3 = jax.random.split(k, 3)
        tops.append(int(jax.random.randint(k1, (), 0, h - crop + 1)))
        lefts.append(int(jax.random.randint(k2, (), 0, w - crop + 1)))
        flips.append(bool(jax.random.bernoulli(k3)) if flip else False)
    return (torch.tensor(tops), torch.tensor(lefts), torch.tensor(flips))


def _windows(batch: int, t: int, h: int = 48, w: int = 64, seed: int = 0):
    """(batch, t, h, w, 3) uint8 windows of moving textured squares."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack(moving_square_frames(
        t, h, w, step=(int(rng.integers(-2, 3)), int(rng.integers(-2, 3))),
        size=14, start=(20, 16), seed=int(rng.integers(1000))))
        for _ in range(batch)])


# -- (a) the random crop and flip ---------------------------------------------

@pytest.mark.parametrize("flip", [True, False])
def test_crop_flip_matches_reference_given_its_draws(flip, rng):
    x = rng.uniform(0, 255, (6, 3, 20, 27, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, len(x))
    want = np.asarray(jax.vmap(lambda w, k: jpp.random_crop_flip(
        w, 16, k, flip=flip))(jnp.asarray(x), keys))
    draws = jax_draws(key, len(x), 20, 27, 16, flip)
    if flip:
        assert draws[2].any() and not draws[2].all()
    got = pp.crop_flip(torch.from_numpy(x), *draws, 16)
    assert np.array_equal(got.numpy(), want)


def test_sample_crop_flip_in_range_and_reproducible():
    draws = pp.sample_crop_flip(torch.Generator().manual_seed(5), 500, 40,
                                52, 32, True)
    again = pp.sample_crop_flip(torch.Generator().manual_seed(5), 500, 40,
                                52, 32, True)
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    tops, lefts, flips = draws
    assert tops.min() == 0 and tops.max() == 40 - 32
    assert lefts.min() == 0 and lefts.max() == 52 - 32
    assert 150 < int(flips.sum()) < 350
    _, _, none = pp.sample_crop_flip(torch.Generator().manual_seed(5), 50,
                                     40, 52, 32, False)
    assert not none.any()
    with pytest.raises(ValueError):
        pp.sample_crop_flip(torch.Generator(), 2, 30, 52, 32, True)
    x = torch.zeros((2, 1, 40, 52, 3))
    with pytest.raises(ValueError, match="outside"):
        pp.crop_flip(x, torch.tensor([0, 9]), torch.tensor([0, 0]),
                     torch.tensor([False, False]), 32)


# -- (b) BatchNorm in training mode -------------------------------------------

def _flax_bn_step(x_nhwc, scale, bias, mean, var):
    import flax.linen as fnn
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    y, mutated = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        x_nhwc, mutable=["batch_stats"])
    return (np.asarray(y), np.asarray(mutated["batch_stats"]["mean"]),
            np.asarray(mutated["batch_stats"]["var"]))


def _torch_bn_step(cls, x_nhwc, scale, bias, mean, var):
    bn = cls(x_nhwc.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    y = bn.train()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


def test_train_mode_batchnorm_keeps_flax_statistics(rng):
    """n = 4 values per channel (a batch of 4 at 1×1, the last stage of a
    small test): the stored variance is the biased one, as flax stores it,
    where nn.BatchNorm2d stores 4/3 of it.  1e-6."""
    c = 7
    x = rng.normal(0.3, 1.5, (4, 1, 1, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want = _flax_bn_step(x, scale, bias, mean, var)
    got = _torch_bn_step(BatchNorm2d, x, scale, bias, mean, var)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    # The comparison tells the two rules apart: nn.BatchNorm2d's stored
    # variance is off by far more than the tolerance.
    plain = _torch_bn_step(torch.nn.BatchNorm2d, x, scale, bias, mean, var)
    assert np.abs(plain[2] - want[2]).max() > 1e-2


def test_eval_mode_batchnorm_is_unchanged(rng):
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 4, 4)).astype(np.float32))
    ours, theirs = BatchNorm2d(5).eval(), torch.nn.BatchNorm2d(5).eval()
    with torch.no_grad():
        for bn in (ours, theirs):
            bn.running_mean.fill_(0.2)
            bn.running_var.fill_(1.7)
            bn.weight.fill_(0.9)
    assert torch.equal(ours(x), theirs(x))


# -- (c) build_examples ---------------------------------------------------------

def _reference_steps(windows, key, jcfg):
    """The reference's build_examples for "both", step by step
    (``video_analytics_tpu/runtime/train_two_stream.py:76-91``), each step
    a call of its own: resize, the vmapped crop and flip, gray,
    ``compute_flow`` on the B·L pairs, the stack, its normalisation."""
    from video_analytics_tpu.runtime.pipeline import compute_flow
    pre = jcfg.preprocess
    B, T = windows.shape[:2]
    L = pre.flow_stack
    x = jpp.resize_short_side(jnp.asarray(windows), pre.resize_short)
    x = jax.vmap(lambda w, k: jpp.random_crop_flip(
        w, pre.crop, k, flip=pre.random_flip))(x, jax.random.split(key, B))
    rgb = jpp.normalize(x[:, T // 2], pre.mean, pre.std)
    gray = jpp.rgb_to_gray(x)
    c = gray.shape[-1]
    flow = compute_flow(gray[:, :L].reshape(B * L, c, c),
                        gray[:, 1:L + 1].reshape(B * L, c, c), jcfg)
    stacks = flow.reshape(B, L, c, c, 2).transpose(0, 2, 3, 1, 4)
    return {"rgb": np.asarray(rgb), "flow": np.asarray(
        jpp.normalize_flow_stack(stacks.reshape(B, c, c, 2 * L),
                                 pre.flow_bound))}


def _flow_err_ok(got, want, algo, jitted):
    err = np.abs(got - want) * PRE.flow_bound
    if algo == "tvl1":
        ok = err.mean() < TV_MEAN_TOL and err.max() < TV_MAX_TOL
    elif jitted:
        ok = err.mean() < FB_JIT_MEAN_TOL and err.max() < FB_JIT_MAX_TOL
    else:
        ok = err.max() < FB_TOL
    return ok, (algo, jitted, float(err.mean()), float(err.max()))


@pytest.mark.parametrize("algo", ["farneback", "tvl1"])
def test_build_examples_matches_reference(algo):
    cfg = CFGS[algo]
    windows = _windows(BATCH, STACK + 1)
    key = jax.random.PRNGKey(11)
    h, w = pp.short_side_hw(48, 64, PRE.resize_short)
    draws = jax_draws(key, BATCH, h, w, PRE.crop, True)
    assert draws[2].any() and not draws[2].all()
    jitted = jtts.build_examples(jnp.asarray(windows), key, _jax_cfg(cfg),
                                 "both")
    steps = _reference_steps(windows, key, _jax_cfg(cfg))
    x = torch.from_numpy(windows)
    got = {s: tts.build_examples(x, cfg, s, draws) for s in tts.STREAMS}
    assert set(got["rgb"]) == {"rgb"} and set(got["flow"]) == {"flow"}
    assert set(got["both"]) == {"rgb", "flow"}
    assert got["both"]["flow"].shape == (BATCH, 32, 32, 2 * STACK)
    for s in ("rgb", "both"):
        for want in (jitted["rgb"], steps["rgb"]):
            np.testing.assert_allclose(got[s]["rgb"].numpy(),
                                       np.asarray(want), rtol=0,
                                       atol=RGB_TOL)
    for s in ("flow", "both"):
        for want, is_jit in ((jitted["flow"], True), (steps["flow"], False)):
            ok, what = _flow_err_ok(got[s]["flow"].numpy(), np.asarray(want),
                                    algo, is_jit)
            assert ok, what
    assert torch.equal(got["rgb"]["rgb"], got["both"]["rgb"])
    assert torch.equal(got["flow"]["flow"], got["both"]["flow"])


def test_build_examples_rgb_stream_matches_reference():
    cfg = CFGS["farneback"]
    windows = _windows(BATCH, STACK + 1, seed=2)
    key = jax.random.PRNGKey(12)
    h, w = pp.short_side_hw(48, 64, PRE.resize_short)
    want = jtts.build_examples(jnp.asarray(windows), key, _jax_cfg(cfg),
                               "rgb")
    got = tts.build_examples(torch.from_numpy(windows), cfg, "rgb",
                             jax_draws(key, BATCH, h, w, PRE.crop, True))
    assert set(want) == set(got) == {"rgb"}
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               rtol=0, atol=RGB_TOL)


def test_build_examples_refuses_bad_input():
    cfg = CFGS["farneback"]
    x = torch.from_numpy(_windows(2, STACK))
    draws = pp.sample_crop_flip(torch.Generator(), 2, 36, 48, 32, True)
    with pytest.raises(ValueError, match="window"):
        tts.build_examples(x, cfg, "flow", draws)
    with pytest.raises(ValueError, match="stream"):
        tts.build_examples(x, cfg, "audio", draws)
    no_flip = dataclasses.replace(cfg, preprocess=dataclasses.replace(
        PRE, random_flip=False))
    flipped = (draws[0], draws[1], torch.tensor([True, False]))
    with pytest.raises(ValueError, match="random_flip"):
        tts.build_examples(x, no_flip, "rgb", flipped)
    assert tts.train_window_len(cfg) == STACK + 1
    drawn = tts.draw_crops(torch.Generator().manual_seed(1), x, no_flip)
    assert [d.shape for d in drawn] == [(2,)] * 3 and not drawn[2].any()


# -- (d) three SGD steps per stream -------------------------------------------

def _flax_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _load_reference_state(model, optimizer, state):
    """The reference's TrainState (params, batch statistics, optax's
    momentum trace) into a port stream and its SGD optimizer."""
    from video_analytics_tpu_torch.models.convert import flax_to_torch
    variables = _flax_numpy({"params": state.params,
                             "batch_stats": state.batch_stats})
    model.load_state_dict(flax_to_torch(variables))
    trace = flax_to_torch({"params": _flax_numpy(state.opt_state[0].trace),
                           "batch_stats": variables["batch_stats"]})
    for name, param in model.named_parameters():
        optimizer.state[param]["momentum_buffer"] = trace[name].clone()


@pytest.fixture(scope="module")
def trained_pair():
    """Three SGD steps per stream of the same two-stream model (width 16)
    by both packages on the same batches.  Each port step starts from the
    reference's state before that step (weights, statistics, momentum)
    and is compared with the reference's state after it: at a batch of 4
    the last stage's BatchNorms normalise 4 values each, and the steps are
    so sensitive that a 1e-7 relative change of the reference's own
    weights moves them by up to 0.35 after three steps.  Returns the JAX
    model, the reference's variables after the three steps, the port model
    (holding them too) and, per step, (stream, reference metrics, port
    metrics, reference state before, port state after, reference state
    after) with the states as flat {path: array} dicts."""
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK, width=WIDTH)
    variables = _flax_numpy(jm.init_variables(jax.random.PRNGKey(0),
                                              input_hw=(32, 32)))
    tm = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               width=WIDTH)
    tm.load_flax_variables(variables)
    tx = optax.sgd(LR, momentum=0.9)
    j_states = jtts.create_two_stream_states(jm, variables, tx, "both")
    j_steps = jtts.make_two_stream_train_steps(jm, tx, "both")
    t_states = tts.create_two_stream_states(tm, LR, "both")
    t_steps = tts.make_two_stream_train_steps(t_states)
    key = {"rgb": "spatial", "flow": "temporal"}

    def flat(state):
        return dict(_leaves(_flax_numpy({"params": state.params,
                                         "batch_stats": state.batch_stats})))

    rng = np.random.default_rng(4)
    steps = []
    for _ in range(3):
        x = {"rgb": rng.normal(0, 1, (BATCH, 32, 32, 3)),
             "flow": rng.uniform(-1, 1, (BATCH, 32, 32, 2 * STACK))}
        x = {k: v.astype(np.float32) for k, v in x.items()}
        y = rng.integers(0, CLASSES, BATCH).astype(np.int32)
        for name in ("rgb", "flow"):
            before = flat(j_states[name])
            _load_reference_state(t_states[name].model,
                                  t_states[name].optimizer, j_states[name])
            j_states[name], jm_ = j_steps[name](j_states[name],
                                                jnp.asarray(x[name]),
                                                jnp.asarray(y))
            tm_ = t_steps[name](torch.from_numpy(x[name]),
                                torch.from_numpy(y))
            ours = dict(_leaves(tts.two_stream_variables(tm)[key[name]]))
            steps.append((name, {k: float(v) for k, v in jm_.items()},
                          {k: float(v) for k, v in tm_.items()}, before,
                          ours, flat(j_states[name])))
    ref = jtts.two_stream_variables(variables, j_states)
    return jm, _flax_numpy(ref), tm, steps


def test_three_sgd_steps_match_reference(trained_pair):
    """Per step and stream: the loss to 1e-5 relative, the accuracy
    exactly; each parameter's update to 1e-3 of the update's largest
    element (the gradients of the two packages agree to ~2.5e-4 of a
    leaf's largest element: float32 convolutions summed in another order,
    through BatchNorms of 4 values); each BatchNorm statistic to 1e-4
    relative (flax takes the variance as E[x²] − E[x]², which cancels in
    float32 where the mean is large; the port as E[(x − E[x])²])."""
    _, ref, tm, steps = trained_pair
    assert len(steps) == 6
    for name, want, got, before, ours, theirs in steps:
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), name
        assert got["accuracy"] == want["accuracy"], name
        assert ours.keys() == theirs.keys() == before.keys()
        for path in ours:
            if path.startswith("/batch_stats"):
                np.testing.assert_allclose(ours[path], theirs[path],
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=path)
            else:
                update = np.abs(theirs[path] - before[path]).max()
                err = np.abs(ours[path] - theirs[path]).max()
                assert update > 0 and err <= 1e-3 * update, (name, path, err,
                                                             update)
    losses = [s[2]["loss"] for s in steps]
    assert len(set(losses)) == len(losses)       # the weights moved
    # The port model holds the reference's last state, up to the last
    # step's differences.
    ours = dict(_leaves(tts.two_stream_variables(tm)))
    assert ours.keys() == dict(_leaves(ref)).keys()


def test_create_train_state_refuses_folded_model():
    from video_analytics_tpu_torch.runtime.train import create_train_state
    m = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                              width=8).folded()
    with pytest.raises(ValueError, match="inference-only"):
        create_train_state(m.spatial, LR)


# -- (e) the checkpoint in the JAX package -----------------------------------

def test_trained_checkpoint_classifies_in_reference(trained_pair, tmp_path):
    """two_stream_variables → save_variables → the JAX package's
    load_variables and classify_window: the port's probabilities within
    1e-4 (Farneback flow, so no TV-L1 batch coupling)."""
    from video_analytics_tpu.runtime.checkpoint import load_variables
    from video_analytics_tpu.runtime.pipeline import (
        classify_window as jax_classify)
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables

    jm, _, tm, _ = trained_pair
    path = str(tmp_path / "trained.msgpack")
    save_variables(path, tts.two_stream_variables(tm))
    template = jm.init_variables(jax.random.PRNGKey(1), input_hw=(32, 32))
    variables = load_variables(path, template)
    cfg = dataclasses.replace(CFGS["farneback"], preprocess=dataclasses.replace(
        PRE, random_crop=False, random_flip=False))
    clip = _windows(1, STACK + 1, seed=7)[0]
    want = np.asarray(jax_classify(jnp.asarray(clip), variables, jm,
                                   _jax_cfg(cfg)))
    got = classify_window(torch.from_numpy(clip), tm.eval(), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
