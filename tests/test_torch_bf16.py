"""The reference's reduced-precision CNN in the port: ``dtype=bfloat16``
activations with float32 parameters, held against the JAX package run
with ``dtype=jnp.bfloat16`` on the same inputs and weights.

Sizes: width 8, 5 classes, 64² inputs, ``flow_stack`` 3, TV-L1 at ε = 0
(the port stops each pair on its own ε test, the reference's batched XLA
solver the whole batch on its slowest pair; at ε = 0 neither stops).

Two references.  The port rounds to bfloat16 wherever the reference's
flax modules declare it: each convolution's output, each BatchNorm's,
each residual add's.  XLA on the CPU compiles the reference with
``xla_allow_excess_precision``, which keeps a convolution's float32
result into the BatchNorm after it and drops that rounding; cuDNN, like
XLA on a GPU, writes the convolution's output in bfloat16.  Features and
logits are therefore held to ``TOL_REL`` of the largest magnitude of both
the reference as XLA runs it by default and the reference compiled with
every rounding it declares (``strict``); probabilities to an absolute
bound, tighter against the strict reference.  The train step is held to
the strict reference alone.  JAX's own bfloat16 differs from its float32 by 0.5-0.9 % of
the largest magnitude on these models, so closeness alone cannot tell a
bfloat16 port from a float32 one: every case also asserts that bfloat16
ran (each float32 feature or logit the port returns is a bfloat16 value,
and at least ``MIN_BIT_EQUAL`` of them equal the strict reference's bit
for bit).  The values measured on the CPU are written beside each case.
"""

import copy
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_analytics_tpu import config as jax_config
from video_analytics_tpu.models import resnet as jax_resnet
from video_analytics_tpu.models import spynet as jax_spynet
from video_analytics_tpu.models.convert import fold_batchnorm as jax_fold
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.ops import preprocess as jax_pp
from video_analytics_tpu.runtime import pipeline as jax_pipeline
from video_analytics_tpu.runtime import train as jax_train
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.models import resnet as port_resnet
from video_analytics_tpu_torch.models import spynet as port_spynet
from video_analytics_tpu_torch.models.convert import (
    flax_to_torch, fold_batchnorm, torch_to_flax)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.runtime import checkpoint, pipeline
from video_analytics_tpu_torch.runtime import train as port_train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
WIDTH = 8
CLASSES = 5
STACK = 3
HW = 64
TOL_REL = 2e-2
TOL_PROBS = 1e-3
# classify_window's probabilities.  Against the strict reference: measured
# 3e-8 (TV-L1) and 2.7e-5 (Farneback); the float32 model on the same
# weights is 7.3e-4-7.9e-4 away, so this bound fails a float32 port.
# Against the default compile, which keeps some float32 intermediates:
# measured 9.4e-4 and 8.1e-4, the default and the strict compile being
# 8.3e-4-9.4e-4 apart; about three times that spread.
TOL_PROBS_STRICT = 1e-4
TOL_PROBS_DEFAULT = 3e-3
MIN_BIT_EQUAL = 0.5
STRICT = {"xla_allow_excess_precision": False}
PRE = PreprocessConfig(resize_short=72, crop=HW, flow_stack=STACK)
CFGS = {"tvl1": PipelineConfig(
            preprocess=PRE, window=4, num_classes=CLASSES,
            tvl1=TVL1Config(nscales=3, warps=2, outer_iterations=3,
                            inner_iterations=5, median_filtering=5,
                            epsilon=0.0)),
        "farneback": PipelineConfig(
            preprocess=PRE, window=5, num_classes=CLASSES,
            flow_algo="farneback",
            farneback=FarnebackConfig(levels=2, iterations=2))}


def _jax_cfg(cfg: PipelineConfig) -> jax_config.PipelineConfig:
    """The JAX package's config with the port config's values."""
    return jax_config.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jax_config.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": jax_config.FarnebackConfig(
            **dataclasses.asdict(cfg.farneback)),
        "tvl1": jax_config.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, in_channels, seed):
    """flax variables, with BatchNorm statistics drawn about flax's
    defaults (mean 0, var 1) so that their conversion is exercised."""
    v = _numpy(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 32, 32, in_channels))))
    rng = np.random.default_rng(seed + 100)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                   else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def both(fn, *args, **static):
    """The jitted reference `fn` on `args` (its static arguments by
    keyword), compiled as XLA does by default and compiled with every
    declared rounding (``STRICT``)."""
    lowered = fn.lower(*args, **static)
    return tuple(_numpy(lowered.compile(compiler_options=opts)(*args))
                 for opts in ({}, STRICT))


def rel_err(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def assert_bf16_close(ours: torch.Tensor, refs, tol: float = TOL_REL):
    """`ours` is float32 holding bfloat16 values, within `tol` of the
    largest magnitude of both references (default, strict), and at least
    MIN_BIT_EQUAL of it equal to the strict one bit for bit.  Returns
    (error against the default, against the strict, bit-equal share)."""
    ref, strict = refs
    assert ours.dtype == torch.float32 and strict.dtype == np.float32
    assert tuple(ours.shape) == ref.shape == strict.shape
    assert torch.equal(ours, ours.bfloat16().float()), "not bfloat16 values"
    got = ours.numpy()
    errs = rel_err(got, ref), rel_err(got, strict)
    same = float((got == strict).mean())
    assert max(errs) <= tol and same >= MIN_BIT_EQUAL, (errs, same)
    return (*errs, same)


# -- the ResNets ------------------------------------------------------------

# Measured on the CPU, largest over the cases, against the default and the
# strict reference: features 9.6e-3 and 6.1e-3, logits 1.3e-2 and 7.1e-3
# of the largest magnitude; 60-100 % bit-equal to the strict one (ResNet-18
# with BatchNorm: features 76 %, logits 60 %).  Folded: 0 and 100 %.
@pytest.mark.parametrize("folded", [False, True], ids=["bn", "folded"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_resnet_bf16_matches_flax(arch, folded):
    jm = getattr(jax_resnet, arch)(num_classes=CLASSES, in_channels=4,
                                   dtype=jnp.bfloat16, width=WIDTH)
    tm = getattr(port_resnet, arch)(num_classes=CLASSES, in_channels=4,
                                    dtype=BF16, width=WIDTH)
    assert jm.dtype == jnp.bfloat16 and tm.dtype == BF16
    variables = _init(jm, 4, 3)
    if folded:
        variables = _numpy(jax_fold(variables))
        jm, tm = jm.clone(fold_bn=True), tm.clone(fold_bn=True)
        assert tm.dtype == BF16 and tm.fold_bn
    tm.load_state_dict(flax_to_torch(variables))
    tm.eval()
    x = np.random.default_rng(4).normal(0, 1, (2, HW, HW, 4)
                                        ).astype(np.float32)
    # Features and logits in one program: XLA computes the trunk once.
    refs = both(jax.jit(lambda v, a: (jm.apply(v, a, return_features=True),
                                      jm.apply(v, a))),
                variables, jnp.asarray(x))
    for i, (features, shape) in enumerate(((True, (2, tm.feature_dim)),
                                           (False, (2, CLASSES)))):
        with torch.no_grad():
            ours = tm(torch.from_numpy(x), return_features=features)
        assert tuple(ours.shape) == shape
        assert_bf16_close(ours, (refs[0][i], refs[1][i]))
    for p in tm.parameters():
        assert p.dtype == torch.float32


def test_resnet_float32_default_unchanged():
    """The default dtype is float32, and a bfloat16 model's answers are
    not its float32 twin's on the same weights."""
    rng = np.random.default_rng(1)
    tm = port_resnet.resnet18(num_classes=CLASSES, width=WIDTH).init(
        torch.Generator().manual_seed(1)).eval()
    tb = port_resnet.resnet18(num_classes=CLASSES, width=WIDTH,
                              dtype=BF16).eval()
    tb.load_state_dict(tm.state_dict())
    assert tm.dtype == torch.float32
    x = torch.from_numpy(rng.normal(0, 1, (2, HW, HW, 3)).astype(np.float32))
    with torch.no_grad():
        f32, bf = tm(x, return_features=True), tb(x, return_features=True)
    assert not torch.equal(f32, f32.bfloat16().float())
    assert not torch.equal(f32, bf)
    assert float((f32 - bf).abs().max() / f32.abs().max()) < TOL_REL


# -- flow stacking ------------------------------------------------------------

def test_stacked_flow_input_bf16_is_bit_equal():
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 12, (7, 9, 11, 2)).astype(np.float32)
    ref = jax_pp.stacked_flow_input(jnp.asarray(flow), STACK, 20.0,
                                    dtype=jnp.bfloat16, stride=2)
    ours = pp.stacked_flow_input(torch.from_numpy(flow), STACK, 20.0,
                                 dtype=BF16, stride=2)
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert np.array_equal(ours.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))
    # Casting before the stacking is casting the stacks.
    assert torch.equal(ours, pp.stacked_flow_input(
        torch.from_numpy(flow), STACK, 20.0, stride=2).to(BF16))


# -- the two-stream model and the classifier ----------------------------------

@pytest.fixture(scope="module")
def two_stream():
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK,
                      dtype=jnp.bfloat16, width=WIDTH)
    variables = {"spatial": _init(jm.spatial, 3, 0),
                 "temporal": _init(jm.temporal, 2 * STACK, 1)}
    tm = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               dtype=BF16, width=WIDTH)
    tm.load_flax_variables(variables)
    return jm, variables, tm.eval()


# Measured on the CPU: per-frame logits 7.9e-3 of the largest against the
# default reference, bit-equal to the strict one; per-stack 5.9e-3 and
# bit-equal; clip logits 1.9e-3 and 3.1e-3; fused probabilities 3.1e-4.
def test_two_stream_heads_bf16_match(two_stream):
    rng = np.random.default_rng(3)
    jm, variables, tm = two_stream
    assert tm.spatial.dtype == tm.temporal.dtype == BF16
    frames = rng.normal(0, 1, (3, HW, HW, 3)).astype(np.float32)
    stacks = rng.normal(0, 0.5, (2, HW, HW, 2 * STACK)).astype(np.float32)
    with torch.no_grad():
        per_frame = tm.spatial(torch.from_numpy(frames))
        per_stack = tm.temporal(torch.from_numpy(stacks))
        s = tm.spatial_logits(torch.from_numpy(frames))
        t = tm.temporal_logits(torch.from_numpy(stacks))
    assert_bf16_close(per_frame, both(jax.jit(jm.spatial.apply),
                                      variables["spatial"],
                                      jnp.asarray(frames)))
    assert_bf16_close(per_stack, both(jax.jit(jm.temporal.apply),
                                      variables["temporal"],
                                      jnp.asarray(stacks)))
    s_ref = jax.jit(jm.spatial_logits)(variables, jnp.asarray(frames))
    t_ref = jax.jit(jm.temporal_logits)(variables, jnp.asarray(stacks))
    assert s.dtype == t.dtype == torch.float32
    for ours, ref in ((s, s_ref), (t, t_ref)):
        assert rel_err(ours.numpy(), np.asarray(ref)) <= TOL_REL
    np.testing.assert_allclose(tm.fuse(s, t).numpy(),
                               np.asarray(jm.fuse(s_ref, t_ref)),
                               rtol=0, atol=TOL_PROBS)
    tf = tm.folded()
    assert tf.spatial.dtype == tf.temporal.dtype == BF16


def _clip(t, h=80, w=96):
    from tests.fixtures import moving_square_frames
    return np.stack(moving_square_frames(t, h, w, step=(2, 1)))


# Measured on the CPU: see TOL_PROBS_STRICT and TOL_PROBS_DEFAULT; the flow
# features bit-equal to the strict reference's.
@pytest.mark.parametrize("algo", ["tvl1", "farneback"])
def test_classify_window_bf16_matches_reference(two_stream, algo):
    """The whole classifier, and the flow-stream features (crop, flow,
    stacking in bfloat16, CNN) of the same window."""
    jm, variables, tm = two_stream
    cfg, jcfg = CFGS[algo], _jax_cfg(CFGS[algo])
    frames = _clip(cfg.window)
    default, strict = both(jax_pipeline.classify_window, jnp.asarray(frames),
                           variables, model=jm, cfg=jcfg)
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, cfg)
    assert ours.dtype == torch.float32 and ours.shape == (CLASSES,)
    np.testing.assert_allclose(ours.numpy(), strict, rtol=0,
                               atol=TOL_PROBS_STRICT)
    np.testing.assert_allclose(ours.numpy(), default, rtol=0,
                               atol=TOL_PROBS_DEFAULT)
    # The features against the strict reference alone (the probabilities
    # above hold the default one too): one compile of the flow path fewer.
    ours_f = pipeline.flow_features(torch.from_numpy(frames), tm.temporal,
                                    cfg)
    strict_f = np.asarray(jax_pipeline.flow_features.lower(
        jnp.asarray(frames), variables["temporal"], model=jm.temporal,
        cfg=jcfg).compile(compiler_options=STRICT)(
            jnp.asarray(frames), variables["temporal"]))
    assert_bf16_close(ours_f, (strict_f, strict_f))


# -- training -----------------------------------------------------------------

LR = 0.05


def test_sgd_step_bf16_matches_reference():
    """One SGD step of a bfloat16 ResNet-18 against the reference's
    ``make_train_step`` with ``optax.sgd``, compiled with every declared
    rounding: gradients reach every float32 parameter through the casts,
    and the loss is on float32 logits.

    Measured on the CPU against the strict reference: loss equal; every
    leaf moved, its update within 2.2e-2 of the leaf's largest update
    (bound 0.1) and at a cosine of at least 0.9997 with the reference's
    (bound 0.99); 1.3e-2 relative L2 over all parameters (bound 0.05);
    running statistics 1.6e-7 of their largest (bound 1e-5).  For scale,
    the reference's float32 step is 0.76 of a leaf's largest update and a
    cosine of 0.89 away from its strict bfloat16 one, and its default
    compile 0.82 and 0.81: a leaf the port left untouched would be 1.0
    away."""
    rng = np.random.default_rng(5)
    jm = jax_resnet.resnet18(num_classes=CLASSES, dtype=jnp.bfloat16,
                             width=WIDTH)
    variables = _init(jm, 3, 5)
    tx = optax.sgd(LR, momentum=0.9)
    state = jax_train.create_train_state(jm, jax.tree_util.tree_map(
        jnp.asarray, variables), tx)
    x = rng.normal(0, 1, (4, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, 4).astype(np.int32)
    args = (state, jnp.asarray(x), jnp.asarray(y))
    new, metrics = jax_train.make_train_step(jm, tx).lower(*args).compile(
        compiler_options=STRICT)(*args)
    after = _numpy({"params": new.params, "batch_stats": new.batch_stats})

    tm = port_resnet.resnet18(num_classes=CLASSES, dtype=BF16, width=WIDTH)
    tm.load_state_dict(flax_to_torch(variables))
    logits = copy.deepcopy(tm).train()(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.bfloat16().float())
    ts = port_train.create_train_state(tm, LR)
    got = port_train.make_train_step(ts.model, ts.optimizer)(
        torch.from_numpy(x), torch.from_numpy(y))
    ours = torch_to_flax(tm.state_dict())
    assert float(got["loss"]) == pytest.approx(float(metrics["loss"]),
                                               rel=1e-4)
    ours_u, ref_u = [], []
    for (path, b), o, t in zip(jax.tree_util.tree_leaves_with_path(variables),
                               jax.tree_util.tree_leaves(ours),
                               jax.tree_util.tree_leaves(after)):
        assert o.dtype == np.float32, path
        if path[0].key == "batch_stats":
            assert rel_err(o, t) <= 1e-5, path
            continue
        u, r = (o - b).ravel(), (t - b).ravel()
        assert np.abs(u).max() > 0, path
        assert np.abs(u - r).max() <= 0.1 * np.abs(r).max(), path
        cosine = float(u.astype(np.float64) @ r / (np.linalg.norm(u)
                                                   * np.linalg.norm(r)))
        assert cosine >= 0.99, (path, cosine)
        ours_u.append(u)
        ref_u.append(r)
    ours_u, ref_u = np.concatenate(ours_u), np.concatenate(ref_u)
    assert np.linalg.norm(ours_u - ref_u) / np.linalg.norm(ref_u) <= 0.05


# -- SpyNet -----------------------------------------------------------------

# Measured on the CPU: residual flow 3.3e-3 and 1.6e-3 of the largest;
# 97 % and 99 % bit-equal to the strict reference.
@pytest.mark.parametrize("level", [0, 3])
def test_spynet_level_bf16_matches_reference(level):
    rng = np.random.default_rng(6 + level)
    jnet = jax_spynet.SpyNet(levels=4, dtype=jnp.bfloat16)
    jv = _numpy(jax.jit(jnet.init)(jax.random.PRNGKey(level),
                                   jnp.zeros((1, 16, 16)),
                                   jnp.zeros((1, 16, 16))))
    net = port_spynet.SpyNet(levels=4, dtype=BF16).load_flax_variables(jv)
    assert net.nets[level].dtype == BF16
    x = rng.normal(0, 1, (2, 24, 20, 4)).astype(np.float32)
    apply = jax.jit(lambda v, a: jnet.apply(
        v, a, method=lambda m, a: m.nets[level](a)))
    with torch.no_grad():
        ours = net.nets[level](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_bf16_close(ours.permute(0, 2, 3, 1).contiguous(),
                      both(apply, jv, jnp.asarray(x)))
    assert all(p.dtype == torch.float32 for p in net.parameters())


# -- parameters stay float32 --------------------------------------------------

def test_bf16_checkpoint_loads_bit_for_bit_into_float32(tmp_path):
    """A bfloat16 model's variables are float32 and cross to a float32
    model bit for bit through a checkpoint file, and back."""
    bf = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                               dtype=BF16, width=WIDTH).init(
        torch.Generator().manual_seed(2))
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in bf.state_dict().values())
    leaves = jax.tree_util.tree_leaves(bf.flax_variables())
    assert leaves and all(a.dtype == np.float32 for a in leaves)
    path = str(tmp_path / "bf16.msgpack")
    checkpoint.save_variables(path, bf.flax_variables())
    f32 = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                                width=WIDTH)
    f32.load_flax_variables(checkpoint.load_variables(
        path, f32.flax_variables()))
    for k, v in bf.state_dict().items():
        assert torch.equal(f32.state_dict()[k], v), k
    back = TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                                 dtype=BF16, width=WIDTH)
    back.load_flax_variables(f32.flax_variables())
    for k, v in bf.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    folded = bf.folded()
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(folded.flax_variables()))
    assert fold_batchnorm(bf.flax_variables()["spatial"]).keys() == {
        "params"}


def test_port_casts_no_module_and_uses_no_autocast():
    """The casts are explicit, in ``forward``: no ``torch.autocast`` and
    no module cast to bfloat16 anywhere in the port."""
    code = re.compile(r"autocast\(|torch\.(cuda\.)?amp\b|(model|module|net|"
                      r"self)\.(to\(torch\.bfloat16\)|bfloat16\(\))")
    hits = []
    for d, _, files in os.walk(os.path.join(REPO,
                                            "video_analytics_tpu_torch")):
        for f in (f for f in files if f.endswith(".py")):
            with open(os.path.join(d, f)) as fh:
                hits += [f"{f}:{i}: {line.strip()}"
                         for i, line in enumerate(fh, 1)
                         if code.search(line)]
    assert not hits, hits
