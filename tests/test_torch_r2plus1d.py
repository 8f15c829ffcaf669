"""The port's R(2+1)D-34 (``models/video_resnet``) against the plain
reference ``tests/torch_r2plus1d.py`` on the CPU, and ``classify_batch``
on streams that take clip volumes.

Seeded weights with BatchNorm statistics away from 0 and 1, at width 8
and 8 frames of 32² (the published widths only where no forward pass
runs: the model is built on the meta device).  The JAX package has no
video model, so the plain reference is the oracle here."""

import numpy as np
import pytest
import torch

from tests.torch_r2plus1d import R2Plus1D34, parameter_shapes
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.flow.farneback import farneback_sequence
from video_analytics_tpu_torch.models import convert
from video_analytics_tpu_torch.models.resnet import BatchNorm3d
from video_analytics_tpu_torch.models.two_stream import (
    TwoStreamModel, arch_input)
from video_analytics_tpu_torch.models.video_resnet import (
    midplanes, r2plus1d_34)
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.runtime import pipeline

torch.set_num_threads(1)

CLASSES, WIDTH = 7, 8
PUBLISHED_MIDPLANES = [144, 230, 288, 460, 576, 921, 1152]
# Convolution and linear weights of one RGB stream at published widths:
# the layer list of the paper (arXiv:1711.11248) counted by hand.
PUBLISHED_WEIGHTS = 63_493_399
# bfloat16 against the float32 reference: each of the ~70 layers rounds
# its output to 8 bits of mantissa (2^-9 relative), and the errors of a
# random-weight network compound over depth; this network reads 0.38 % of
# its largest logit, the float8 control 4.9 %.  1.5 % lies 4x above the
# one and 3x below the other.
BF16_REL = 0.015
FB = FarnebackConfig(levels=1, iterations=2, winsize=5)


def seeded(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """`model` initialised from `seed`, its BatchNorms given scales,
    shifts and running statistics away from the identity."""
    g = torch.Generator().manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.75, 1.25, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.75, 1.25, generator=g)
    return model.eval()


def state(model: torch.nn.Module) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def plain_clip_probs(frames: torch.Tensor, spatial: dict, temporal: dict,
                     mean, std, bound: float, fusion, flow_fn
                     ) -> torch.Tensor:
    """The plain two-stream R(2+1)D over (B, T, h, w, 3) cropped frames on
    [0, 255]: the reference model on the first T − 1 normalised frames
    and on the T − 1 flow fields of `flow_fn` ((B, T, h, w) gray → (B,
    T − 1, h, w, 2)), clipped to ±bound and divided by it; the two
    softmaxes averaged with the `fusion` weights."""
    x = frames.float()
    rgb = (x / 255.0 - torch.tensor(mean)) / torch.tensor(std)
    s = R2Plus1D34(spatial)(rgb[:, :-1])
    gray = torch.tensordot(x, torch.tensor([0.299, 0.587, 0.114]),
                           dims=([-1], [0]))
    flow = flow_fn(gray)
    t = R2Plus1D34(temporal)(flow.clamp(-bound, bound) / bound)
    ws, wt = fusion
    return (ws * torch.softmax(s, -1) + wt * torch.softmax(t, -1)) / (ws + wt)


@pytest.fixture(scope="module")
def nets():
    f32 = seeded(r2plus1d_34(CLASSES, width=WIDTH))
    bf16 = r2plus1d_34(CLASSES, width=WIDTH, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.randn(2, 8, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        want = R2Plus1D34(state(f32))(x)
    return f32, bf16, x, want


def test_float32_logits_equal_the_reference(nets):
    f32, _, x, want = nets
    with torch.no_grad():
        got = f32(x)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    assert want.abs().max() > 0.05
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_logits_keep_the_stated_tolerance(nets):
    _, bf16, x, want = nets
    with torch.no_grad():
        got = bf16(x)
        fp8 = R2Plus1D34(state(nets[0]), precision="fp8")(x)
    assert got.dtype == torch.float32
    scale = want.abs().max()
    gap = (got - want).abs().max()
    assert 0 < gap <= BF16_REL * scale, (gap, scale)
    assert (fp8 - want).abs().max() > gap, "the float8 control is closer"


def test_midplanes_are_the_published_counts():
    with torch.device("meta"):
        m = r2plus1d_34(101)
    mids = sorted({mod.spatial.out_channels for mod in m.modules()
                   if hasattr(mod, "spatial")} - {45})
    assert mids == PUBLISHED_MIDPLANES
    assert m.conv1.spatial.out_channels == 45
    assert m.conv1.spatial.kernel_size == (1, 7, 7)
    assert m.conv1.spatial.stride == (1, 2, 2)
    assert m.conv1.temporal.kernel_size == (3, 1, 1)
    assert [len(getattr(m, f"layer{k}")) for k in range(1, 5)] == [3, 4, 6, 3]
    # Each convolution its own count: the first block's second one of
    # stage 2 takes 288, where torchvision's r2plus1d_18 reuses 230.
    assert m.layer2[0].conv1.spatial.out_channels == 230
    assert m.layer2[0].conv2.spatial.out_channels == 288
    assert midplanes(64, 128) == 230 and midplanes(128, 128) == 288


@pytest.mark.parametrize("in_channels", [3, 2])
def test_parameter_shapes_at_published_widths_equal_the_reference(
        in_channels):
    with torch.device("meta"):
        m = r2plus1d_34(101, in_channels=in_channels)
    shapes = parameter_shapes(in_channels, 101)
    got = {k: tuple(v.shape) for k, v in state(m).items()}
    assert list(got) == list(shapes) and got == shapes
    weights = sum(int(np.prod(s)) for s in shapes.values() if len(s) > 1)
    if in_channels == 3:
        assert weights == PUBLISHED_WEIGHTS
    assert weights == sum(p.numel() for p in m.parameters() if p.dim() > 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_answers_as_unfolded(nets, dtype):
    f32, bf16, x, _ = nets
    unfolded = f32 if dtype == torch.float32 else bf16
    tm = TwoStreamModel(unfolded, unfolded.clone(fold_bn=False))
    tm.temporal.load_state_dict(unfolded.state_dict())
    folded = tm.folded().eval()
    assert not any(isinstance(m, BatchNorm3d) for m in folded.modules())
    with torch.no_grad():
        want, got = unfolded(x), folded.spatial(x)
    # float32: an exact composition up to rounding; bfloat16: the folded
    # products round where the BatchNorm's did not.
    tol = 1e-5 if dtype == torch.float32 else BF16_REL * want.abs().max()
    torch.testing.assert_close(got, want, rtol=0, atol=float(tol))


def test_variables_round_trip_and_fold_batchnorm_3d(nets):
    f32 = nets[0]
    v = convert.torch_to_flax(f32.state_dict())
    assert v["params"]["conv1_spatial"]["kernel"].shape == (1, 7, 7, 3, 45)
    assert v["params"]["layer2_0"]["downsample_conv"]["kernel"].shape == (
        1, 1, 1, WIDTH, 2 * WIDTH)
    back = convert.flax_to_torch(v)
    for k, t in state(f32).items():
        assert torch.equal(back[k], t), k
    folded = convert.fold_batchnorm(v)["params"]
    assert set(folded["layer1_0"]) == {"conv1_spatial", "conv1_temporal",
                                       "conv2_spatial", "conv2_temporal"}
    k = np.asarray(v["params"]["layer1_0"]["conv1_temporal"]["kernel"])
    bn = v["params"]["layer1_0"]["bn1"]
    st = v["batch_stats"]["layer1_0"]["bn1"]
    sc = bn["scale"] / np.sqrt(st["var"] + np.float32(1e-5))
    np.testing.assert_array_equal(
        folded["layer1_0"]["conv1_temporal"]["kernel"], k * sc)


def test_batchnorm3d_keeps_flax_statistics():
    """Train mode: normalised with the batch's biased variance, which the
    running buffer then takes (not n/(n-1) times it)."""
    bn = BatchNorm3d(4).train()
    x = torch.randn(2, 4, 3, 2, 2, generator=torch.Generator().manual_seed(2))
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    want = (x - mean.view(1, -1, 1, 1, 1)) / torch.sqrt(
        var.view(1, -1, 1, 1, 1) + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_arch_input_is_the_published_setup():
    inp = arch_input("r2plus1d_34")
    assert (inp.resize_short, inp.crop, inp.window) == (128, 112, 33)
    assert inp.fusion_weights == (1.0, 1.0)
    assert inp.mean == (0.43216, 0.394666, 0.37645)
    assert inp.std == (0.22803, 0.22145, 0.216989)
    assert arch_input("resnet18").crop == PreprocessConfig().crop
    with pytest.raises(ValueError, match="unknown arch"):
        arch_input("r3d_18")


# -- classify_batch -------------------------------------------------------------

def _windows(B: int, T: int, seed: int = 3) -> torch.Tensor:
    """(B, T, 40, 52, 3) uint8 windows of a texture moving 1-2 px a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, 40, 52, 3)).astype(np.uint8)
    return torch.from_numpy(np.stack(
        [[np.roll(base[b], (t, (b + 1) * t), axis=(0, 1)) for t in range(T)]
         for b in range(B)]))


def _clip_model(dtype=torch.float32) -> TwoStreamModel:
    model = TwoStreamModel.create(num_classes=CLASSES, width=WIDTH,
                                  arch="r2plus1d_34", dtype=dtype,
                                  fusion_weights=(1.0, 1.0))
    seeded(model.spatial, 4)
    seeded(model.temporal, 5)
    return model.eval()


def _clip_cfg() -> PipelineConfig:
    inp = arch_input("r2plus1d_34")
    return PipelineConfig(
        preprocess=PreprocessConfig(resize_short=36, crop=32, mean=inp.mean,
                                    std=inp.std),
        farneback=FB, flow_algo="farneback", num_classes=CLASSES,
        fusion_weights=inp.fusion_weights, window=9)


def test_classify_batch_on_clip_streams_equals_the_plain_pipeline():
    """The port's classify_batch with a tiny R(2+1)D and Farneback's CPU
    twin against the reference model on the same crop with the port's
    plain Farneback."""
    model, cfg = _clip_model(), _clip_cfg()
    assert model.clip_input and model.temporal.in_channels == 2
    windows = _windows(2, 9)
    with torch.no_grad():
        got = pipeline.classify_batch(windows, model, cfg)
        x = pipeline._crop(windows, cfg)
        want = plain_clip_probs(
            x, state(model.spatial), state(model.temporal),
            cfg.preprocess.mean, cfg.preprocess.std,
            cfg.preprocess.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, FB, plain=True))
    assert got.shape == (2, CLASSES)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (want.max(-1).values - want.min(-1).values).min() > 1e-3


def test_clip_streams_take_the_volume_in_their_dtype():
    """The temporal stream gets one (B, T − 1, h, w, 2) volume of flow
    fields, clipped and scaled in the stream's dtype; the spatial stream
    the first T − 1 frames."""
    model, cfg = _clip_model(torch.bfloat16), _clip_cfg()
    seen = {}
    hooks = [getattr(model, s).register_forward_pre_hook(
        lambda m, a, s=s: seen.__setitem__(s, a[0]))
        for s in ("spatial", "temporal")]
    windows = _windows(2, 9)
    with torch.no_grad():
        pipeline.classify_batch(windows, model, cfg)
        x = pipeline._crop(windows, cfg)
        flow = farneback_sequence(pp.rgb_to_gray(x), FB)
    for h in hooks:
        h.remove()
    assert seen["spatial"].shape == (2, 8, 32, 32, 3)
    vol = seen["temporal"]
    assert vol.shape == (2, 8, 32, 32, 2) and vol.dtype == torch.bfloat16
    assert torch.equal(vol, (flow.clamp(-20, 20) / 20).to(torch.bfloat16))


def test_the_image_path_is_unchanged():
    """ResNet streams: per-frame spatial logits averaged over the window,
    flow stacks through the temporal stream averaged, fused 1 : 1.5."""
    cfg = PipelineConfig(preprocess=PreprocessConfig(resize_short=36, crop=32,
                                                     flow_stack=3),
                         farneback=FB, flow_algo="farneback",
                         num_classes=CLASSES)
    model = TwoStreamModel.create(num_classes=CLASSES, flow_stack=3,
                                  width=WIDTH)
    seeded(model.spatial, 6)
    seeded(model.temporal, 7)
    assert not model.clip_input and model.temporal.in_channels == 6
    windows = _windows(2, 6)
    with torch.no_grad():
        got = pipeline.classify_batch(windows, model, cfg)
        x = pipeline._crop(windows, cfg)
        rgb = pp.normalize(x, cfg.preprocess.mean, cfg.preprocess.std)
        s = model.spatial(rgb.reshape(12, 32, 32, 3)).reshape(2, 6, -1)
        flow = farneback_sequence(pp.rgb_to_gray(x), FB)
        stacks = torch.stack([pp.stacked_flow_input(f, 3, 20.0)
                              for f in flow])
        t = model.temporal(stacks.reshape(-1, 32, 32, 6)).reshape(2, 3, -1)
        want = model.fuse(s.mean(1), t.mean(1))
    assert torch.equal(got, want)
