"""The port's TimeSformer (``models/timesformer``) against the plain
reference ``tests/torch_timesformer.py`` on the CPU, and
``classify_batch`` on TimeSformer streams.

Seeded weights with biases and LayerNorms away from 0 and 1, at width
64, 4 heads, 2 blocks, MLP 256 and 3 frames of 32² (patch 16, so 4
patches a frame); the published widths only where no forward pass runs
(the model is built on the meta device).  The JAX package has no video
transformer, so the plain reference is the oracle here."""

import numpy as np
import pytest
import torch

from tests.torch_timesformer import TimeSformer as PlainTimeSformer
from tests.torch_timesformer import parameter_shapes
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.flow.farneback import farneback_sequence
from video_analytics_tpu_torch.models.timesformer import (
    TimeSformer, timesformer_base)
from video_analytics_tpu_torch.models.two_stream import (
    TwoStreamModel, arch_input)
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.ops.layers import LayerNorm
from video_analytics_tpu_torch.runtime import pipeline

torch.set_num_threads(1)

CLASSES, HEADS = 7, 4
SMALL = dict(width=64, depth=2, heads=HEADS, mlp=256, frames=3,
             image_size=32)
# The parameters of one stream at published widths and 101 classes.
PUBLISHED_PARAMETERS = {3: 121_336_421, 2: 121_139_813}
# bfloat16 against the float32 reference: each projection, LayerNorm,
# attention and residual add rounds to 8 bits of mantissa (2^-9
# relative), about 16 roundings a block on the residual stream; this
# network reads 0.8 % of its largest logit, the float8 control 12 %.
# 3 % lies 3.6x above the one and 4x below the other.
BF16_REL = 0.03
FB = FarnebackConfig(levels=1, iterations=2, winsize=5)


def seeded(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """`model` initialised from `seed`, its biases uniform in ±0.1 and
    its LayerNorm scales uniform in 0.75-1.25."""
    g = torch.Generator().manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.75, 1.25, generator=g)
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.Linear,
                              torch.nn.Conv2d)):
                m.bias.uniform_(-0.1, 0.1, generator=g)
    return model.eval()


def small(dtype=torch.float32, in_channels: int = 3) -> TimeSformer:
    return TimeSformer(num_classes=CLASSES, in_channels=in_channels,
                       dtype=dtype, **SMALL)


@pytest.fixture(scope="module")
def nets():
    f32 = seeded(small())
    bf16 = small(torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.randn(2, 3, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        want = PlainTimeSformer(f32.state_dict(), heads=HEADS)(x)
    return f32, bf16, x, want


def test_float32_logits_equal_the_reference(nets):
    f32, _, x, want = nets
    with torch.no_grad():
        got = f32(x)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_logits_keep_the_stated_tolerance(nets):
    f32, bf16, x, want = nets
    with torch.no_grad():
        got = bf16(x)
        fp8 = PlainTimeSformer(f32.state_dict(), heads=HEADS,
                               precision="fp8")(x)
    assert got.dtype == torch.float32
    scale = want.abs().max()
    gap = (got - want).abs().max()
    assert 0 < gap <= BF16_REL * scale, (gap, scale)
    assert (fp8 - want).abs().max() > gap, "the float8 control is closer"


@pytest.mark.parametrize("in_channels", [3, 2])
def test_parameters_at_published_widths_equal_the_reference(in_channels):
    with torch.device("meta"):
        m = timesformer_base(101, in_channels=in_channels)
    shapes = parameter_shapes(in_channels, 101)
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert list(got) == list(shapes) and got == shapes
    assert sum(p.numel() for p in m.parameters()) \
        == sum(int(np.prod(s)) for s in shapes.values()) \
        == PUBLISHED_PARAMETERS[in_channels]
    assert (m.width, m.depth, m.heads, m.mlp_dim, m.patch, m.frames,
            m.image_size) == (768, 12, 12, 3072, 16, 8, 224)
    assert m.blocks[0].attn.heads == 12


def test_each_stream_counts_its_attention_calls():
    """A forward of a 12-block stream calls each half's attention 12
    times, of a two-stream model 12 + 12 a stream."""
    kw = dict(SMALL, depth=12, width=48, heads=12, mlp=192)
    model = TwoStreamModel(TimeSformer(num_classes=CLASSES, **kw),
                           TimeSformer(num_classes=CLASSES, in_channels=2,
                                       **kw), (1.0, 1.0)).eval()
    before = dict(TimeSformer.attn_calls)
    with torch.no_grad():
        model.spatial(torch.zeros(1, 3, 32, 32, 3))
        one = {k: v - before[k] for k, v in TimeSformer.attn_calls.items()}
        model.temporal(torch.zeros(2, 3, 32, 32, 2))
    two = {k: v - before[k] for k, v in TimeSformer.attn_calls.items()}
    assert one == {"time": 12, "space": 12}
    assert two == {"time": 24, "space": 24}


def test_frames_in_another_order_give_the_same_logits_without_time(nets):
    """With the time embedding zeroed nothing tells the frames apart: the
    time half attends across them, the space half within each, and the
    class token averages over them."""
    f32, _, x, _ = nets
    m = small().eval()
    m.load_state_dict(f32.state_dict())
    with torch.no_grad():
        m.time_embed.zero_()
        want = m(x)
        got = m(x[:, [2, 0, 1]])
        moved = f32(x[:, [2, 0, 1]])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (moved - f32(x)).abs().max() > 1e-3


def test_a_clip_of_another_shape_is_refused(nets):
    with pytest.raises(ValueError, match=r"timesformer_base: expected "
                       r"\(N, 3, 32, 32, 3\)"):
        nets[0](torch.zeros(1, 4, 32, 32, 3))


def test_layer_norm_rounds_once_to_its_dtype():
    g = torch.Generator().manual_seed(2)
    ln = LayerNorm(16, eps=1e-6, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5, generator=g)
        ln.bias.uniform_(-1, 1, generator=g)
    x = torch.randn(5, 16, generator=g) * 3 + 1
    got = ln(x)
    w, b = (p.to(torch.bfloat16).float() for p in (ln.weight, ln.bias))
    xb = x.to(torch.bfloat16).float()
    mean = xb.mean(-1, keepdim=True)
    var = xb.var(-1, keepdim=True, correction=0)
    want = ((xb - mean) * torch.rsqrt(var + 1e-6) * w + b)
    assert got.dtype == torch.bfloat16 and ln.weight.dtype == torch.float32
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-6)
    f32 = LayerNorm(16, eps=1e-6)
    f32.load_state_dict(ln.state_dict())
    torch.testing.assert_close(
        f32(x), torch.nn.functional.layer_norm(x, (16,), ln.weight, ln.bias,
                                               1e-6))


def test_two_stream_create_builds_each_arch_at_its_own_width():
    with torch.device("meta"):
        tsf = TwoStreamModel.create(arch="timesformer_base")
        r2p1d = TwoStreamModel.create(arch="r2plus1d_34")
        r18 = TwoStreamModel.create()
    assert tsf.clip_input and tsf.spatial.width == 768
    assert tsf.temporal.in_channels == 2 and tsf.spatial.in_channels == 3
    assert tsf.spatial.num_classes == 101 and tsf.temporal.depth == 12
    assert r2p1d.spatial.width == r18.spatial.width == 64
    assert r18.temporal.in_channels == 20


def test_arch_input_is_the_published_setup():
    inp = arch_input("timesformer_base")
    assert (inp.resize_short, inp.crop, inp.window) == (224, 224, 9)
    assert inp.mean == (0.45,) * 3 and inp.std == (0.225,) * 3
    assert inp.fusion_weights == (1.0, 1.0)


@pytest.mark.parametrize("call", ["flax_variables", "load_flax_variables",
                                  "folded"])
def test_the_jax_layout_and_folding_refuse_the_arch(call):
    model = TwoStreamModel(small(), small(in_channels=2))
    args = ({},) if call == "load_flax_variables" else ()
    with pytest.raises(ValueError, match="timesformer_base"):
        getattr(model, call)(*args)


# -- classify_batch -------------------------------------------------------------

def _windows(B: int, T: int, seed: int = 3) -> torch.Tensor:
    """(B, T, 40, 52, 3) uint8 windows of a texture moving 1-2 px a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, 40, 52, 3)).astype(np.uint8)
    return torch.from_numpy(np.stack(
        [[np.roll(base[b], (t, (b + 1) * t), axis=(0, 1)) for t in range(T)]
         for b in range(B)]))


def _clip_model(dtype=torch.float32) -> TwoStreamModel:
    return TwoStreamModel(seeded(small(dtype), 4),
                          seeded(small(dtype, in_channels=2), 5),
                          fusion_weights=(1.0, 1.0)).eval()


def _clip_cfg() -> PipelineConfig:
    inp = arch_input("timesformer_base")
    return PipelineConfig(
        preprocess=PreprocessConfig(resize_short=36, crop=32, mean=inp.mean,
                                    std=inp.std),
        farneback=FB, flow_algo="farneback", num_classes=CLASSES,
        fusion_weights=inp.fusion_weights, window=4)


def plain_clip_probs(frames: torch.Tensor, spatial: dict, temporal: dict,
                     mean, std, bound: float, fusion, flow_fn,
                     heads: int = HEADS) -> torch.Tensor:
    """The plain two-stream TimeSformer over (B, T, h, w, 3) cropped
    frames on [0, 255]: the reference model on the first T − 1
    normalised frames and on the T − 1 flow fields of `flow_fn` ((B, T,
    h, w) gray → (B, T − 1, h, w, 2)), clipped to ±bound and divided by
    it; the two softmaxes averaged with the `fusion` weights."""
    x = frames.float()
    rgb = (x / 255.0 - torch.tensor(mean)) / torch.tensor(std)
    s = PlainTimeSformer(spatial, heads)(rgb[:, :-1])
    gray = torch.tensordot(x, torch.tensor([0.299, 0.587, 0.114]),
                           dims=([-1], [0]))
    t = PlainTimeSformer(temporal, heads)(
        flow_fn(gray).clamp(-bound, bound) / bound)
    ws, wt = fusion
    return (ws * torch.softmax(s, -1) + wt * torch.softmax(t, -1)) / (ws + wt)


def test_classify_batch_on_timesformer_streams_equals_the_plain_pipeline():
    """The port's classify_batch with tiny TimeSformers and Farneback's CPU
    twin against the reference model on the same crop with the port's
    plain Farneback."""
    model, cfg = _clip_model(), _clip_cfg()
    assert model.clip_input and model.temporal.in_channels == 2
    windows = _windows(2, 4)
    with torch.no_grad():
        got = pipeline.classify_batch(windows, model, cfg)
        x = pipeline._crop(windows, cfg)
        want = plain_clip_probs(
            x, model.spatial.state_dict(), model.temporal.state_dict(),
            cfg.preprocess.mean, cfg.preprocess.std,
            cfg.preprocess.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, FB, plain=True))
    assert got.shape == (2, CLASSES)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (want.max(-1).values - want.min(-1).values).min() > 1e-3


def test_timesformer_streams_take_the_volume_in_their_dtype():
    """The temporal stream gets one (B, T − 1, h, w, 2) volume of flow
    fields, clipped and scaled in the stream's dtype; the spatial stream
    the first T − 1 frames."""
    model, cfg = _clip_model(torch.bfloat16), _clip_cfg()
    seen = {}
    hooks = [getattr(model, s).register_forward_pre_hook(
        lambda m, a, s=s: seen.__setitem__(s, a[0]))
        for s in ("spatial", "temporal")]
    windows = _windows(2, 4)
    with torch.no_grad():
        probs = pipeline.classify_batch(windows, model, cfg)
        x = pipeline._crop(windows, cfg)
        flow = farneback_sequence(pp.rgb_to_gray(x), FB)
    for h in hooks:
        h.remove()
    assert seen["spatial"].shape == (2, 3, 32, 32, 3)
    vol = seen["temporal"]
    assert vol.shape == (2, 3, 32, 32, 2) and vol.dtype == torch.bfloat16
    assert torch.equal(vol, (flow.clamp(-20, 20) / 20).to(torch.bfloat16))
    assert probs.dtype == torch.float32
    torch.testing.assert_close(probs.sum(-1), torch.ones(2))
