"""The port's Video Swin (``models/video_swin``) against the plain
reference ``tests/torch_video_swin.py`` on the CPU, ``classify_batch``
and the command line on Video Swin streams, and ``timesformer.Attention``
without a bias as it was.

Seeded weights with biases and LayerNorms away from 0 and 1 and tables
of spread 1, at width 16, heads [2, 2, 4, 4], depths [2, 2, 2, 2] and
window 2×3×3 on 8 frames of 96² (patch 2×4×4): stages of 4×24², 4×12²,
4×6² and 4×3², so every stage has a shifted, masked block, and the last
stage's window is its whole 3×3 feature in H and W but 2 of its 4 in T
(its spatial shift drops, its temporal shift stays), as published
Swin-B's stage 4 (16×7² under 8×7×7).  The published widths only where
no forward pass runs, or at width 8 where one does.  The JAX package has
no video transformer, so the plain reference is the oracle here."""

import itertools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_video_swin as plain
from video_analytics_tpu_torch.config import (
    IMAGENET_MEAN, IMAGENET_STD, FarnebackConfig, PipelineConfig,
    PreprocessConfig)
from video_analytics_tpu_torch.flow.farneback import farneback_sequence
from video_analytics_tpu_torch.models import video_swin as vs
from video_analytics_tpu_torch.models.timesformer import Attention
from video_analytics_tpu_torch.models.two_stream import (
    TwoStreamModel, arch_input, arch_names)
from video_analytics_tpu_torch.models.video_swin import (
    VideoSwin, video_swin_b)
from video_analytics_tpu_torch.runtime import pipeline

torch.set_num_threads(1)

CLASSES = 7
WINDOW = (2, 3, 3)
SMALL = dict(width=16, depths=(2, 2, 2, 2), heads=(2, 2, 4, 4),
             window=WINDOW)
CLIP = (8, 96, 96)
# The parameters of one stream at published widths and 101 classes.
PUBLISHED_PARAMETERS = {3: 87_742_509, 2: 87_738_413}
F32_REL = 1e-4
# bfloat16 against the float32 reference: each projection, LayerNorm,
# attention and residual add rounds to 8 bits of mantissa (2^-9
# relative), about a dozen roundings a block on the residual stream, and
# the bias and mask round once; this network reads 0.2 % of its largest
# logit, the float8 control 6 %.  2 % lies 9x above the one and 3x below
# the other.
BF16_REL = 0.02
FB = FarnebackConfig(levels=1, iterations=2, winsize=5)


def seeded(model: VideoSwin, seed: int = 0) -> VideoSwin:
    """`model` initialised from `seed`, its biases uniform in ±0.1, its
    LayerNorm scales uniform in 0.75-1.25 and its tables N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.75, 1.25, generator=g)
            if getattr(m, "bias", None) is not None:
                m.bias.uniform_(-0.1, 0.1, generator=g)
            if isinstance(m, vs.WindowAttention):
                m.relative_position_bias_table.normal_(0, 1, generator=g)
    return model.eval()


def small(dtype=torch.float32, in_channels: int = 3) -> VideoSwin:
    return VideoSwin(num_classes=CLASSES, in_channels=in_channels,
                     dtype=dtype, **SMALL)


@pytest.fixture(scope="module")
def nets():
    f32 = seeded(small())
    bf16 = small(torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.randn(2, *CLIP, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = plain.VideoSwin(f32.state_dict(), window=WINDOW)(x)
    return f32, bf16, x, want


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


# -- the layouts --------------------------------------------------------------

@pytest.mark.parametrize("window", [(2, 3, 3), (8, 7, 7)])
def test_relative_position_index_counts_coordinate_differences(window):
    """Row (dd + Wd − 1)(2Wh − 1)(2Ww − 1) + (dh + Wh − 1)(2Ww − 1) + dw
    + Ww − 1 of the table for tokens i and j, d· = coordinate of i less
    that of j, tokens in (d, h, w) order; every row of the table used."""
    coords = list(itertools.product(*[range(n) for n in window]))
    wd, wh, ww = window
    want = torch.tensor([[(a[0] - b[0] + wd - 1) * (2 * wh - 1) * (2 * ww - 1)
                          + (a[1] - b[1] + wh - 1) * (2 * ww - 1)
                          + a[2] - b[2] + ww - 1 for b in coords]
                         for a in coords])
    got = vs.relative_position_index(window)
    assert torch.equal(got, want)
    assert torch.equal(plain.relative_position_index(window), want)
    rows = (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)
    assert torch.equal(got.unique(), torch.arange(rows))


@pytest.mark.parametrize("size,window,shift", [
    ((4, 6, 6), (2, 3, 3), (1, 1, 1)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0)),
    ((4, 6, 9), (2, 3, 3), (1, 2, 0))])
def test_shift_mask_separates_the_regions_of_the_rolled_feature(
        size, window, shift):
    """In each dimension of n positions the rolled feature has the regions
    [0, n − window), [n − window, n − shift) and [n − shift, n) (one
    region where the shift is 0); two tokens of a window see 0 if they
    lie in the same region in every dimension, −100 otherwise."""
    def region(c, n, w, s):
        return 0 if s == 0 or c < n - w else (1 if c < n - s else 2)

    labels = torch.zeros(size, dtype=torch.long)
    for d, h, w in itertools.product(*[range(n) for n in size]):
        labels[d, h, w] = sum(region(c, n, wi, si) * 3 ** (2 - k)
                              for k, (c, n, wi, si) in enumerate(
                                  zip((d, h, w), size, window, shift)))
    lab = vs.window_partition(labels[None, ..., None], window)[..., 0]
    want = torch.where(lab[:, :, None] == lab[:, None, :], 0.0, -100.0)
    got = vs.shift_mask(size, window, shift, torch.device("cpu"))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(plain.compute_mask(*size, window, shift, "cpu"), want)
    if any(shift):
        assert (got == -100).any() and (got == 0).any()


def test_partition_then_reverse_is_the_identity():
    x = torch.randn(2, 4, 6, 9, 5)
    win = vs.window_partition(x, WINDOW)
    assert win.shape == (2 * 2 * 2 * 3, 18, 5)
    # The first window holds x[0, :2, :3, :3] in (d, h, w) order, the
    # second the next window along W.
    assert torch.equal(win[0], x[0, :2, :3, :3].reshape(18, 5))
    assert torch.equal(win[1], x[0, :2, :3, 3:6].reshape(18, 5))
    assert torch.equal(vs.window_reverse(win, WINDOW, (2, 4, 6, 9)), x)
    assert torch.equal(plain.window_partition(x, WINDOW), win)


def test_patch_merging_takes_h_before_w():
    """The four parts, before the norm: (even h, even w), (odd h, even
    w), (even h, odd w), (odd h, odd w)."""
    merge = vs.PatchMerging(3, torch.float32)
    merge.norm, merge.reduction = torch.nn.Identity(), torch.nn.Identity()
    x = torch.randn(2, 2, 4, 6, 3)
    got = merge(x)
    assert got.shape == (2, 2, 2, 3, 12)
    for k, (i, j) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        assert torch.equal(got[..., 3 * k:3 * k + 3], x[:, :, i::2, j::2])


def test_window_and_shift_follow_the_published_rule():
    """Published Swin-B at 32×224²: every stage whole windows, stage 4
    keeps its temporal shift alone; the test shape's last stage too."""
    sizes = [(16, 56, 56), (16, 28, 28), (16, 14, 14), (16, 7, 7)]
    got = [vs.window_size_and_shift(s, (8, 7, 7), (4, 3, 3)) for s in sizes]
    assert got[:3] == [((8, 7, 7), (4, 3, 3))] * 3
    assert got[3] == ((8, 7, 7), (4, 0, 0))
    assert vs.window_size_and_shift((4, 3, 3), WINDOW, (1, 1, 1)) \
        == (WINDOW, (1, 0, 0))
    assert vs.window_size_and_shift((2, 9, 9), (8, 7, 7), (4, 3, 3)) \
        == ((2, 7, 7), (0, 3, 3))


# -- the whole model ----------------------------------------------------------

def test_float32_logits_equal_the_reference(nets):
    f32, _, x, want = nets
    with torch.no_grad():
        got = f32(x)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    assert want.abs().max() > 0.5
    assert _gap(got, want) <= F32_REL


def test_bfloat16_logits_keep_the_stated_tolerance(nets):
    f32, bf16, x, want = nets
    with torch.no_grad():
        got = bf16(x)
        fp8 = plain.VideoSwin(f32.state_dict(), window=WINDOW,
                              precision="fp8")(x)
    assert got.dtype == torch.float32
    assert 0 < _gap(got, want) <= BF16_REL
    assert _gap(fp8, want) > _gap(got, want), "the float8 control is closer"


@pytest.mark.parametrize("fault", plain.FAULTS)
def test_each_fault_fails_the_whole_model_comparison(nets, fault):
    """The reference with the relative position bias, the shift mask or
    the shift left out, or merging's parts swapped, lies outside both
    the float32 and the bfloat16 tolerance of the port's logits."""
    f32, _, x, want = nets
    with torch.no_grad():
        wrong = plain.VideoSwin(f32.state_dict(), window=WINDOW,
                                leave_out=[fault])(x)
        got = f32(x)
    assert _gap(wrong, want) > BF16_REL
    assert _gap(got, wrong) > BF16_REL


def test_a_clip_that_needs_padding_is_refused(nets):
    with pytest.raises(ValueError, match=r"a clip of 8x96x90 needs padding"):
        nets[0](torch.zeros(1, 8, 96, 90, 3))
    with pytest.raises(ValueError, match="stage 1's 3x24x24 tokens"):
        nets[0](torch.zeros(1, 6, 96, 96, 3))
    with pytest.raises(ValueError, match=r"expected \(N, T, H, W, 3\)"):
        nets[0](torch.zeros(1, 8, 96, 96, 2))


@pytest.mark.parametrize("in_channels", [3, 2])
def test_parameters_at_published_widths_equal_the_reference(in_channels):
    with torch.device("meta"):
        m = video_swin_b(101, in_channels=in_channels)
    shapes = plain.parameter_shapes(in_channels, 101)
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert list(got) == list(shapes) and got == shapes
    assert sum(p.numel() for p in m.parameters()) \
        == sum(int(np.prod(s)) for s in shapes.values()) \
        == PUBLISHED_PARAMETERS[in_channels]
    assert (m.width, m.depths, m.heads, m.window, m.patch, m.mlp_ratio,
            m.feature_dim) == (128, (2, 2, 18, 2), (4, 8, 16, 32),
                               (8, 7, 7), (2, 4, 4), 4, 1024)
    assert m.layers[3].blocks[1].attn.heads == 32


def test_each_stream_counts_its_blocks_and_merges():
    """A Swin-B stream's forward at 32×224² (width 8 here) runs 12
    unshifted and 12 shifted blocks and 3 merges, a two-stream model's
    12 + 12 + 3 a stream."""
    model = TwoStreamModel.create(num_classes=CLASSES, width=8,
                                  arch="swin3d_b").eval()
    before = dict(VideoSwin.calls)
    with torch.no_grad():
        model.spatial(torch.zeros(1, 32, 224, 224, 3))
        one = {k: v - before[k] for k, v in VideoSwin.calls.items()}
        model.temporal(torch.zeros(1, 32, 224, 224, 2))
    two = {k: v - before[k] for k, v in VideoSwin.calls.items()}
    assert one == {"window": 12, "shifted": 12, "merge": 3}
    assert two == {"window": 24, "shifted": 24, "merge": 6}


def test_every_swin_span_is_traced(nets):
    """``va/swin.embed`` and ``.head`` once a forward, ``.attn`` and
    ``.mlp`` once a block, ``.merge`` once after each of stages 1-3; the
    logits bit-identical with the profiler on."""
    from torch.profiler import ProfilerActivity, profile

    f32, _, x, _ = nets
    with torch.no_grad():
        off = f32(x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = f32(x)
    names = [e.name for e in prof.events() if e.name.startswith("va/")]
    assert {n: names.count(n) for n in set(names)} == {
        "va/swin.embed": 1, "va/swin.attn": 8, "va/swin.mlp": 8,
        "va/swin.merge": 3, "va/swin.head": 1}
    assert torch.equal(off, on)


# -- timesformer.Attention: the bias ------------------------------------------

@pytest.fixture(scope="module")
def attn():
    torch.manual_seed(5)
    a = Attention(32, 4, torch.float32).eval()
    with torch.no_grad():
        a.qkv.bias.uniform_(-0.5, 0.5)
    return a, torch.randn(6, 10, 32)


def test_attention_without_a_bias_takes_its_old_path_bit_for_bit(attn):
    """No bias: the ``qkv`` product, SDPA without a mask on its views, the
    projection, exactly as before the bias was added."""
    a, x = attn
    with torch.no_grad():
        y = a.qkv(x)
        q, k, v = y.view(6, 10, 3, 4, 8).permute(2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)
        want = a.proj(o.transpose(1, 2).reshape(6, 10, 32))
        assert torch.equal(a(x), want) and torch.equal(a(x, None), want)


def test_attention_without_a_bias_in_bfloat16_takes_its_old_path_bit_for_bit():
    """The same in bfloat16, where each product rounds: q, k and v are
    views of the ``qkv`` product with the strides they had before."""
    torch.manual_seed(6)
    a = Attention(64, 4, torch.bfloat16).eval()
    x = torch.randn(4, 12, 64).to(torch.bfloat16)
    with torch.no_grad():
        y = a.qkv(x)
        q, k, v = y.view(4, 12, 3, 4, 16).permute(2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)
        want = a.proj(o.transpose(1, 2).reshape(4, 12, 64))
        assert torch.equal(a(x), want)


@pytest.mark.parametrize("groups", [1, 3])
def test_attention_adds_its_bias_to_the_scores_of_each_group(attn, groups):
    """A (G, heads, L, L) bias reaches sequence b as ``bias[b % G]``."""
    a, x = attn
    bias = torch.randn(groups, 4, 10, 10)
    with torch.no_grad():
        y = a.qkv(x)
        q, k, v = y.view(6, 10, 3, 4, 8).permute(2, 0, 3, 1, 4).unbind(0)
        full = bias.repeat(6 // groups, 1, 1, 1)
        s = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5 + full, -1)
        want = a.proj((s @ v).transpose(1, 2).reshape(6, 10, 32))
        got = a(x, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (got - a(x)).abs().max() > 1e-2


# -- the registry, the pipeline and the command line --------------------------

def test_the_registry_and_arch_input_hold_the_published_setup():
    assert arch_names()[-1] == "swin3d_b"
    assert [a for a in arch_names() if arch_input(a).clip] \
        == ["r2plus1d_34", "timesformer_base", "swin3d_b"]
    assert arch_names(images_only=True) \
        == ["resnet18", "resnet34", "resnet50"]
    inp = arch_input("swin3d_b")
    assert (inp.resize_short, inp.crop, inp.window, inp.clip) \
        == (224, 224, 33, True)
    assert inp.mean == IMAGENET_MEAN and inp.std == IMAGENET_STD
    assert inp.fusion_weights == (1.0, 1.0)
    assert inp.width == 128
    with torch.device("meta"):
        model = TwoStreamModel.create(arch="swin3d_b")
    assert model.clip_input and model.spatial.width == 128
    assert model.spatial.in_channels == 3 and model.temporal.in_channels == 2
    assert model.spatial.num_classes == 101


@pytest.mark.parametrize("call", ["flax_variables", "load_flax_variables",
                                  "folded"])
def test_the_jax_layout_and_folding_refuse_the_arch(call):
    model = TwoStreamModel(small(), small(in_channels=2))
    args = ({},) if call == "load_flax_variables" else ()
    with pytest.raises(ValueError, match="swin3d_b"):
        getattr(model, call)(*args)


def _windows(B: int, T: int, seed: int = 3) -> torch.Tensor:
    """(B, T, 100, 120, 3) uint8 windows of a texture moving 1-2 px a
    frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, 100, 120, 3)).astype(np.uint8)
    return torch.from_numpy(np.stack(
        [[np.roll(base[b], (t, (b + 1) * t), axis=(0, 1)) for t in range(T)]
         for b in range(B)]))


def plain_clip_probs(frames: torch.Tensor, spatial: dict, temporal: dict,
                     mean, std, bound: float, fusion, flow_fn,
                     window=WINDOW) -> torch.Tensor:
    """The plain two-stream Video Swin over (B, T, h, w, 3) cropped frames
    on [0, 255]: the reference model on the first T − 1 normalised frames
    and on the T − 1 flow fields of `flow_fn` ((B, T, h, w) gray → (B,
    T − 1, h, w, 2)), clipped to ±bound and divided by it; the two
    softmaxes averaged with the `fusion` weights."""
    x = frames.float()
    rgb = (x / 255.0 - torch.tensor(mean)) / torch.tensor(std)
    s = plain.VideoSwin(spatial, window=window)(rgb[:, :-1])
    gray = torch.tensordot(x, torch.tensor([0.299, 0.587, 0.114]),
                           dims=([-1], [0]))
    t = plain.VideoSwin(temporal, window=window)(
        flow_fn(gray).clamp(-bound, bound) / bound)
    ws, wt = fusion
    return (ws * torch.softmax(s, -1) + wt * torch.softmax(t, -1)) / (ws + wt)


def test_classify_batch_on_swin_streams_equals_the_plain_pipeline():
    """The port's classify_batch with small Video Swins and Farneback's CPU
    twin against the reference model on the same crop with the port's
    plain Farneback; the temporal stream takes one volume of fields."""
    model = TwoStreamModel(seeded(small(), 4), seeded(small(in_channels=2),
                                                      5),
                           fusion_weights=(1.0, 1.0)).eval()
    inp = arch_input("swin3d_b")
    cfg = PipelineConfig(
        preprocess=PreprocessConfig(resize_short=100, crop=96, mean=inp.mean,
                                    std=inp.std),
        farneback=FB, flow_algo="farneback", num_classes=CLASSES,
        fusion_weights=inp.fusion_weights, window=CLIP[0] + 1)
    seen = {}
    hook = model.temporal.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("volume", a[0]))
    windows = _windows(2, CLIP[0] + 1)
    with torch.no_grad():
        got = pipeline.classify_batch(windows, model, cfg)
        hook.remove()
        x = pipeline._crop(windows, cfg)
        want = plain_clip_probs(
            x, model.spatial.state_dict(), model.temporal.state_dict(),
            cfg.preprocess.mean, cfg.preprocess.std,
            cfg.preprocess.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, FB, plain=True))
    assert seen["volume"].shape == (2, *CLIP, 2)
    assert got.shape == (2, CLASSES)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (want.max(-1).values - want.min(-1).values).min() > 1e-3


SWIN = ["--arch", "swin3d_b", "--num-classes", "5", "--width", "8",
        "--algo", "farneback", "--fb-levels", "1", "--fb-iterations", "1"]
CPU = ["--device", "cpu"]
SHORT = ["--window", "9"]


@pytest.fixture(scope="module")
def swin_model():
    """The two-stream Video Swin-B that the commands build from SWIN's
    flags without --checkpoint: width 8 (published depths, heads and
    window), weights from seed 0."""
    tm = TwoStreamModel.create(num_classes=5, width=8, arch="swin3d_b")
    return tm.init(torch.Generator().manual_seed(0)).eval()


def _run(capsys, argv):
    from video_analytics_tpu_torch.cli.main import main
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def _plain_swin_probs(video, model, num_windows, flags=()):
    """The plain pipeline's clip probabilities for `video` under SWIN's
    flags and `flags`: the arch's own crop (224² from a short side of
    224) and windows (33 frames unless `flags` give --window), then the
    reference model on the port's plain Farneback, ImageNet's
    statistics, fusion 1 : 1."""
    from video_analytics_tpu_torch.cli.main import (
        _pipeline_config, build_parser)
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime.evaluate import load_clip_windows

    cfg = _pipeline_config(build_parser().parse_args(
        ["classify-clip", video, *SWIN, *flags]))
    pre = cfg.preprocess
    assert (pre.resize_short, pre.crop) == (224, 224)
    assert cfg.window == (33 if not flags else int(flags[-1]))
    assert pre.mean == IMAGENET_MEAN and cfg.fusion_weights == (1.0, 1.0)
    wins, cfg = load_clip_windows(video, cfg, num_windows=num_windows)
    pre = cfg.preprocess
    x = pp.resize_short_center_crop(torch.from_numpy(wins), pre.resize_short,
                                    pre.crop, src_hw=pre.src_hw)
    with torch.no_grad():
        probs = plain_clip_probs(
            x, model.spatial.state_dict(), model.temporal.state_dict(),
            pre.mean, pre.std, pre.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, cfg.farneback, plain=True),
            window=(8, 7, 7))
    return probs.mean(0).numpy()


def test_classify_clip_swin3d_b(tiny_clip, swin_model, capsys):
    """--arch swin3d_b answers as the plain pipeline on the weights of its
    seed."""
    rc, res = _run(capsys, ["classify-clip", tiny_clip, *SWIN, "--topk",
                            "5", *CPU])
    assert rc == 0
    got = {e["class_id"]: e["prob"] for e in res["topk"]}
    want = _plain_swin_probs(tiny_clip, swin_model, 1)
    assert sorted(got) == list(range(5))
    for i in range(5):
        assert abs(got[i] - want[i]) <= 1e-5, (i, got, want)
    assert res["top1"] == int(np.argmax(want))


def test_eval_ucf101_batched_swin3d_b(tmp_path, swin_model, capsys):
    """eval-ucf101 --batched --arch swin3d_b counts as the clip-by-clip
    command, whose correct count is the plain pipeline's.  Windows of 9
    frames (8 a clip: windows of 4×7×7 tokens, no temporal shift) keep
    the six passes over each clip within seconds on one CPU thread;
    classify-clip runs the arch's own 33."""
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path / "ucf")
    build_synthetic_ucf101(root, num_classes=2, clips_per_class=2,
                           num_frames=12, h=96, w=128)
    args = ["eval-ucf101", "--videos", f"{root}/videos", "--annotations",
            f"{root}/annotations", *SWIN, *SHORT, *CPU]
    rc, batched = _run(capsys, [*args, "--batched", "--batch-clips", "2"])
    assert rc == 0 and batched["failed"] == 0 and batched["total"] >= 2
    rc, serial = _run(capsys, args)
    assert rc == 0 and serial == batched
    records = UCF101(videos_root=f"{root}/videos",
                     annotations_root=f"{root}/annotations").test_records()
    correct = sum(int(np.argmax(_plain_swin_probs(r.path, swin_model, 1,
                                                  SHORT)) == r.label)
                  for r in records)
    assert serial["correct"] == correct and serial["total"] == len(records)


def test_fold_bn_checkpoint_and_convert_weights_refuse_swin3d_b(
        tiny_clip, tmp_path, capsys):
    """Video Swin has no BatchNorm to fold and no layout in the JAX
    package's checkpoints: --fold-bn, --checkpoint and convert-weights
    refuse it with a message that names it."""
    from video_analytics_tpu_torch.cli.main import main
    for flag in (["--fold-bn"], ["--checkpoint", str(tmp_path / "x")]):
        with pytest.raises(ValueError, match="swin3d_b"):
            main(["classify-clip", tiny_clip, *SWIN, *flag, *CPU])
    with pytest.raises(SystemExit):
        main(["convert-weights", str(tmp_path / "a.pth"),
              str(tmp_path / "b.msgpack"), "--arch", "swin3d_b"])
    assert "swin3d_b" in capsys.readouterr().err


def test_the_cli_takes_its_archs_and_their_geometry_from_the_registry():
    """classify-clip and eval-ucf101 offer every registered arch, the
    image commands the image archs; the help names each arch's own crop,
    short side, window and width."""
    import argparse

    from video_analytics_tpu_torch.cli.main import build_parser

    subs = next(a for a in build_parser()._actions
                if isinstance(a, argparse._SubParsersAction)).choices
    for cmd, want in (("classify-clip", arch_names()),
                      ("eval-ucf101", arch_names()),
                      ("serve", arch_names(images_only=True)),
                      ("train", arch_names(images_only=True))):
        arch = next(a for a in subs[cmd]._actions if a.dest == "arch")
        assert arch.choices == want, cmd
    arch = next(a for a in subs["classify-clip"]._actions
                if a.dest == "arch")
    assert "224, 224, 33, 128 for swin3d_b" in arch.help
    assert "224, 224, 9, 768 for timesformer_base" in arch.help
