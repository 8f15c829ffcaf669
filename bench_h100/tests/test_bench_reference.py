"""The benchmark's plain reference against the port on the CPU, at small
sizes: each part, and the whole pipeline in float32."""

import pytest
import torch

from bench_h100 import clips, program, weights
from bench_h100.reference import farneback as ref_fb
from bench_h100.reference import pipeline as ref
from bench_h100.reference import resnet as ref_resnet
from bench_h100.reference import tvl1 as ref_tvl1
from bench_h100.tests import tiny


@pytest.fixture(scope="module")
def gray():
    """(2, 5, 40, 52) gray windows of the benchmark's clips."""
    made = clips.make_clips(7, [5, 5], tiny.TINY_CONTENT,
                            torch.device("cpu"))
    rgb = torch.stack(made).float()
    return ref.gray(rgb)


def test_tvl1_equals_the_port_with_its_rounds(gray):
    from video_analytics_tpu_torch.flow.tvl1 import tvl1

    cfg = tiny.tiny_config("t", "tvl1")
    pcfg = program.pipeline_config(cfg)
    prev = gray[:, :-1].reshape(-1, 40, 52)
    nxt = gray[:, 1:].reshape(-1, 40, 52)
    mine: list = []
    want = ref_tvl1.tvl1(prev, nxt, cfg["flow"]["tvl1"], rounds=mine)
    got, levels = program.recorded_rounds(
        lambda: tvl1(prev, nxt, pcfg.tvl1))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert [lv.hw for lv in levels] == [lv.hw for lv in mine]
    for a, b in zip(levels, mine):
        assert torch.equal(a.rounds.long(), b.rounds.long())
    assert sum(int(lv.rounds.sum()) for lv in mine) > 0


def test_tvl1_refuses_a_banded_level():
    cfg = tiny.tiny_config("t", "tvl1")["flow"]["tvl1"]
    big = torch.zeros((1, 320, 320))
    with pytest.raises(ValueError, match="bands"):
        ref_tvl1.tvl1(big, big, dict(cfg, nscales=1))


def test_farneback_equals_the_port(gray):
    from video_analytics_tpu_torch.flow.farneback import farneback_sequence

    cfg = tiny.tiny_config("t", "farneback")
    fb = dict(cfg["flow"]["farneback"], levels=3, winsize=15, iterations=3)
    pcfg = program.pipeline_config(
        dict(cfg, flow=dict(cfg["flow"], farneback=fb)))
    want = ref_fb.farneback_sequence(gray, fb)
    got = farneback_sequence(gray, pcfg.farneback)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert want.abs().max() > 0.1


@pytest.mark.parametrize("in_channels", [3, 20])
def test_resnet18_equals_the_port_in_float32(in_channels):
    from video_analytics_tpu_torch.models.resnet import resnet18

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    state = weights.make_stream(gen, cpu, in_channels, 11, 8)
    net = resnet18(num_classes=11, in_channels=in_channels, width=8)
    net.load_state_dict(state, strict=False)
    x = torch.randn((3, 64, 64, in_channels), generator=gen)
    with torch.no_grad():
        got = net.eval()(x)
    want = ref_resnet.ResNet18(state)(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert set(state) == set(ref_resnet.parameter_shapes(in_channels, 11, 8))


def test_fp8_control_moves_the_logits():
    gen = torch.Generator().manual_seed(4)
    state = weights.make_stream(gen, torch.device("cpu"), 3, 11, 8)
    x = torch.randn((2, 64, 64, 3), generator=gen)
    f32 = ref_resnet.ResNet18(state)(x)
    fp8 = ref_resnet.ResNet18(state, precision="fp8")(x)
    assert 0 < (fp8 - f32).abs().max() < f32.abs().max()


@pytest.mark.parametrize("algo", ["tvl1", "farneback"])
def test_pipeline_equals_classify_batch_in_float32(algo):
    cfg = tiny.tiny_config("t", algo)
    cfg["model"]["dtype"] = "float32"
    cpu = torch.device("cpu")
    w = weights.make_weights(5, cpu, cfg["model"])
    wins = torch.stack(clips.make_clips(5, [12, 12], tiny.TINY_CONTENT,
                                        cpu)).numpy()
    model = program.build_model(cfg, w, cpu)
    x, pcfg = program.with_transport_crop(wins, program.pipeline_config(cfg))
    with torch.no_grad():
        got = program.classify_batch(torch.from_numpy(x), model, pcfg)
        want = ref.classify(torch.from_numpy(wins), cfg, w)
    assert (got.log() - want.log()).abs().max() < 1e-4


@pytest.mark.parametrize("algo", ["tvl1", "farneback"])
def test_the_readers_time_what_classify_batch_runs(algo):
    """The per-layer readers' copies of the pipeline's stages
    (``program.batch_flow``, ``flow_stacks``, ``crop``, ``normalize``)
    give the very inputs that ``classify_batch`` hands each stream."""
    cfg = tiny.tiny_config("t", algo)
    cpu = torch.device("cpu")
    w = weights.make_weights(4, cpu, cfg["model"])
    wins = torch.stack(clips.make_clips(4, [12, 12], tiny.TINY_CONTENT,
                                        cpu)).numpy()
    model = program.build_model(cfg, w, cpu)
    x, pcfg = program.with_transport_crop(wins, program.pipeline_config(cfg))
    x = torch.from_numpy(x)
    seen = {}
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda m, args, name=name: seen.__setitem__(name, args[0].clone()))
        for name in ("spatial", "temporal")]
    with torch.no_grad():
        program.classify_batch(x, model, pcfg)
        cropped = program.crop(x, pcfg)
        rgb = program.normalize(cropped, pcfg).reshape(-1,
                                                       *cropped.shape[2:])
        flow = program.batch_flow(program.gray(cropped), pcfg)
        stacks = program.flow_stacks(flow, pcfg, model.temporal.dtype)
    for h in hooks:
        h.remove()
    assert torch.equal(seen["spatial"], rgb)
    assert torch.equal(seen["temporal"], stacks)


@pytest.mark.parametrize("algo", ["tvl1", "farneback"])
def test_the_flow_control_computes_in_bfloat16(gray, algo):
    """The flow control's flow is computed in bfloat16 throughout: near
    the float32 reference's, and not equal to it."""
    cfg = tiny.tiny_config("t", algo)
    f32 = ref.flow_of(gray, cfg)
    bf16 = ref.flow_of(gray, cfg, dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32 and bf16.shape == f32.shape
    err = (bf16 - f32).norm(dim=-1)
    assert 1e-4 < float(err.mean()) < 0.5, float(err.mean())
