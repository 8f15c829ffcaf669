"""``tools/torch_roofline.py`` on the CPU: its rows' and peaks' keys and
its programs' names against the reference tool's (read from
tools/roofline.py's source, which is not run); the CNN count against a
count of the taps made here and against the JAX executable's own
``cost_analysis()``; the TV-L1 count against the rounds the plain path
ran, and linear in pairs; the bound helpers that chip_smoke.py reads from
the tool at the values its own formulas gave; and the tool's ``main`` at
a reduced size."""

import ast
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

from video_analytics_tpu.models.resnet import resnet18 as jax_resnet18
from video_analytics_tpu_torch.config import TVL1Config
from video_analytics_tpu_torch.flow import tvl1 as tl
from video_analytics_tpu_torch.models.convert import flax_to_torch
from video_analytics_tpu_torch.models.resnet import (
    flow_stream_resnet18, resnet18)
from video_analytics_tpu_torch.ops.cuda import farneback as fk
from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load(os.path.join(REPO, "tools", "torch_roofline.py"),
             "torch_roofline")

# A few frames of 48x64, two-level flows, width-8 CNNs: ~2 s on one core.
SMALL = tool.Protocol(
    src_hw=(48, 64), n_frames=8, flow_stack=2, resize_short=40, crop=32,
    width=8, eval_clips=2, window=4, hd_hw=(72, 128), hd_windows=2,
    hd_pairs=2, tvl1=dict(nscales=2, warps=2, outer_iterations=3,
                          inner_iterations=4),
    farneback=dict(levels=1, iterations=1))


def reference_tool():
    """(row keys, peaks keys, program names) of tools/roofline.py, read
    from its syntax tree: the dict ``measure`` returns, the ``peaks`` dict
    of its JSON line, and the first argument of each ``measure`` call."""
    with open(os.path.join(REPO, "tools", "roofline.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    rows = [k.value for k in ret.value.keys]
    peaks = next(v for n in ast.walk(tree) if isinstance(n, ast.Dict)
                 for k, v in zip(n.keys, n.values)
                 if isinstance(k, ast.Constant) and k.value == "peaks")
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id == "measure"), key=lambda n: n.lineno)
    return (rows, [k.value for k in peaks.keys],
            [n.args[0].value for n in calls])


@pytest.fixture(scope="module")
def small_run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(["--device", "cpu", "--reps", "2"], protocol=SMALL)
    lines = out.getvalue().splitlines()
    line = next(ln for ln in lines if ln.startswith('{"rows"'))
    return rc, json.loads(line), lines


def test_rows_peaks_and_names_are_the_reference_tools(small_run):
    rc, res, lines = small_run
    rows, peaks, names = reference_tool()
    assert rc == 0
    assert [r["name"] for r in res["rows"]] == names == list(tool.NAMES)
    for r in res["rows"]:
        # The reference's keys, in its order, then the two the port adds.
        assert list(r) == rows + ["device_ms", "count"], r
        assert r["count"] == ("rounds" if r["name"].startswith("tvl1")
                              else "shapes")
        assert r["gflop"] > 0 and r["gb"] > 0 and r["ms"] > 0
    assert list(res["peaks"]) == peaks
    assert res["peaks"] == {"mxu_bf16_tflops": 989.0,
                            "vpu_f32_tflops_est": 67.0, "hbm_gbps": 3350.0}


def test_cpu_run_writes_no_device_metric(small_run):
    """Off the card every share and device time is null, the card "cpu";
    the table says "not measured"."""
    _, res, lines = small_run
    assert res["card"] == "cpu"
    for r in res["rows"]:
        assert r["device_ms"] is None and r["mfu_mxu_pct"] is None
        assert r["mfu_vpu_pct"] is None and r["hbm_pct"] is None
    table = [ln for ln in lines if ln.startswith("| headline_64f")]
    assert len(table) == 1 and "not measured" in table[0]


def test_cuda_without_a_card_fails():
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--device", "cuda"])


def test_a_share_over_a_peak_raises():
    work = tool.Work(bytes=int(3.35e9), f32=int(67e9), bf16=int(989e9))
    got = tool.shares("p", work, 2e-3)
    assert got == pytest.approx({"mfu_mxu_pct": 50.0, "mfu_vpu_pct": 50.0,
                                 "hbm_pct": 50.0})
    for w in (tool.Work(bytes=int(3.4e9)), tool.Work(f32=int(68e9)),
              tool.Work(bf16=int(990e9))):
        with pytest.raises(RuntimeError, match="count is wrong"):
            tool.shares("p", w, 1e-3)


# -- the CNN count -------------------------------------------------------------

def _taps(n_in: int, n_out: int, k: int, stride: int, pad: int,
          in_bounds: bool) -> int:
    """Taps along one axis of a convolution, summed over its outputs:
    all of them, or those that fall inside the input."""
    return sum(1 for o in range(n_out) for t in range(k)
               if not in_bounds or 0 <= o * stride - pad + t < n_in)


def test_cnn_count_against_taps_and_xla_cost_analysis():
    """A width-8 ResNet-18 on 2 images of 64², the JAX model's seed-0
    weights converted: the tool's operations equal 2 per multiply-add of
    every tap (counted here, convolution by convolution); XLA's
    ``cost_analysis()`` of the same network leaves out the taps that fall
    in the padding and adds BatchNorm, ReLU, the residual adds and the
    pooling: it must lie within 5 % above the in-bounds taps' count
    (measured +2.7 %)."""
    module = jax_resnet18(num_classes=5, width=8)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))
    net = resnet18(num_classes=5, width=8)
    net.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables)))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)

    compiled = jax.jit(lambda v, a: module.apply(v, a, train=False)).lower(
        variables, x).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost

    every = in_bounds = nbytes = 0

    def hook(m, inp, out):
        nonlocal every, in_bounds, nbytes
        nbytes += 4 * (inp[0].numel() + out.numel()
                       + sum(p.numel() for p in m.parameters()))
        if isinstance(m, torch.nn.Linear):
            every += 2 * out.numel() * m.in_features
            in_bounds += 2 * out.numel() * m.in_features
            return
        (h, w), (oh, ow) = inp[0].shape[-2:], out.shape[-2:]
        kh, kw = m.kernel_size
        macs = out.shape[0] * out.shape[1] * m.in_channels // m.groups
        for inside in (False, True):
            taps = (_taps(h, oh, kh, m.stride[0], m.padding[0], inside)
                    * _taps(w, ow, kw, m.stride[1], m.padding[1], inside))
            if inside:
                in_bounds += 2 * macs * taps
            else:
                every += 2 * macs * taps

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        net(torch.from_numpy(x))
    for h in hooks:
        h.remove()

    work = tool.cnn_work(net, torch.from_numpy(x))
    assert work.flops == work.f32 == every and work.bf16 == 0
    assert work.bytes == nbytes
    assert in_bounds < every
    assert in_bounds <= cost["flops"] <= 1.05 * in_bounds, (
        cost["flops"], in_bounds, every)


def test_cnn_count_in_bfloat16_is_tensor_core_work():
    net = resnet18(num_classes=5, width=8, dtype=torch.bfloat16)
    x = torch.zeros(2, 32, 32, 3)
    f32 = tool.cnn_work(resnet18(num_classes=5, width=8), x)
    bf = tool.cnn_work(net, x, return_features=True)
    # The features skip the fc: 2·5·64 operations and its weights.
    assert bf.f32 == 0 and bf.bf16 == f32.f32 - 2 * 2 * 5 * 64
    assert bf.bytes < f32.bytes


# -- the TV-L1 count -----------------------------------------------------------

def _scene(t: float, h: int, w: int, seed: int) -> np.ndarray:
    """A smooth texture moved by t·(1.3, -0.7) px: the ε test stops its
    images after different rounds."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = x - 1.3 * t, y + 0.7 * t
    img = np.zeros((h, w))
    for _ in range(6):
        fx, fy = rng.uniform(-0.3, 0.3, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * x + fy * y
                                              + rng.uniform(0, 6.3))
    return (127.5 + 20 * img).astype(np.float32)


H, W = 36, 44
CFG = TVL1Config(nscales=2, warps=2, outer_iterations=6, inner_iterations=5)


def _pair(seeds):
    return (torch.from_numpy(np.stack([_scene(0, H, W, s) for s in seeds])),
            torch.from_numpy(np.stack([_scene(1, H, W, s) for s in seeds])))


CHUNKED = {"rule": tl.whole_plane_level,
           "chunked": lambda h, w, median: False}


def _count(seeds, rule):
    levels = tool.rounds_of(
        lambda a, b: tl.tvl1(a, b, CFG, whole_plane=CHUNKED[rule]),
        _pair(seeds))
    assert [lv.solver for lv in levels] == (
        ["warp", "warp"] if rule == "rule" else ["chunked", "chunked"])
    return tool.tvl1_work(levels, CFG)


@pytest.mark.parametrize("rule", sorted(CHUNKED))
def test_tvl1_count_is_the_rounds_the_plain_path_ran(monkeypatch, rule):
    """One pair, two levels: the tool's count equals 45 operations a
    pixel and warp, 2·2·113 a scale-end median and (70·5 + 2·2·113) a
    round the plain solver ran, the rounds counted here at each round's
    last primal-dual step (the tensor solvers) or each round's first
    chunk (the banded one), level by level."""
    ran = {}
    step, chunk = ts.pd_step_plain, ts.pd_chunk_plain

    def spy_step(prep, uv, p, cfg, with_err=False):
        if with_err:
            key = tuple(uv.shape[-2:])
            ran[key] = ran.get(key, 0) + 1
        return step(prep, uv, p, cfg, with_err)

    def spy_chunk(prep, state, act, cfg, iters, band, do_median):
        if do_median:
            key = tuple(state.shape[-2:])
            ran[key] = ran.get(key, 0) + int(act.sum())
        return chunk(prep, state, act, cfg, iters, band, do_median)

    monkeypatch.setattr(ts, "pd_step_plain", spy_step)
    monkeypatch.setattr(ts, "pd_chunk_plain", spy_chunk)
    work = _count([1], rule)
    med = 2 * 2 * 113
    want = sum(h * w * (45 * CFG.warps + med)
               + (70 * CFG.inner_iterations + med) * h * w * n
               for (h, w), n in ran.items())
    assert len(ran) == 2 and work.f32 == want and work.bf16 == 0
    assert work.bytes == sum(8 * 4 * h * w for h, w in ran)
    # The ε test stopped some rounds: the budget counts more.
    budget = tool.tvl1_budget_work(1, H, W, CFG)
    assert work.f32 < budget.f32 and work.bytes == budget.bytes


@pytest.mark.parametrize("rule", sorted(CHUNKED))
def test_tvl1_count_is_linear_in_pairs(rule):
    """Each image stops on its own ε test: two pairs count what each
    counts alone, and a pair twice counts twice its count."""
    one, two = _count([1], rule), _count([2], rule)
    assert one != two
    assert _count([1, 2], rule) == one + two
    assert _count([1, 1], rule) == 2 * one


def test_chunked_rounds_count_each_band():
    """``pd_solve_chunked_plain``'s rounds, per band of 8 rows, equal the
    band flags it ran with, read at each round's first chunk."""
    a, b = _pair([1, 2])
    i13 = torch.stack([b, *tl.centered_gradient(b)], dim=1)
    uv = torch.zeros((2, 2, H, W))
    prep = ts.warp_prep_plain(i13, a, uv)
    seen = []
    chunk = ts.pd_chunk_plain

    def spy(prep, state, act, cfg, iters, band, do_median):
        if do_median:
            seen.append(act.clone())
        return chunk(prep, state, act, cfg, iters, band, do_median)

    rounds = torch.full((2, 5), -1, dtype=torch.int32)
    try:
        ts.pd_chunk_plain = spy
        ts.pd_solve_chunked_plain(prep, uv, CFG, 8, 2, rounds=rounds)
    finally:
        ts.pd_chunk_plain = chunk
    assert torch.equal(rounds, torch.stack(seen).sum(dim=0))
    assert int(rounds.min()) >= 1 and int(rounds.max()) <= CFG.outer_iterations


# -- the bounds chip_smoke.py reads from the tool -----------------------------
# Each value below was computed by the formulas chip_smoke.py held inline
# before they moved into the tool.

def test_bound_helpers_keep_their_values():
    assert [tool.bound(*a) for a in ((1e6, 1e9), (8e9, 1e9), (0, 3.3e11))] \
        == [(0.014925373134328358, "operations"),
            (2.388059701492537, "bytes"), (4.925373134328358, "operations")]
    assert [tool.scale_bound(*a) for a in (
        ([[3, 2, 2, 1, 1], [10, 4, 3, 2, 1]], 224, 224, 30, 5),
        ([[2, 2]] * 15, 280, 300, 30, 0),
        ([[10] * 5] * 64, 92, 92, 30, 5))] == [
        (0.05643826435820896, "operations"),
        (0.15966268656716417, "operations"),
        (1.0371214595820895, "operations")]
    assert [tool.chunk_bound(*a) for a in (
        (2, 1080, 1920, 6, 0), (2, 1080, 1920, 6, 5),
        (4, 553, 983, 4, 3))] == [
        (0.0792300895522388, "bytes"), (0.0792300895522388, "bytes"),
        (0.04154069970149254, "bytes")]


FB_WORK = {
    (16, 15, 224, 224, 224, 224, 1.0, 15): {
        "fb_prologue": (19267584, 175013888),
        "fb_warp_neq": (51179520, 75264000),
        "sep_corr": (30105600, 112896000),
        "sep_corr_x_solve": (21073920, 121927680),
        "fb_window_solve": (21073920, 234823680),
        "fb_iteration": (42147840, 310087680)},
    (16, 15, 224, 224, 56, 56, 0.25, 15): {
        "fb_prologue": (4214784, 39990272), "fb_warp_neq": (3198720, 4704000),
        "sep_corr": (1881600, 7056000),
        "sep_corr_x_solve": (1317120, 7620480),
        "fb_window_solve": (1317120, 14676480),
        "fb_iteration": (2634240, 19380480)},
    (16, 15, 240, 320, 120, 160, 0.5, 201): {
        "fb_prologue": (11059200, 80793600),
        "fb_warp_neq": (19584000, 28800000),
        "sep_corr": (11520000, 578880000),
        "sep_corr_x_solve": (8064000, 582336000),
        "fb_window_solve": (8064000, 1161216000),
        "fb_iteration": (16128000, 1190016000)}}


@pytest.mark.parametrize("args", sorted(FB_WORK))
def test_farneback_kernel_work_keeps_its_values(args):
    frames, pairs, H_, W_, lh, lw, scale, taps = args
    assert tool.farneback_kernel_work(
        frames, pairs, H_, W_, lh, lw, scale, len(fk._smooth_taps(scale)),
        2 * 5 + 1, taps) == FB_WORK[args]


def test_cnn_work_keeps_cnn_flops_values():
    nets = ((resnet18(101, width=8), (2, 64, 64, 3), 13493504),
            (flow_stream_resnet18(10, 101, width=16), (1, 96, 80, 20),
             94250240),
            (resnet18(101, dtype=torch.bfloat16, width=64), (1, 224, 224, 3),
             3627226112))
    for net, shape, flops in nets:
        assert tool.cnn_work(net, torch.zeros(shape)).flops == flops


def test_chip_smoke_reads_the_tools_counts():
    """chip_smoke.py keeps no second copy: its bounds are the tool's
    functions and it defines no peak or CNN count of its own."""
    cs = _load(os.path.join(REPO, "chip_smoke.py"), "chip_smoke_counts")
    for name in ("bound", "scale_bound", "chunk_bound"):
        assert getattr(cs, name) is getattr(cs.ROOFLINE, name), name
    for name in ("HBM_BYTES_PER_S", "F32_FLOP_PER_S", "BF16_FLOP_PER_S",
                 "BATCHER_25", "cnn_flops"):
        assert not hasattr(cs, name), name
    assert cs.ROOFLINE.__file__ == os.path.join(REPO, "tools",
                                                "torch_roofline.py")
