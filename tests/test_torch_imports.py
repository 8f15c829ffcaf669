"""The port stands alone: a fresh interpreter in which ``jax``, ``flax``,
``msgpack`` and the JAX package cannot be imported imports every module
of ``video_analytics_tpu_torch`` and ``chip_smoke`` (OpenCV not among
them: it is imported where a frame is decoded or resized), answers a serve
request on the CPU from a clip written by the port's own
``synthesize_video``, writes, reads back and classifies from a
checkpoint (also through ``AsyncCheckpointer``), takes one two-stream
train step, runs the bundled SpyNet and
trains one with ``tools/torch_train_spynet.py``, and evaluates a synthetic
UCF101 in a one-process gloo group (``parallel/mesh``), through
``evaluate_batched`` and ``evaluate_batched_multiprocess``; and, in a second
such interpreter, where ``bench`` cannot be imported either, runs
``tools/torch_flow_quality.py`` at a small size,
``tools/torch_eval_breakdown.py``'s ledger and a work count of
``tools/torch_roofline.py``.  Each tool of the reference has
a ``tools/torch_*.py`` counterpart or a named reason (``TOOLS``)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
for name in ("jax", "flax", "msgpack", "video_analytics_tpu"):
    sys.modules[name] = None          # any import of it raises ImportError

import importlib, io, json, os, pkgutil, tempfile
import numpy as np
import torch
import video_analytics_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 42, names
for sub in ("io.video", "io.dataset", "io.flowio", "io.synthetic",
            "flow.farneback", "ops.cuda.farneback", "ops.cuda.tvl1_solve",
            "ingest.prefetch", "runtime.checkpoint", "runtime.evaluate",
            "utils.logging", "ingest.train_loader", "runtime.train",
            "runtime.train_two_stream", "runtime.profiling",
            "models.spynet", "parallel.mesh", "runtime.metrics"):
    assert pkg.__name__ + "." + sub in names, sub
import chip_smoke                      # import only; main() needs a GPU
assert "cv2" not in sys.modules        # imported where a frame is touched

from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.io.video import synthesize_video
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime.serve import ClipServer

torch.set_num_threads(1)
rng = np.random.default_rng(0)
base = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
frames = [np.roll(base, (t, 2 * t), axis=(0, 1)) for t in range(6)]
with tempfile.TemporaryDirectory() as d:
    clip = synthesize_video(os.path.join(d, "clip.mp4"), frames, fps=12.0)
    cfg = PipelineConfig(
        preprocess=PreprocessConfig(resize_short=40, crop=32, flow_stack=2),
        window=3, num_classes=4, flow_algo="farneback",
        farneback=FarnebackConfig(levels=0, iterations=1))
    model = TwoStreamModel.create(num_classes=4, flow_stack=2, width=8)
    model.init(torch.Generator().manual_seed(0))
    server = ClipServer(model, cfg, torch.device("cpu"), topk=2)
    out = io.StringIO()
    server.serve_forever(
        stdin=io.StringIO(json.dumps({"paths": [clip, clip], "id": 3}) + "\n"),
        stdout=out)
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.runtime.evaluate import classify_clip_file
    ckpt = os.path.join(d, "two_stream.msgpack")
    save_variables(ckpt, model.flax_variables())
    again = TwoStreamModel.create(num_classes=4, flow_stack=2, width=8)
    again.load_flax_variables(load_variables(ckpt, again.flax_variables()))
    probs = [classify_clip_file(clip, m.eval(), cfg, "cpu")
             for m in (model, again)]
assert probs[0].shape == (4,) and np.array_equal(probs[0], probs[1]), probs
# The asynchronous checkpointer, and the package's re-exports.
from video_analytics_tpu_torch.runtime.checkpoint import AsyncCheckpointer
from video_analytics_tpu_torch import PipelineConfig as _root_cfg
from video_analytics_tpu_torch.ingest import sliding_windows
from video_analytics_tpu_torch.models import TwoStreamModel as _models_ts
from video_analytics_tpu_torch.runtime.metrics import MetricsWriter
assert _root_cfg is PipelineConfig and _models_ts is TwoStreamModel
assert len(list(sliding_windows(np.stack(frames), 4, 4))) == 2
with tempfile.TemporaryDirectory() as d, AsyncCheckpointer() as ck:
    ck.save(os.path.join(d, "ck"), model.state_dict())
    back = ck.restore(os.path.join(d, "ck"), model.state_dict())
    rec = MetricsWriter(os.path.join(d, "m.jsonl")).emit("x", 1.0, "s")
assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
assert rec["metric"] == "x"

# One two-stream train step on windows of the clip's frames.
import dataclasses
from video_analytics_tpu_torch.runtime import train_two_stream as tts
tcfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
    cfg.preprocess, random_crop=True, random_flip=True))
win = torch.from_numpy(np.stack([frames[:3], frames[1:4]]))
states = tts.create_two_stream_states(model, 0.01, "both")
ex = tts.build_examples(win, tcfg, "both", tts.draw_crops(
    torch.Generator().manual_seed(0), win, tcfg))
metrics = {k: step(ex[k], torch.tensor([0, 3]))
           for k, step in tts.make_two_stream_train_steps(states).items()}
assert all(np.isfinite(float(m["loss"])) for m in metrics.values()), metrics
# SpyNet on its bundled weights, and its training tool for one step.
import importlib.util
from video_analytics_tpu_torch.models.spynet import (
    SpyNet, default_spynet_checkpoint, synthetic_pair)
net = SpyNet()
net.load_flax_variables(load_variables(default_spynet_checkpoint(),
                                       net.flax_variables()))
prev, nxt, gt = synthetic_pair(torch.Generator().manual_seed(0), 1, 40, 48)
with torch.no_grad():
    epe = float(((net(prev, nxt) - gt) ** 2).sum(-1).sqrt().mean())
assert epe < 0.5, epe
spec = importlib.util.spec_from_file_location(
    "torch_train_spynet", os.path.join("tools", "torch_train_spynet.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
with tempfile.TemporaryDirectory() as d:
    assert tool.main(["--steps", "1", "--hw", "32", "--levels", "2",
                      "--device", "cpu",
                      "--out", os.path.join(d, "s.msgpack")]) == 0
    assert os.path.getsize(os.path.join(d, "s.msgpack")) > 0
# The distributed path: a one-process gloo group.
import socket
from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
from video_analytics_tpu_torch.parallel import mesh
from video_analytics_tpu_torch.runtime import evaluate as ev
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
with tempfile.TemporaryDirectory() as d:
    ds = build_synthetic_ucf101(d, num_classes=2, clips_per_class=2,
                                num_frames=6, h=48, w=64)
    mesh.init_distributed(f"127.0.0.1:{port}", 1, 0, "cpu")
    try:
        assert mesh.process_count() == 1
        runs = [f(ds.test_records(), model.eval(), cfg, "cpu", batch_clips=2)
                for f in (ev.evaluate_batched,
                          ev.evaluate_batched_multiprocess)]
    finally:
        mesh.shutdown()
assert runs[0].as_dict() == runs[1].as_dict(), [r.as_dict() for r in runs]
assert runs[0].total == 2 and runs[0].failed == 0, runs[0].as_dict()
resp = json.loads(out.getvalue().splitlines()[0])
assert resp["id"] == 3 and len(resp["results"]) == 2, resp
for r in resp["results"]:
    assert 0 <= r["top1"] < 4 and len(r["topk"]) == 2, r
bad = [m for m in ("jax", "flax", "msgpack", "video_analytics_tpu")
       if sys.modules.get(m) is not None]
assert not bad, bad
print("served", server.served)
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served 2" in proc.stdout


TOOL_CODE = r"""
import sys
for name in ("jax", "flax", "msgpack", "video_analytics_tpu", "bench"):
    sys.modules[name] = None          # any import of it raises ImportError

import contextlib, importlib.util, io, json, os
import torch
from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config

torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location(
    "torch_flow_quality", os.path.join("tools", "torch_flow_quality.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = tool.main(["--hw", "80", "--batch", "1", "--val-batches", "1",
                    "--reps", "1", "--device", "cpu"],
                   tvl1_cfg=TVL1Config(nscales=1, warps=1, outer_iterations=1,
                                       inner_iterations=2),
                   fb_cfg=FarnebackConfig(levels=1, iterations=1))
res = [json.loads(ln) for ln in out.getvalue().splitlines()
       if ln.startswith('{"hw"')]
assert rc == 0 and res and set(res[0]) >= {"spynet", "tvl1", "farneback"}
spec = importlib.util.spec_from_file_location(
    "torch_eval_breakdown", os.path.join("tools", "torch_eval_breakdown.py"))
breakdown = importlib.util.module_from_spec(spec)
spec.loader.exec_module(breakdown)
led = breakdown.ledger({"decode_ms_per_clip": 30.0,
                        "hostprep_ms_per_batch": 4.0,
                        "deviceput_ms_per_batch": 8.0,
                        "device_ms_per_batch_deep": 16.0,
                        "dispatch_rtt_ms": 2.0, "clips_per_sec_e2e": 50.0},
                       8, 2)
assert led["decode_not_hidden"] == 11.25 and led["unattributed"] == 5.0, led
spec = importlib.util.spec_from_file_location(
    "torch_roofline", os.path.join("tools", "torch_roofline.py"))
roofline = importlib.util.module_from_spec(spec)
spec.loader.exec_module(roofline)
work = roofline.farneback_work(16, 15, 224, 224, FarnebackConfig())
assert work.bytes > 0 and work.f32 > 0 and work.bf16 == 0, work
bad = [m for m in ("jax", "flax", "msgpack", "video_analytics_tpu", "bench")
       if sys.modules.get(m) is not None]
assert not bad, bad
print("flow quality", sorted(res[0]["tvl1"]))
print("eval breakdown", led["wall_ms_per_clip"])
print("roofline", work.f32)
"""


def test_flow_quality_tool_runs_without_jax_or_the_jax_package():
    """tools/torch_flow_quality.py, a small run on the CPU,
    tools/torch_eval_breakdown.py's ledger and a Farneback work count of
    tools/torch_roofline.py, in an interpreter where jax, flax, msgpack,
    the JAX package and bench.py cannot be imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", TOOL_CODE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "flow quality" in proc.stdout
    assert "eval breakdown 20.0" in proc.stdout
    assert "roofline " in proc.stdout


# Each tool of the reference in tools/: its counterpart, or why none.
TOOLS = {"eval_breakdown.py": "torch_eval_breakdown.py",
         "flow_quality.py": "torch_flow_quality.py",
         "train_spynet.py": "torch_train_spynet.py",
         "roofline.py": "torch_roofline.py",
         "probe_halo_ceiling.py": "TPU-only: times the banded TV-L1 "
                                  "solver's halo against the TPU's DMA "
                                  "alignment"}
# The port's own tools, with no reference counterpart.
PORT_OWN = {"median_zero_one.py"}
REFERENCE_TOOLS = sorted(
    f for f in os.listdir(os.path.join(REPO, "tools"))
    if f.endswith(".py") and not f.startswith("torch_") and f not in PORT_OWN)


@pytest.mark.parametrize("name", REFERENCE_TOOLS)
def test_every_reference_tool_is_mapped(name):
    assert name in TOOLS, f"tools/{name} has no counterpart and no reason"
    target = TOOLS[name]
    if target.startswith("torch_"):
        assert os.path.isfile(os.path.join(REPO, "tools", target)), target


def _imports_only_torch(rel: str) -> None:
    """`rel` imports only torch, typing and __future__."""
    import ast

    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, rel
            names.add(node.module.split(".")[0])
    assert names and names <= {"__future__", "typing", "torch"}, names


@pytest.mark.parametrize("rel", ["tests/torch_r2plus1d.py",
                                 "bench_h100/reference/r2plus1d.py"])
def test_r2plus1d_references_import_only_torch(rel):
    """The plain R(2+1)D references import nothing of the port, of JAX,
    flax or the JAX package: only torch and the standard library."""
    _imports_only_torch(rel)


@pytest.mark.parametrize("rel", ["tests/torch_timesformer.py",
                                 "bench_h100/reference/timesformer.py"])
def test_timesformer_references_import_only_torch(rel):
    """The plain TimeSformer references import nothing of the port, of
    JAX, flax or the JAX package: only torch and the standard library."""
    _imports_only_torch(rel)


@pytest.mark.parametrize("rel", ["tests/torch_video_swin.py",
                                 "bench_h100/reference/video_swin.py"])
def test_video_swin_references_import_only_torch(rel):
    """The plain Video Swin references import nothing of the port, of
    JAX, flax or the JAX package: only torch and the standard library."""
    _imports_only_torch(rel)
