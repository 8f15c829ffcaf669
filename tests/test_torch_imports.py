"""The port stands alone: a fresh interpreter in which ``jax``, ``flax``,
``msgpack`` and the JAX package cannot be imported imports every module
of ``video_analytics_tpu_torch`` and ``chip_smoke`` (OpenCV not among
them: it is imported where a frame is decoded or resized), answers a serve
request on the CPU from a clip written by the port's own
``synthesize_video``, and writes, reads back and classifies from a
checkpoint."""

import os
import subprocess
import sys

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
assert len(names) >= 35, names
for sub in ("io.video", "io.dataset", "io.flowio", "io.synthetic",
            "flow.farneback", "ops.cuda.farneback", "ops.cuda.tvl1_solve",
            "ingest.prefetch", "runtime.checkpoint", "runtime.evaluate",
            "utils.logging"):
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
