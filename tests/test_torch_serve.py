"""The port's serving surface on the CPU: ClipServer's line protocol and
decode-ahead loop, the ``tpuva-torch serve`` command, and the package's
boundaries (no JAX imported; chip_smoke.py refuses to run without a GPU
or without the package beside it)."""

import io
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from video_analytics_tpu_torch.config import (
    PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime.serve import ClipServer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=72, crop=64, flow_stack=3),
    window=4, num_classes=5,
    tvl1=TVL1Config(nscales=2, warps=1, outer_iterations=2,
                    inner_iterations=3, median_filtering=5))
SMALL_ARGS = ["--num-classes", "5", "--resize-short", "72", "--crop", "64",
              "--flow-stack", "3", "--window", "4", "--width", "8",
              "--tv-nscales", "2", "--tv-warps", "1", "--tv-outer", "2",
              "--tv-inner", "3"]


@pytest.fixture(scope="module")
def server():
    model = TwoStreamModel.create(num_classes=5, flow_stack=3, width=8)
    model.init(torch.Generator().manual_seed(0))
    return ClipServer(model, CFG, torch.device("cpu"), topk=3)


def test_serve_forever_answers_classify_ping_shutdown(server, tiny_clip):
    stdin = io.StringIO("\n".join([
        json.dumps({"path": tiny_clip, "id": 1}),
        "",                                      # blank lines skipped
        json.dumps({"cmd": "ping", "id": 2}),
        json.dumps({"path": "/nope/missing.mp4", "id": 3}),
        json.dumps({"cmd": "shutdown"}),
        json.dumps({"path": tiny_clip, "id": 4}),   # never reached
    ]) + "\n")
    stdout = io.StringIO()
    served = server.serve_forever(stdin=stdin, stdout=stdout)
    lines = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert [ln.get("id") for ln in lines] == [1, 2, 3, None]
    first = lines[0]
    assert first["path"] == tiny_clip and 0 <= first["top1"] < 5
    probs = [t["prob"] for t in first["topk"]]
    assert len(probs) == 3 and probs == sorted(probs, reverse=True)
    assert lines[1]["ok"] is True and lines[1]["served"] >= 1
    assert "error" in lines[2]
    assert lines[3] == {"ok": True}
    assert served >= 1


def test_batch_request_matches_single(server, tiny_clip):
    single = server.handle_line(json.dumps({"path": tiny_clip}))
    resp = server.handle_line(json.dumps(
        {"paths": [tiny_clip, "/nope/missing.mp4", tiny_clip], "id": 9}))
    rs = resp["results"]
    assert resp["id"] == 9
    assert [r["path"] for r in rs] == [tiny_clip, "/nope/missing.mp4",
                                       tiny_clip]
    assert "error" in rs[1]
    for r in (rs[0], rs[2]):
        assert r["top1"] == single["top1"]
        np.testing.assert_allclose(r["topk"][0]["prob"],
                                   single["topk"][0]["prob"], atol=1e-6)
    assert "error" in server.handle_line("{not json")
    assert "error" in server.handle_line(json.dumps({"paths": []}))
    assert "error" in server.handle_line(json.dumps({"cmd": "nope"}))


def test_batch_request_decodes_on_threads(server, tiny_clip, tmp_path,
                                          monkeypatch):
    """A batch request decodes its clips on the threads of
    ``ingest.prefetch_clips``: results in request order, a path listed
    twice decoded once, a corrupt clip answered as an error."""
    from tests.fixtures import moving_square_frames
    from video_analytics_tpu_torch.io.video import synthesize_video
    other = synthesize_video(str(tmp_path / "other.mp4"),
                             moving_square_frames(8, 90, 120, step=(1, 2)),
                             fps=10)
    bad = str(tmp_path / "bad.mp4")
    with open(tiny_clip, "rb") as f, open(bad, "wb") as g:
        g.write(f.read(256))
    loads, threads = [], set()
    real = server._load_windows

    def spy(path):
        loads.append(path)
        threads.add(threading.current_thread().name)
        return real(path)

    monkeypatch.setattr(server, "_load_windows", spy)
    paths = [other, bad, tiny_clip, other]
    rs = server.classify_paths(paths)["results"]
    assert [r["path"] for r in rs] == paths
    assert sorted(loads) == sorted([other, bad, tiny_clip])
    assert threading.main_thread().name not in threads
    assert "could not open" in rs[1]["error"]
    assert rs[0] == {**rs[3], "ms": rs[0]["ms"]}
    for r, p in ((rs[0], other), (rs[2], tiny_clip)):
        single = server.classify_path(p)
        assert r["top1"] == single["top1"]
        np.testing.assert_allclose([e["prob"] for e in r["topk"]],
                                   [e["prob"] for e in single["topk"]],
                                   atol=1e-6)


def test_cli_serve_on_cpu(monkeypatch, capsys, tiny_clip):
    from video_analytics_tpu_torch.cli.main import main
    stdin = io.StringIO(json.dumps({"path": tiny_clip}) + "\n"
                        + json.dumps({"cmd": "shutdown"}) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    rc = main(["serve", "--device", "cpu", "--warmup", "--topk", "2",
               *SMALL_ARGS])
    assert rc == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["ready"] is True
    assert "top1" in lines[1] and len(lines[1]["topk"]) == 2
    assert lines[2]["ok"] is True


def test_cli_serve_refuses_missing_cuda_and_unported_algo(monkeypatch):
    from video_analytics_tpu_torch.cli.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["serve", "--device", "cuda", *SMALL_ARGS])
    assert main(["serve", "--device", "cpu", "--algo", "spynet",
                 "--spynet-checkpoint", "missing_spynet.msgpack",
                 *SMALL_ARGS]) == 1


def test_cli_serve_spynet_on_cpu(monkeypatch, capsys, tiny_clip):
    """serve --algo spynet answers a request with the bundled SpyNet."""
    from video_analytics_tpu_torch.cli.main import main
    stdin = io.StringIO(json.dumps({"path": tiny_clip, "id": 2}) + "\n"
                        + json.dumps({"cmd": "shutdown"}) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    assert main(["serve", "--device", "cpu", "--algo", "spynet", "--topk",
                 "5", *SMALL_ARGS]) == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["id"] == 2 and len(lines[0]["topk"]) == 5, lines
    assert abs(sum(e["prob"] for e in lines[0]["topk"]) - 1.0) < 1e-5
    assert lines[1]["ok"] is True


def test_package_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import video_analytics_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'flax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA, and in a directory without the package."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
