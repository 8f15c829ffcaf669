"""What the benchmark imports: nothing of JAX, flax or the JAX package
``video_analytics_tpu`` anywhere under bench_h100/, compared by whole
top-level name (the port, ``video_analytics_tpu_torch``, only begins with
it); and nothing of the port under reference/."""

import ast
import os
import subprocess
import sys

import pytest

from bench_h100 import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "video_analytics_tpu"}


def _sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(_top_levels(path))


def test_the_check_compares_whole_names():
    assert "video_analytics_tpu_torch" not in FORBIDDEN
    assert "video_analytics_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_levels(path))
    assert "video_analytics_tpu_torch" not in names
    assert not {"program", "faults"} & names


def test_reference_runs_without_the_port_loaded():
    code = (
        "import sys, torch\n"
        "from bench_h100.reference import pipeline\n"
        "from bench_h100.tests import tiny\n"
        "from bench_h100 import weights, clips\n"
        "cfg = tiny.tiny_config('t', 'tvl1')\n"
        "w = weights.make_weights(1, torch.device('cpu'), cfg['model'])\n"
        "x = torch.stack(clips.make_clips(1, [12], tiny.TINY_CONTENT,"
        " torch.device('cpu')))\n"
        "pipeline.classify(x, cfg, w)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'video_analytics_tpu_torch', 'video_analytics_tpu', 'jax'})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_reads_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_analytics_tpu_torch_fake",
                        sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "flax.fake", sys)
    assert "flax" in harness.forbidden_modules()
