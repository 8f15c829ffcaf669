"""``tpuva-torch warmup`` on the CPU at tiny sizes: its JSON has the JAX
command's keys (one ``compiled`` entry per algorithm and bucket, and per
algorithm and classify surface, and ``cache_dir``, here the kernels' build
directory), ``warm_batched`` runs the batch function at the shape that
``eval-ucf101 --batched`` then dispatches for clips of ``--src``, and an
algorithm the JAX command refuses is refused the same way."""

import json
import os

import pytest
import torch

from video_analytics_tpu.cli.main import main as jax_main
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.runtime import evaluate as ev

torch.set_num_threads(1)

SRC = (48, 64)
MODEL = ["--num-classes", "2", "--width", "8", "--flow-stack", "2",
         "--resize-short", "36", "--crop", "32", "--window", "3",
         "--tv-nscales", "1", "--tv-warps", "1", "--tv-outer", "1",
         "--tv-inner", "2", "--fb-levels", "0", "--fb-iterations", "1",
         "--device", "cpu"]
WARMUP = ["warmup", "--algos", "tvl1,farneback", "--sizes", "24x32,30x40",
          "--batch", "2", "--src", f"{SRC[0]}x{SRC[1]}", "--batch-clips", "2",
          *MODEL]
# The keys of the JAX command's entries (video_analytics_tpu/cli/main.py,
# cmd_warmup): a flow size, the eval-ucf101 --batched program, serve.
FLOW_KEYS = {"algo", "bucket", "secs"}
EVAL_KEYS = {"algo", "surface", "shape", "secs"}
SERVE_KEYS = {"algo", "surface", "secs"}


def _run(argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture()
def batch_shapes(monkeypatch):
    """The windows' shape of every batch-function call."""
    shapes = []
    real = ev.batch_clip_metrics

    def spy(windows, *a, **kw):
        shapes.append(tuple(windows.shape))
        return real(windows, *a, **kw)

    monkeypatch.setattr(ev, "batch_clip_metrics", spy)
    return shapes


@pytest.mark.parametrize("surface", ["all", "flow", "classify"])
def test_warmup_entries_have_the_reference_keys(surface, capsys,
                                                batch_shapes):
    out = _run(WARMUP + ["--surface", surface], capsys)
    assert set(out) == {"compiled", "cache_dir"}
    assert out["cache_dir"] == _build.build_dir()
    assert os.path.dirname(out["cache_dir"]) == _build.BUILD_ROOT
    flow = [e for e in out["compiled"] if "surface" not in e]
    eval_ = [e for e in out["compiled"] if e.get("surface") == "eval-batched"]
    serve = [e for e in out["compiled"] if e.get("surface") == "serve"]
    assert len(flow) + len(eval_) + len(serve) == len(out["compiled"])
    # 24x32 and 30x40 share one bucket, warmed once per algorithm.
    want_flow = ([(a, [64, 64]) for a in ("tvl1", "farneback")]
                 if surface in ("flow", "all") else [])
    assert [(e["algo"], e["bucket"]) for e in flow] == want_flow
    classify = surface in ("classify", "all")
    algos = ["tvl1", "farneback"] if classify else []
    assert [e["algo"] for e in eval_] == [e["algo"] for e in serve] == algos
    for entries, keys in ((flow, FLOW_KEYS), (eval_, EVAL_KEYS),
                          (serve, SERVE_KEYS)):
        for e in entries:
            assert set(e) == keys and e["secs"] >= 0, e
    # One batch-function call per algorithm, at its entry's shape.
    assert batch_shapes == [tuple(e["shape"]) for e in eval_]


def test_flow_entry_keys_equal_the_jax_commands(capsys):
    """The JAX command's flow entries on the same flags: the same keys,
    and the same algorithm and bucket (the 64-multiple ladder's, each
    bucket once) in the same order."""
    argv = ["warmup", "--algos", "farneback", "--sizes", "24x32,30x40,70x40",
            "--batch", "1", "--surface", "flow",
            *[a for a in MODEL if a not in ("--device", "cpu")]]
    assert jax_main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = _run(argv + ["--device", "cpu"], capsys)
    assert set(ours) == set(theirs)
    assert [set(e) for e in ours["compiled"]] == [
        set(e) for e in theirs["compiled"]] == [FLOW_KEYS] * 2
    assert ([(e["algo"], e["bucket"]) for e in ours["compiled"]]
            == [(e["algo"], e["bucket"]) for e in theirs["compiled"]]
            == [("farneback", [64, 64]), ("farneback", [128, 64])])


def test_warm_batched_shape_is_what_eval_dispatches(tmp_path, capsys,
                                                    batch_shapes):
    """The eval-batched entry's shape, and the shape the batch function ran
    at, equal the batch ``eval-ucf101 --batched`` then dispatches on clips
    of --src with the same flags."""
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    ds = build_synthetic_ucf101(str(tmp_path / "ucf"), num_classes=2,
                                clips_per_class=2, num_frames=8, h=SRC[0],
                                w=SRC[1])
    assert len(ds.test_records()) == 2
    for algo in ("tvl1", "farneback"):
        del batch_shapes[:]
        warm = _run(WARMUP + ["--surface", "classify", "--algos", algo],
                    capsys)
        shape = warm["compiled"][0]["shape"]
        assert batch_shapes[0] == tuple(shape)
        del batch_shapes[:]
        res = _run(["eval-ucf101", "--videos", ds.videos_root,
                    "--annotations", ds.annotations_root, "--batched",
                    "--batch-clips", "2", "--algo", algo, *MODEL], capsys)
        assert res["total"] == 2 and res["failed"] == 0
        assert batch_shapes == [tuple(shape)], (batch_shapes, shape)


@pytest.mark.parametrize("algo,surface", [("spynet", "flow"),
                                          ("spynet", "classify"),
                                          ("optical", "flow")])
def test_warmup_refuses_what_the_reference_refuses(algo, surface, capsys):
    """SpyNet (warmup loads no SpyNet weights) and an unknown algorithm
    raise ValueError in both commands."""
    argv = ["warmup", "--algos", algo, "--sizes", "24x32", "--batch", "1",
            "--surface", surface, "--src", f"{SRC[0]}x{SRC[1]}",
            "--batch-clips", "1", *MODEL]
    with pytest.raises(ValueError):
        main(argv)
    if surface == "flow":
        with pytest.raises(ValueError):
            jax_main([a for a in argv if a not in ("--device", "cpu")])


def test_warmup_on_a_missing_card_raises():
    """--device cuda without a card is an error, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["warmup", "--sizes", "24x32", "--device", "cuda"])
