"""The traffic generators and the end-to-end arithmetic, on the CPU."""

import json
import math
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from bench_h100 import clips, harness, program, trace
from bench_h100 import run as runner
from bench_h100.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def spec():
    with tempfile.TemporaryDirectory() as tmp:
        yield tiny.make_spec(tmp)


def _run(spec, cell, seed, seconds, trace_on=False, prog=program):
    return runner.execute(runner.Run(spec, cell, seed, seconds, trace_on,
                                     CPU, prog, time.perf_counter()))


def test_clips_repeat_for_a_seed_and_differ_between_seeds():
    a = clips.make_clips(2**31 + 11, [6, 9], tiny.TINY_CONTENT, CPU)
    b = clips.make_clips(2**31 + 11, [6, 9], tiny.TINY_CONTENT, CPU)
    c = clips.make_clips(2**31 + 12, [6, 9], tiny.TINY_CONTENT, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [x.shape for x in a] == [x.shape for x in c]
    assert a[0].dtype == torch.uint8 and a[1].shape == (9, 40, 52, 3)


def test_every_seed_has_the_same_motions_in_another_order():
    a = clips.motions(5, 16, tiny.TINY_CONTENT)
    b = clips.motions(6, 16, tiny.TINY_CONTENT)
    assert not np.allclose(a, b)
    strata = np.floor(a[:, 0] / 1.5 * 16)
    assert sorted(strata) == list(range(16))
    assert np.allclose(np.sort(np.floor(b[:, 0] / 1.5 * 16)), strata[
        np.argsort(strata)])


def test_rate_is_every_clip_over_the_whole_window(tmp_path):
    # The tiny Farneback cell, whose batches are short beside the window,
    # reporting the rate as a cell added beside tvl1_batch would.
    spec = tiny.make_spec(str(tmp_path))
    for m in spec.data["end_to_end"]:
        if m["name"] == "clips_per_s":
            m["workloads"] = m["workloads"] + ["farneback_batch"]
    res = _run(spec, "farneback_batch", 2**31 + 1, 0.6)
    rate = res["metrics"]["clips_per_s"]["value"]
    assert res["attempted"] % 2 == 0 and res["attempted"] >= 2
    # No batch starts after the window; the last one ends after it.
    assert res["attempted"] / rate >= 0.6
    assert res["attempted"] / rate < 0.6 + 2.0
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a mix, a per-layer metric and a cell that exist
    only as new files and entries are run with no file edited."""
    spec = tiny.make_spec(str(tmp_path))
    bench = spec.bench
    cfg = tiny.tiny_config("tiny_new", "farneback")
    cfg["flow"]["farneback"]["winsize"] = 7
    with open(os.path.join(bench, "configs", "tiny_new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_batch.json")) as f:
        mix = json.load(f)
    with open(os.path.join(bench, "traffic", "tiny_new_mix.json"), "w") as f:
        json.dump(dict(mix, batch_clips=1, pool_clips=1), f)
    with open(os.path.join(bench, "metrics", "batches_run.py"), "w") as f:
        f.write("def read(view):\n    return float(view.batches)\n")
    with open(os.path.join(bench, "limits", "new_cell.json"), "w") as f:
        json.dump({"logp_gap": 0.05}, f)
    data = dict(spec.data)
    data["configs"] = data["configs"] + [{
        "name": "tiny_new", "source": "test", "reduced": [], "why": "test",
        "file": os.path.join(bench, "configs", "tiny_new.json")}]
    data["workloads"] = data["workloads"] + [{
        "name": "new_cell", "config": "tiny_new", "traffic": "tiny_new_mix",
        "chips": 1, "why": "test"}]
    data["per_layer"] = data["per_layer"] + [{
        "name": "batches_run", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "pipeline",
        "moves": "clips_per_s", "workloads": ["new_cell"]}]
    data["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new_cell"])
                          if m["name"] == "clips_per_s" else m
                          for m in data["end_to_end"]]
    with open(os.path.join(spec.root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    fresh = harness.Spec(root=spec.root, bench=bench)
    res = _run(fresh, "new_cell", 9, 0.3, trace_on=True)
    assert res["metrics"]["batches_run"]["value"] >= 1
    assert set(res["metrics"]) == {"batches_run"}
    assert res["correct"]
    res = _run(fresh, "new_cell", 9, 0.3)
    assert res["attempted"] >= 1 and "clips_per_s" in res["metrics"]


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "tvl1_batch", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "no CUDA device" in err


def test_seeds_of_any_size_are_taken():
    r = runner.Run(harness.Spec(), "tvl1_batch", -(2**40) - 3, 1.0, False,
                   CPU, program, 0.0)
    assert 0 <= r.seed < 2**64
    assert math.isfinite(r.seed)
