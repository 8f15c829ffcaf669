"""A tiny copy of the benchmark's specification for tests on the CPU:
the same loops and metrics, at sizes a test run holds."""

import json
import os
import shutil

from bench_h100 import harness

TINY_CONTENT = {"height": 40, "width": 52, "max_speed_px": 1.5,
                "max_zoom_rate": 0.003, "noise_sd": 2.0, "texture_px": 64}


def tiny_config(name: str, algo: str) -> dict:
    with open(os.path.join(harness.HERE, "configs",
                           f"r18x2_{algo}.json")) as f:
        cfg = json.load(f)
    cfg["name"] = name
    cfg["model"].update(width=8, num_classes=7)
    cfg["preprocess"].update(resize_short=36, crop=32)
    cfg["window"] = 12
    cfg["flow"]["tvl1"].update(nscales=2, warps=2, inner_iterations=4,
                               outer_iterations=3)
    cfg["flow"]["farneback"].update(levels=1, winsize=5, iterations=2)
    return cfg


def make_spec(tmp: str, limit: float = 0.05) -> harness.Spec:
    """A checkout under `tmp`: BENCHMARK.json with a tiny batch cell of
    each algorithm, the real loops and metrics copied."""
    bench = os.path.join(tmp, "bench")
    for sub in ("loops", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(bench, sub))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    configs, cells = [], []
    for algo in ("tvl1", "farneback"):
        name = f"tiny_{algo}"
        path = os.path.join(bench, "configs", name + ".json")
        with open(path, "w") as f:
            json.dump(tiny_config(name, algo), f)
        configs.append({"name": name, "source": "test", "file": path,
                        "reduced": [], "why": "test"})
        cells.append({"name": f"{algo}_batch", "config": name,
                      "traffic": "tiny_batch", "chips": 1, "why": "test"})
    data["configs"], data["workloads"] = configs, cells
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(bench, "traffic", "tiny_batch.json"), "w") as f:
        json.dump({"loop": "closed_batch", "batch_clips": 2, "frames": 12,
                   "pool_clips": 4, "content": TINY_CONTENT}, f)
    for c in cells:
        with open(os.path.join(bench, "limits", c["name"] + ".json"),
                  "w") as f:
            json.dump({"logp_gap": limit, "flow_epe_px": limit}, f)
    return harness.Spec(root=tmp, bench=bench)
