"""BENCHMARK.json against the benchmark's contract, and every file it
names present."""

import json
import os
import re

import pytest

from bench_h100 import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|per_tok|width)")


@pytest.fixture(scope="module")
def spec():
    return harness.Spec()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_of_the_file(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.root, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(d["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in d["command"])
    assert d["command"][1].startswith(d["paths"][0] + "/")
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(spec.root, p))
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(spec):
    d = spec.data
    names = [c["name"] for c in d["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(d["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in d["workloads"])


def test_cells(spec):
    d = spec.data
    seen = set()
    names = [w["name"] for w in d["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    fours = sum(w["chips"] == 4 for w in d["workloads"])
    assert fours <= max(1, len(names) // 4)
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        spec.loop(tr["loop"])
        assert "logp_gap" in spec.limits(w["name"])
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"])


def test_metrics(spec):
    d = spec.data
    e2e = {m["name"]: m for m in d["end_to_end"]}
    names = list(e2e) + [m["name"] for m in d["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(d["per_layer"]) <= 128
    cells = {w["name"] for w in d["workloads"]}
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    layers = {}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in spec.end_to_end(cell)}
        spec.metric(m["name"])
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    with open(os.path.join(spec.root, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def test_files_under_paths_are_named_from_name_characters(spec):
    for dirpath, dirs, files in os.walk(spec.bench):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.root)
            assert PATH.match(rel), rel


def test_configs_state_what_they_assume(spec):
    for c in spec.data["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["model"]["width"] == 64 and cfg["model"]["num_classes"] \
            == 101 and cfg["model"]["stage_sizes"] == [2, 2, 2, 2]
        assert "assumed" in cfg and json.dumps(cfg)
