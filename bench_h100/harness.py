"""What every run shares: the specification read by name, the device
checks, the caches inside the checkout, the timing helpers, and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The harness finds, by those names alone:

  - the configuration at the ``file`` that ``configs`` gives it;
  - the traffic mix at ``traffic/<traffic>.json``, whose ``loop`` names
    the generator module ``loops/<loop>.py`` that drives it;
  - each per-layer metric at ``metrics/<metric>.py`` (a ``read(view)``
    that returns a number, or None where it finds nothing to read);
  - each cell's comparison limits at ``limits/<cell>.json``.

So a later change adds a configuration, a mix, a metric or a cell by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "video_analytics_tpu")


class Spec:
    """``BENCHMARK.json`` and the files it names, under `root` (the
    checkout) and `bench` (this folder; tests point both elsewhere)."""

    def __init__(self, root: str = ROOT, bench: str = HERE):
        self.root, self.bench = root, bench
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for c in self.data["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.bench, *parts)) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell + ".json")

    def loop(self, kind: str):
        path = os.path.join(self.bench, "loops", kind + ".py")
        return _load(path, "bench_h100_loop_" + kind)

    def metric(self, name: str):
        return _load(os.path.join(self.bench, "metrics", name + ".py"),
                     "bench_h100_metric_" + name.replace(".", "_"))

    def _for_cell(self, key: str, cell: str) -> List[dict]:
        return [m for m in self.data[key]
                if "workloads" not in m or cell in m["workloads"]]

    def end_to_end(self, cell: str) -> List[dict]:
        return self._for_cell("end_to_end", cell)

    def per_layer(self, cell: str) -> List[dict]:
        return self._for_cell("per_layer", cell)


def _load(path: str, module_name: str):
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


# -- the device --------------------------------------------------------------

class NoDevice(RuntimeError):
    pass


def require_devices(count: int):
    """The first CUDA device, after checking that `count` are there."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < count:
        raise NoDevice(f"the cell needs {count} CUDA devices, "
                       f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def set_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's kernel library builds into its own ``_build/``)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# -- the result ---------------------------------------------------------------

def note(text: str) -> None:
    """A line for the reader of the run's standard error."""
    print(f"bench_h100: {text}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict, checks: dict,
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
