"""Metrics as JSON lines under ``bench/results/``.

Port of ``video_analytics_tpu/runtime/metrics.py``.  Each record is one
line: ``{"ts": ..., "metric": ..., "value": ..., "unit": ..., **extra}``,
``ts`` the wall clock rounded to the millisecond.  Without a path the
writer appends to ``<repo>/bench/results/metrics.jsonl``, the repository
root being the directory that holds this package, as the reference's
resolves against its own.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path: Optional[str] = None):
        if path is None:
            path = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                "bench", "results", "metrics.jsonl")
        self.path = path

    def emit(self, metric: str, value: float, unit: str,
             **extra: Any) -> Dict[str, Any]:
        """Append one record and return it."""
        rec = {"ts": round(time.time(), 3), "metric": metric,
               "value": value, "unit": unit, **extra}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def emit_stage_timings(self, timings: Dict[str, float],
                           **extra: Any) -> None:
        """One record ``stage_<name>`` in seconds per stage: `timings` is
        ``runtime/profiling.StageTimer``'s ``totals``."""
        for stage, seconds in timings.items():
            self.emit(f"stage_{stage}", seconds, "s", **extra)
