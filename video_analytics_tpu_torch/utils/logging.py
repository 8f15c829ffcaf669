"""Stdlib logging for the port's host-side loops (serve, eval, decode),
and a JSON-lines metrics sink.

The port's own copy of ``video_analytics_tpu/utils/logging.py``:
``get_logger`` with the same format, the same ``TPUVA_LOGLEVEL`` switch
and the same logger names (``tpuva.serve``, ``tpuva.eval``,
``tpuva.ingest``), so a filter written for the reference's logs applies to
the port's; and its ``MetricsWriter``, which differs from
``runtime/metrics.MetricsWriter`` as the reference's two do: extra fields
come as one dict, ``ts`` is not rounded, and without a path nothing is
written.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    """The logger `name`, given a stderr handler at ``TPUVA_LOGLEVEL``
    (default INFO) unless the application configured logging already."""
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("TPUVA_LOGLEVEL", "INFO"))
    return logger


class MetricsWriter:
    """Append metrics as JSON lines to `path`; with no path, only build
    the records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path

    def emit(self, metric: str, value: float, unit: str,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Build one record (appending it where there is a path) and
        return it."""
        record = {"ts": time.time(), "metric": metric,
                  "value": value, "unit": unit}
        if extra:
            record.update(extra)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record
