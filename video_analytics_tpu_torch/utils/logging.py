"""Stdlib logging for the port's host-side loops (serve, eval, decode).

The port's own copy of ``get_logger`` from
``video_analytics_tpu/utils/logging.py``: the same format, the same
``TPUVA_LOGLEVEL`` switch and the same logger names (``tpuva.serve``,
``tpuva.eval``, ``tpuva.ingest``), so a filter written for the reference's
logs applies to the port's.
"""

from __future__ import annotations

import logging
import os
import sys

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
