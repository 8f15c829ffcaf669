"""Named spans of the program on torch.profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler session records, so each span lies beside the kernels it
launched; otherwise it is one shared null context, and a hot path pays
only the check of the profiler's flag.  ``runtime.profiling`` re-exports
it; it lives here so that ``flow/`` and ``ingest/`` import it without
loading ``runtime/``, whose package imports the flow.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str, *args):
    """A range named `name`, or ``name % args`` where `args` are given:
    formatted only while a profiler records.  The program's spans begin
    with ``va/``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name % args if args else name)
