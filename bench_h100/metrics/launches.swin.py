"""Kernels a batch that the program launched inside its
``va/classify_batch`` span (copies and fills left out), over the complete
such spans of a traced slice of a Video Swin cell's own traffic
(``spans.py``)."""

from bench_h100 import spans


def read(view):
    r = spans.of(view)
    if r is None:
        return None
    return r.kernels / r.batches
