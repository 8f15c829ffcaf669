"""Device milliseconds a batch of the kernels the program launched inside
the TimeSformer's ``va/tsf.time`` and ``va/tsf.space`` spans (each
block's time half and space half, both streams: the layer norms,
projections, attention, ``temporal_fc``, the layout change and the
residual adds), over the complete ``va/classify_batch`` spans of a
traced slice of the cell's own traffic (``spans.py``).  None where the
program has no such spans."""

from bench_h100 import spans


def read(view):
    r = spans.of(view)
    if r is None:
        return None
    seconds = (r.device_s.get("va/tsf.time", 0.0)
               + r.device_s.get("va/tsf.space", 0.0))
    if seconds <= 0:
        return None
    return 1e3 * seconds / r.batches
