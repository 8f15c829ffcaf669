"""Device milliseconds a batch of the kernels the program launched inside
its ``va/spatial`` and ``va/temporal`` spans (both Video Swin streams,
one clip volume a window each), over the complete ``va/classify_batch``
spans of a traced slice of the cell's own traffic (``spans.py``)."""

from bench_h100 import spans


def read(view):
    r = spans.of(view)
    if r is None:
        return None
    return 1e3 * (r.device_s.get("va/spatial", 0.0)
                  + r.device_s.get("va/temporal", 0.0)) / r.batches
