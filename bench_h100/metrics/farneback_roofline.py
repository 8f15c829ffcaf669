"""Farneback's share of its roofline in a clip cell: the benchmark's
count of a batch's flow call (``work.farneback_work`` over its frames
and pairs at the crop), the larger of its float32 and its HBM bound,
over the device time a batch of the kernels launched inside ``va/flow``
(gray conversion included) in the traced slice of the cell's own
traffic (``spans.py``)."""

from bench_h100 import spans, work


def read(view):
    r = spans.of(view)
    if r is None or not hasattr(view, "cnn_work"):
        return None
    seconds = r.device_s.get("va/flow", 0.0) / r.batches
    if seconds <= 0:
        return None
    return work.share("farneback_roofline",
                      view.flow_work().least_seconds(), seconds)
