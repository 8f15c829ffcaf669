"""Both Video Swin streams' share of their roofline: the benchmark's
count of a batch's products (``work_swin.cnn_ops``: each operation at the
larger of its bfloat16 compute bound and its bytes on HBM, summed) over
the device time a batch of the kernels launched inside ``va/spatial``
and ``va/temporal`` in the traced slice of the cell's own traffic
(``spans.py``)."""

from bench_h100 import spans, work, work_swin


def read(view):
    r = spans.of(view)
    if r is None or not hasattr(view, "swin_ops"):
        return None
    seconds = (r.device_s.get("va/spatial", 0.0)
               + r.device_s.get("va/temporal", 0.0)) / r.batches
    if seconds <= 0:
        return None
    return work.share("swin_roofline",
                      work_swin.least_seconds(view.swin_ops()), seconds)
