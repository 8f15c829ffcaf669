"""Both R(2+1)D streams' share of their roofline in a clip cell: the
benchmark's count of a batch's convolution and head products
(``work_r2p1d.cnn_work``: 2 per multiply-add on the bfloat16 roof) or
their bytes on HBM's, whichever is larger, over the device time a batch
of the kernels launched inside ``va/spatial`` and ``va/temporal`` in the
traced slice of the cell's own traffic (``spans.py``)."""

from bench_h100 import spans, work


def read(view):
    r = spans.of(view)
    if r is None or not hasattr(view, "cnn_work"):
        return None
    seconds = (r.device_s.get("va/spatial", 0.0)
               + r.device_s.get("va/temporal", 0.0)) / r.batches
    if seconds <= 0:
        return None
    return work.share("conv2plus1d_roofline",
                      view.cnn_work().least_seconds(), seconds)
