"""Both CNNs' share of their roofline in a batch cell: the benchmark's
count of the convolution and head products of the spatial stream over a
batch's frames and the temporal stream over its flow stacks (2 per
multiply-add, on the bfloat16 roof) or their bytes on HBM's, whichever
is larger, over the device-busy time (torch.profiler) of the two calls
of ``model.spatial`` and ``model.temporal`` at the cell's shapes, on the
inputs ``classify_batch`` hands them (``test_bench_reference.py``)."""

from bench_h100 import work


def read(view):
    if view.kind != "batch":
        return None
    seconds, w = view.cnn_seconds()
    if seconds is None:
        return None
    return work.share("cnn_roofline", w.least_seconds(), seconds)
