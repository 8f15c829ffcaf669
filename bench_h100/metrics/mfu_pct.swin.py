"""Whole-step MFU of a Video Swin cell: the least time of the window's
work on the compute roofs (bfloat16 products at 989 TFLOP/s, then
float32 operations at 67, one stream), over the window's seconds.  The
work is the benchmark's count of a batch, crop to fusion
(``work_swin.batch_work``), times the batches that ran."""

from bench_h100 import work


def read(view):
    if view.kind != "batch" or not hasattr(view, "swin_ops"):
        return None
    least = view.batches * view.batch_work().compute_seconds()
    return work.share("mfu_pct.swin", least, view.window_s)
