"""Whole-step MFU of a batch cell: the least time of the window's work on
the compute roofs (bfloat16 products at 989 TFLOP/s, then float32
operations at 67, one stream), over the window's seconds.  The work is
the benchmark's count (``work.two_stream_work``) of every batch that
ran, TV-L1 at the rounds its ε test ran on that batch's clips."""

from bench_h100 import work


def read(view):
    if view.kind != "batch":
        return None
    least = sum(n * view.batch_work(j).compute_seconds()
                for j, n in view.batch_counts.items())
    return work.share("mfu_pct.batch", least, view.window_s)
