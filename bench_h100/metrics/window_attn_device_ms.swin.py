"""Device milliseconds a batch of the kernels the program launched inside
the Video Swin's ``va/swin.attn`` spans (each block's window attention,
both streams: norm1, the rolls, the partition and its reverse, ``qkv``,
the relative position bias and the shift mask, attention, ``proj`` and
the residual add), over the complete ``va/classify_batch`` spans of a
traced slice of the cell's own traffic (``spans.py``).  None where the
program has no such span."""

from bench_h100 import spans


def read(view):
    r = spans.of(view)
    if r is None:
        return None
    seconds = r.device_s.get("va/swin.attn", 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / r.batches
