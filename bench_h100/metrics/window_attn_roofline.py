"""The window attention's share of its roofline: the benchmark's count
of a batch's window attention (``work_swin.attn_ops``: ``qkv``, the
products over each window's tokens and ``proj``, each at the larger of
its bfloat16 compute bound and its least bytes on HBM: the tokens, Q,
K, V and outputs once and the bias table once a call, no bias or mask
laid out per window; summed) over the device time a batch of the kernels
launched inside ``va/swin.attn`` in the traced slice of the cell's own
traffic (``spans.py``).  None where the program has no such span."""

from bench_h100 import spans, work, work_swin


def read(view):
    r = spans.of(view)
    if r is None or not hasattr(view, "window_attn_ops"):
        return None
    seconds = r.device_s.get("va/swin.attn", 0.0) / r.batches
    if seconds <= 0:
        return None
    return work.share("window_attn_roofline",
                      work_swin.least_seconds(view.window_attn_ops()),
                      seconds)
