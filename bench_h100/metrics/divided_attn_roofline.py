"""The divided attention's share of its roofline: the benchmark's count
of a batch's time and space halves (``work_tsf.attn_ops``: their
projections, ``temporal_fc`` and attention products, each at the larger
of its bfloat16 compute bound and the least bytes of its tokens, Q, K,
V and outputs on HBM, summed) over the device time a batch of the
kernels launched inside ``va/tsf.time`` and ``va/tsf.space`` in the
traced slice of the cell's own traffic (``spans.py``).  None where the
program has no such spans."""

from bench_h100 import spans, work, work_tsf


def read(view):
    r = spans.of(view)
    if r is None or not hasattr(view, "attn_ops"):
        return None
    seconds = (r.device_s.get("va/tsf.time", 0.0)
               + r.device_s.get("va/tsf.space", 0.0)) / r.batches
    if seconds <= 0:
        return None
    return work.share("divided_attn_roofline",
                      work_tsf.least_seconds(view.attn_ops()), seconds)
