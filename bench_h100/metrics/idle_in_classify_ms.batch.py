"""Device-idle milliseconds a batch while the launching thread is inside
the program's ``va/classify_batch`` span (its innermost open span lies
within it), over the complete such spans of a traced slice of the cell's
own traffic (``spans.py``)."""

from bench_h100 import spans


def read(view):
    r = spans.of(view)
    if r is None:
        return None
    return 1e3 * r.idle_in_batch_s / r.batches
