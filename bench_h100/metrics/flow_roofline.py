"""The flow's share of its roofline in a batch cell: the benchmark's
count of one pass over every distinct batch's flow call (TV-L1 at the
rounds each ran, checked against the reference's on the checked clips),
the larger of its float32 and its HBM bound, over the device-busy time
(torch.profiler) of that pass.

The pass calls the port's public flow entries as ``program.batch_flow``
does, which follows the flow route inside ``classify_batch``
(``runtime.pipeline._sequence_flow``); ``test_bench_reference.py`` holds
the two equal.  A program change that moves the batch's flow to another
route leaves this metric timing the public entries."""

from bench_h100 import work


def read(view):
    if view.kind != "batch":
        return None
    total = work.Work()
    for j in range(view.n_distinct):
        total += view.flow_work(j)
    seconds = view.flow_seconds()
    if seconds is None:
        return None
    return work.share("flow_roofline", total.least_seconds(), seconds)
