"""One run of one cell of the port's H100 benchmark.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Makes the cell's weights and traffic from
the seed, sets up and warms the program (``video_analytics_tpu_torch``)
on the first CUDA device, drives the cell's traffic for ``--seconds``,
checks the answers of the window against the plain reference, and prints
one JSON line last on standard output: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics, the device-busy seconds of a
traced slice and its breakdown (``--trace 1``).  The numbers compared,
each beside its limit, are the last lines on standard error.

Exits 2 with no result without the CUDA devices the cell needs, and 3 if
JAX, flax or the JAX package ``video_analytics_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness  # noqa: E402


class Run:
    """One run's settings and the cell's files, handed to its loop."""

    def __init__(self, spec: harness.Spec, cell: str, seed: int,
                 seconds: float, trace: bool, device, program,
                 t_start: float):
        self.spec = spec
        self.cell = spec.cell(cell)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.limits = spec.limits(cell)
        # Any whole number: the generators take it modulo 2**64.
        self.seed = seed % (1 << 64)
        self.seconds, self.trace = seconds, trace
        self.device, self.program, self.t_start = device, program, t_start

    def read_metrics(self, view) -> dict:
        """Each per-layer metric of the cell from its reader; one that
        finds nothing to read is left out."""
        out = {}
        for m in self.spec.per_layer(self.cell["name"]):
            value = self.spec.metric(m["name"]).read(view)
            if value is not None:
                out[m["name"]] = value
        return out


def logp_gap(answers):
    """The widest gap of a log-probability, over every class of every
    compared answer: max |ln p − ln p_ref|; None where an answer has
    another shape or a probability that is not positive."""
    import numpy as np

    gap = 0.0
    for got, want in answers:
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.all(got > 0):
            return None
        gap = max(gap, float(np.abs(np.log(got) - np.log(want)).max()))
    return gap


def flow_epe(stacks, bound: float):
    """The mean endpoint error, in pixels, of the flow fields in the
    temporal stream's input stacks against the reference's, over every
    field of every compared clip: each pair is (the program's (N, h, w,
    2L) stacks, the reference's rounded to their dtype), u and v
    interleaved, scaled by the flow bound.  None where a clip's stacks
    are missing or of another shape."""
    import numpy as np

    total, count = 0.0, 0
    for got, want in stacks:
        if got is None or tuple(got.shape) != tuple(want.shape):
            return None
        d = (np.asarray(got, np.float64) - np.asarray(want, np.float64))
        epe = np.sqrt((d.reshape(*d.shape[:-1], -1, 2) ** 2).sum(-1))
        total += float(epe.sum()) * bound
        count += epe.size
    return total / count if count else None


def judge(out: dict, limits: dict):
    """(correct, checks): each number compared beside its limit.  Correct
    where at least one answer was compared, the widest log-probability
    gap is within its limit, and so is the flow's mean endpoint error
    where the cell's limits name one."""
    answers = out["answers"]
    gap = logp_gap(answers) if answers else None
    checks = {"answers_compared": {"value": len(answers), "limit": 1},
              "logp_gap": {"value": gap, "limit": limits["logp_gap"]}}
    correct = gap is not None and gap <= limits["logp_gap"]
    if "flow_epe_px" in limits:
        epe = flow_epe(out.get("stacks", []), out.get("flow_bound", 1.0))
        checks["flow_epe_px"] = {"value": epe, "limit": limits["flow_epe_px"]}
        correct = correct and epe is not None and epe <= limits["flow_epe_px"]
    return correct, checks


def execute(run: Run) -> dict:
    """The cell's loop, judged, with the metrics the flags ask for."""
    out = run.spec.loop(run.traffic["loop"]).run(run)
    correct, checks = judge(out, run.limits)
    units = {m["name"]: m["unit"] for key in ("end_to_end", "per_layer")
             for m in run.spec.data[key]}
    wanted = (run.spec.per_layer if run.trace
              else run.spec.end_to_end)(run.cell["name"])
    values = out["per_layer"] if run.trace else out["e2e"]
    metrics = {}
    for m in wanted:
        if m["name"] in values:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
        elif not run.trace:
            raise RuntimeError(f"the loop measured no {m['name']}")
    return {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"], "checks": checks,
            "breakdown": out.get("breakdown") if run.trace else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.Spec()
    cell = spec.cell(args.workload)
    try:
        device = harness.require_devices(cell["chips"])
    except harness.NoDevice as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 2
    harness.set_caches(ROOT)
    from bench_h100 import program

    res = execute(Run(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, program, T_START))
    found = harness.forbidden_modules()
    if found:
        print(f"bench_h100: loaded {', '.join(found)}, which the port must "
              f"not use", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(harness.result_line(res["correct"], res["attempted"],
                              res["failed"], res["metrics"], res["device"],
                              res["checks"], res["breakdown"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
