"""Readings that set the benchmark's limits and rates, on the card; the
benchmark's own runs never call this.

    python3 bench_h100/calibrate.py --workload <cell> readings --seeds 1,2,3 [--seconds 2]
        the compared numbers of sound runs of the program, one short
        window a seed, in one process (the lower readings);
    python3 bench_h100/calibrate.py --workload <cell> control --seeds 1,2,3 [--lower cnn|flow]
        a control's numbers: the reference with float8 CNNs (``cnn``) or
        a bfloat16 flow (``flow``) against the float32 reference on the
        windows a run checks (the upper readings);
    python3 bench_h100/calibrate.py --workload <cell> fault --name half_batch --seeds 1,2
        a run with a broken program, or a control, underneath
        (``faults.py``).

One JSON line per reading on standard output.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100 import clips, faults, harness, program  # noqa: E402
from bench_h100 import run as runner  # noqa: E402
from bench_h100 import weights as make  # noqa: E402
from bench_h100.reference import pipeline as ref  # noqa: E402


def _run(spec, cell, seed, seconds, prog):
    r = runner.Run(spec, cell, seed, seconds, False, harness.require_devices(1),
                   prog, time.perf_counter())
    r.limits = {k: math.inf for k in r.limits}
    out = r.spec.loop(r.traffic["loop"]).run(r)
    _, checks = runner.judge(out, r.limits)
    return out, {k: c["value"] for k, c in checks.items()}


def checked_windows(spec, cell, seed, device) -> np.ndarray:
    """The windows a run of `cell` with `seed` checks, made as the run
    makes them."""
    c = spec.cell(cell)
    cfg, tr = spec.config(c["config"]), spec.traffic(c["traffic"])
    if tr["loop"] == "closed_batch":
        B, T, P = tr["batch_clips"], tr["frames"], tr["pool_clips"]
        pool = torch.stack(clips.make_clips(seed, [T] * P, tr["content"],
                                            device)).cpu().numpy()
        checked = np.random.default_rng([seed, 2]).integers(0, P // B, B)
        return np.stack([pool[j * B + s] for s, j in enumerate(checked)])
    raise ValueError(f"{cell}: no checked windows for a {tr['loop']} loop")


def control_numbers(spec, cell, seed, device, lower: str) -> dict:
    """A control's compared numbers against the float32 reference on the
    windows a run of `cell` with `seed` checks: the CNNs in float8
    (``cnn``, sharing the float32 flow) or the flow in bfloat16
    (``flow``); its flow stacks rounded to the dtype the program's
    temporal stream takes, as the program's are."""
    cfg = spec.config(spec.cell(cell)["config"])
    pre = cfg["preprocess"]
    dtype = getattr(torch, cfg["model"]["dtype"])
    wins = torch.from_numpy(checked_windows(spec, cell, seed, device)
                            ).to(device)
    w = make.make_weights(seed, device, cfg["model"])

    def stacks(flow):
        return [ref.flow_stacks(f, pre["flow_stack"], pre["flow_bound"]
                                ).to(dtype).float().cpu() for f in flow]

    with torch.no_grad():
        want = ref.classify(wins, cfg, w)
        flow = ref.classify.last_flow
        if lower == "cnn":
            got = ref.classify(wins, cfg, w, precision="fp8", flow=flow)
        else:
            got = ref.classify(wins, cfg, w, flow_dtype=torch.bfloat16)
        pairs = list(zip(stacks(ref.classify.last_flow), stacks(flow)))
    return {"logp_gap": runner.logp_gap(list(zip(got.cpu().numpy(),
                                                 want.cpu().numpy()))),
            "flow_epe_px": runner.flow_epe(pairs, pre["flow_bound"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("what", choices=("readings", "control", "fault"))
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--name", default="half_batch")
    ap.add_argument("--lower", choices=("cnn", "flow"), default="cnn")
    args = ap.parse_args(argv)
    harness.set_caches(ROOT)
    spec = harness.Spec()
    cell = args.workload
    seeds = [int(s) % (1 << 64) for s in args.seeds.split(",") if s]
    dev = harness.require_devices(1)

    def emit(**kw):
        print(json.dumps({"cell": cell, "what": args.what, **kw}),
              flush=True)

    if args.what == "readings":
        for s in seeds:
            out, nums = _run(spec, cell, s, args.seconds, program)
            emit(seed=s, e2e=out["e2e"], **nums)
    elif args.what == "fault":
        for s in seeds:
            _, nums = _run(spec, cell, s, args.seconds,
                           faults.FAULTS[args.name]())
            emit(seed=s, fault=args.name, **nums)
    else:
        for s in seeds:
            emit(seed=s, control=args.lower,
                 **control_numbers(spec, cell, s, dev, args.lower))
    return 0


if __name__ == "__main__":
    sys.exit(main())
