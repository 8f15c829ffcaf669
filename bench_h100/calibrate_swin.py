"""The controls of the Video Swin cells (``loops/swin_batch.py``), on the
card; the benchmark's own runs never call this.

    python3 bench_h100/calibrate_swin.py --workload <cell> --seeds 1,2,3 [--lower cnn|flow|bias|mask]

prints, one JSON line a seed, a control's compared numbers against the
float32 reference (``reference/swin_pipeline.py``) on the windows a run
of the cell checks: the reference with every product of both
transformers in float8 (``cnn``, sharing the float32 flow), with its
flow in bfloat16 (``flow``), or with the relative position bias
(``bias``) or the shift mask (``mask``) left out of every block (sharing
the float32 flow), its flow volume rounded to the dtype the program's
temporal stream takes, as the program's is.  The lower
readings and the faults come from ``calibrate.py readings`` and
``calibrate.py fault``, whose runs go through the cell's own loop.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100 import clips, harness, weights_swin  # noqa: E402
from bench_h100 import run as runner  # noqa: E402
from bench_h100.reference import swin_pipeline as ref  # noqa: E402
from bench_h100.reference.clip_pipeline import volume  # noqa: E402


def checked_windows(spec, cell, seed, device) -> np.ndarray:
    """The windows a run of the Video Swin cell `cell` with `seed`
    checks, made as the run makes them."""
    tr = spec.traffic(spec.cell(cell)["traffic"])
    if tr["loop"] != "swin_batch":
        raise ValueError(f"{cell}: not a swin_batch cell")
    B, T, P = tr["batch_clips"], tr["frames"], tr["pool_clips"]
    pool = torch.stack(clips.make_clips(seed, [T] * P, tr["content"],
                                        device)).cpu().numpy()
    checked = np.random.default_rng([seed, 2]).integers(0, P // B, B)
    return np.stack([pool[j * B + s] for s, j in enumerate(checked)])


def control_numbers(spec, cell, seed, device, lower: str) -> dict:
    """{"logp_gap", "flow_epe_px"} of the `lower` control (``cnn``,
    ``flow``, ``bias`` or ``mask``) against the float32 reference."""
    cfg = spec.config(spec.cell(cell)["config"])
    bound = cfg["preprocess"]["flow_bound"]
    dtype = getattr(torch, cfg["model"]["dtype"])
    wins = torch.from_numpy(checked_windows(spec, cell, seed, device)
                            ).to(device)
    w = weights_swin.make_weights(seed, device, cfg["model"])

    def volumes(flow):
        return [volume(flow[s:s + 1], bound).to(dtype).float().cpu()
                for s in range(flow.shape[0])]

    with torch.no_grad():
        want = ref.classify(wins, cfg, w)
        flow = ref.classify.last_flow
        # How far the reference's answers spread: each stream's logits'
        # standard deviation across classes, the mean over windows.
        logit_sd = {f"logit_sd_{name}": float(x.std(dim=-1).mean())
                    for name, x in zip(("spatial", "temporal"),
                                       ref.classify.last_logits)}
        if lower == "cnn":
            got = ref.classify(wins, cfg, w, precision="fp8", flow=flow)
        elif lower == "flow":
            got = ref.classify(wins, cfg, w, flow_dtype=torch.bfloat16)
        else:
            got = ref.classify(wins, cfg, w, flow=flow, leave_out=[lower])
        pairs = list(zip(volumes(ref.classify.last_flow), volumes(flow)))
    return {"logp_gap": runner.logp_gap(list(zip(got.cpu().numpy(),
                                                 want.cpu().numpy()))),
            "flow_epe_px": runner.flow_epe(pairs, bound),
            **logit_sd}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--lower", choices=("cnn", "flow", "bias", "mask"),
                    default="cnn")
    args = ap.parse_args(argv)
    harness.set_caches(ROOT)
    spec = harness.Spec()
    dev = harness.require_devices(1)
    for s in (int(x) % (1 << 64) for x in args.seeds.split(",") if x):
        print(json.dumps({"cell": args.workload, "what": "control",
                          "seed": s, "control": args.lower,
                          **control_numbers(spec, args.workload, s, dev,
                                            args.lower)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
