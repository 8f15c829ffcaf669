#!/usr/bin/env python3
"""Device time of the port's K-C ``median5`` and K-F ``sep_corr`` at the
shapes their command paths give them, from the package of one checkout.

    python3 tools/torch_kernel_ab.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``video_analytics_tpu_torch`` is timed
(this one by default), so two versions can be compared back to back on
one card: run it on both roots in turns (A, B, B, A).  Each kernel runs at
its shapes on seeded inputs; its device duration per launch comes from
torch.profiler (the kernel's summed device time over 10 launches).  It
prints one JSON line with the card's name and power limit as nvidia-smi
gives them.  Needs an NVIDIA GPU.

Shapes: K-C at k = 5 on 15 pairs of 224² (a serve request's finest TV-L1
level) and on 2 pairs at the five TV-L1 levels of 1080×1920 (the
native-resolution ``compute-flow`` call); K-F with 201 Gaussian taps on
2 pairs at the 1/8 level of 1080p (135×240) and at 1080×1920, along
either axis, one plane at a time and with the solve (the path takes y,
then x with the solve).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TVL1_1080P = ((1080, 1920), (864, 1536), (691, 1229), (553, 983),
              (442, 786))


def device_ms(torch, fn, kernel: str, reps: int = 10) -> float:
    """Mean device duration of the launches of the kernel whose name holds
    `kernel` over `reps` calls of fn(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in ev.name]
        if spans:
            return sum(spans) / len(spans) / 1e3
    raise RuntimeError(f"no device time recorded for {kernel}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs an NVIDIA GPU")
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    out = {"tag": args.tag, "root": os.path.abspath(args.root),
           "package": os.path.dirname(ts.__file__)}

    median = {}
    for pairs, (h, w) in [(15, (224, 224))] + [(2, s) for s in TVL1_1080P]:
        uv = 2.0 * torch.randn((pairs, 2, h, w), device=dev, generator=g)
        on = torch.ones(pairs, dtype=torch.int32, device=dev)
        dst = torch.empty_like(uv)
        median[f"{pairs}x{h}x{w}"] = device_ms(
            torch, lambda: ts.median5(uv, 5, on, out=dst), "median_kernel")
        del uv, dst
    out["median5_device_ms"] = median

    taps = farneback_window_taps(201, True)
    sep = {}
    for h, w in ((135, 240), (1080, 1920)):
        M = torch.randn((2, 5, h, w), device=dev, generator=g)
        M[:, :3] = M[:, :3].abs()
        sep[f"2x{h}x{w}"] = {
            f"{'yx'[axis]}{'_solve' if solve else ''}": device_ms(
                torch, lambda: fk.sep_corr(M, taps, axis, solve),
                "sep_corr_kernel")
            for axis in (0, 1) for solve in (False, True)}
        del M
    out["sep_corr_201_device_ms"] = sep
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
