"""Time the port's SpyNet on one CUDA card: ms per call and per pair, the
float32 operations bound and the share of it reached, the device's top
kernels, in the model's layout (NCHW) and with the levels' convolutions in
channels-last (NHWC) layout, each with and without
``torch.backends.cudnn.benchmark``; every variant's flow against the
first's.

    python3 tools/torch_spynet_bench.py                # 15x224², 2x1080p
    python3 tools/torch_spynet_bench.py --shapes 8x240x320 --iters 10

Prints one JSON line per shape and variant, then the card's name and power
limit as nvidia-smi reports them.  Needs a GPU: without one it exits
non-zero.
"""

import argparse
import copy
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

F32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores


def channels_last(net, torch):
    """A copy of `net` whose levels run their convolutions on NHWC tensors
    (weights and activations channels-last); the same arithmetic."""
    out = copy.deepcopy(net).to(memory_format=torch.channels_last)
    for level in out.nets:
        level.forward = (lambda x, f=level.forward:
                         f(x.contiguous(memory_format=torch.channels_last)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="15x224x224,2x1080x1920",
                    help="comma list of pairs x height x width")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, conv_flops, default_spynet_checkpoint)
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables
    from video_analytics_tpu_torch.utils.device import require_cuda

    dev = require_cuda("cuda")
    base = SpyNet(levels=4)
    base.load_flax_variables(load_variables(default_spynet_checkpoint(),
                                            base.flax_variables()))
    base = base.to(dev).eval()
    variants = {"nchw": base, "nhwc": channels_last(base, torch)}

    for shape in args.shapes.split(","):
        n, h, w = (int(v) for v in shape.split("x"))
        rng = np.random.default_rng(0)
        prev = torch.from_numpy(rng.uniform(0, 255, (n, h, w)).astype(
            np.float32)).to(dev)
        nxt = torch.roll(prev, (1, -2), dims=(1, 2))
        flops = conv_flops(n, h, w)
        bound_ms = 1e3 * flops / F32_FLOP_PER_S
        ref = None
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for name, net in variants.items():
                with torch.no_grad():
                    for _ in range(3):
                        out = net(prev, nxt)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.iters):
                        out = net(prev, nxt)
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / args.iters
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        net(prev, nxt)
                        torch.cuda.synchronize()
                ref = out if ref is None else ref
                per_name = {}
                for ev in prof.events():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        d = (ev.time_range.end - ev.time_range.start) / 1e3
                        per_name[ev.name[:70]] = per_name.get(
                            ev.name[:70], 0.0) + d
                top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
                print(json.dumps({
                    "shape": [n, h, w], "layout": name,
                    "cudnn_benchmark": bench, "ms": ms, "ms_per_pair": ms / n,
                    "gflop": flops / 1e9, "bound_ms": bound_ms,
                    "share_of_bound": bound_ms / ms,
                    "device_ms": sum(per_name.values()),
                    "max_abs_vs_first": float((out - ref).abs().max()),
                    "top_device_ms": top}), flush=True)
    torch.backends.cudnn.benchmark = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
