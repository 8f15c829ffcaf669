#!/usr/bin/env python3
"""Device time of R(2+1)D-34's temporal (t×1×1) convolutions issued as
3-D convolutions and as ``ops/layers.Conv3d``'s 2-D route, at the shapes
a batch of clips gives them.

    python3 tools/torch_conv_ab.py [--batch 16] [--frames 32] [--size 112]
                                   [--reps 20] [--stream]

Each distinct temporal convolution of a stream (the stem's, and each
stage's first and other blocks) runs in bfloat16 on a channels-last-3d
input of seeded values, in turns: the 3-D call (``nn.Conv3d``'s
``_conv_forward``), the 2-D route, the 2-D route, the 3-D call; the 2-D
route is timed at every plane, also where ``Conv3d.MIN_PLANE`` keeps the
3-D call (``routed`` says which the layer takes).  For each
it prints the mean ms a call between CUDA events, the TFLOP/s of the
multiply-adds, the largest difference of the two outputs, and per kernel
name the device ms of one call (torch.profiler).  ``--stream`` adds one
whole bfloat16 stream's forward as the layer routes it and with every
convolution as a 3-D call.  A line a shape as it goes, then all of it
as one JSON line, with the card's name and power limit as nvidia-smi
gives them.
Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from torch_kernel_ab import event_ms, launches  # noqa: E402
from video_analytics_tpu_torch.models.video_resnet import (  # noqa: E402
    STEM_MIDPLANES, midplanes, r2plus1d_34)
from video_analytics_tpu_torch.ops.layers import Conv3d  # noqa: E402


def temporal_shapes(frames: int, size: int, width: int = 64):
    """(name, C_in, C_out, t-stride, T, H·W side) of every distinct
    temporal convolution of R(2+1)D-34 on clips of frames × size²."""
    t, s = frames, size // 2
    yield "stem", STEM_MIDPLANES, width, 1, t, s
    cin = width
    for stage in range(4):
        cout = width * 2 ** stage
        if stage:
            s = (s + 1) // 2
            yield f"stage{stage + 1}.first", midplanes(cin, cout), cout, 2, \
                t, s
            t = (t + 1) // 2
        yield f"stage{stage + 1}", midplanes(cout, cout), cout, 1, t, s
        cin = cout


def three_d(layer: Conv3d):
    return lambda x, w: nn.Conv3d._conv_forward(layer, x, w, None)


def two_d(layer: Conv3d):
    """The layer's 2-D route, whatever the plane."""
    layer.MIN_PLANE = 0
    return lambda x, w: layer._conv_forward(x, w, None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(dev).manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0),
           "gpu": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "torch": torch.__version__, "shapes": []}
    for name, cin, cout, ts, t, s in temporal_shapes(args.frames, args.size):
        layer = Conv3d(cin, cout, (3, 1, 1), (ts, 1, 1), (1, 0, 0),
                       bias=False, dtype=bf16).to(dev)
        x = torch.randn((args.batch, cin, t, s, s), device=dev, dtype=bf16,
                        generator=g).contiguous(
                            memory_format=torch.channels_last_3d)
        w = layer.weight.to(bf16)
        routes = {"3d": three_d(layer), "2d": two_d(layer)}
        ms = {k: [] for k in routes}
        for k in ("3d", "2d", "2d", "3d"):
            ms[k].append(event_ms(torch, lambda: routes[k](x, w), args.reps))
        y3, y2 = routes["3d"](x, w), routes["2d"](x, w)
        macs = y2.numel() * cin * 3
        row = {"name": name, "c_in": cin, "c_out": cout, "t_stride": ts,
               "in": [args.batch, cin, t, s, s],
               "routed": s * s >= Conv3d.MIN_PLANE,
               "max_abs_diff": (y3.float() - y2.float()).abs().max().item(),
               "out_channels_last_3d": y2.is_contiguous(
                   memory_format=torch.channels_last_3d)}
        for k in routes:
            best = min(ms[k])
            row[k] = {"ms": ms[k], "tflops": 2 * macs / best / 1e9,
                      "kernels": launches(torch, lambda: routes[k](x, w))}
        row["gain"] = min(ms["3d"]) / min(ms["2d"])
        out["shapes"].append(row)
        print(name, json.dumps({k: row[k] for k in
                                ("in", "t_stride", "routed", "max_abs_diff",
                                 "gain")}),
              min(ms["3d"]), min(ms["2d"]), flush=True)
    if args.stream:
        model = r2plus1d_34(101, dtype=bf16).to(dev).eval()
        clips = torch.randn((args.batch, args.frames, args.size, args.size,
                             3), device=dev, generator=g)
        routed = Conv3d._conv_forward

        def forward(route: bool):
            Conv3d._conv_forward = routed if route else \
                nn.Conv3d._conv_forward
            try:
                with torch.no_grad():
                    return model(clips)
            finally:
                Conv3d._conv_forward = routed

        res = {k: [] for k in ("3d", "2d")}
        for k in ("3d", "2d", "2d", "3d"):
            res[k].append(event_ms(torch, lambda: forward(k == "2d"), 5))
        gap = (forward(True) - forward(False)).abs().max().item()
        out["stream"] = {"ms": res, "max_abs_logit_diff": gap,
                         "max_abs_logit": forward(False).abs().max().item()}
        print("stream", json.dumps(out["stream"]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
