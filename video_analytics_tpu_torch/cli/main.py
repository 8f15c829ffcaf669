"""Command line of the PyTorch/CUDA port: ``tpuva-torch serve``.

Port of the ``serve`` subcommand of ``video_analytics_tpu/cli/main.py``,
with the same flags (less those of parts not ported yet: checkpoints,
BatchNorm folding, backbones other than ResNet-18) and the same
stdin/stdout line protocol.  The model is initialised from ``--seed``.

Usage::

    tpuva-torch serve --warmup            # on the first CUDA device
    tpuva-torch serve --device cpu ...    # plain PyTorch, no kernels
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _tvl1_config(args):
    """TVL1Config from the --tv-* flags the user set (the dataclass
    defaults stay the single source of the cv2 parameter values)."""
    from video_analytics_tpu_torch.config import TVL1Config
    tv_map = {"tv_tau": "tau", "tv_lambda": "lambda_",
              "tv_theta": "theta", "tv_nscales": "nscales",
              "tv_warps": "warps", "tv_epsilon": "epsilon",
              "tv_inner": "inner_iterations",
              "tv_outer": "outer_iterations",
              "tv_scale_step": "scale_step",
              "tv_median": "median_filtering"}
    return TVL1Config(**{field: getattr(args, arg)
                         for arg, field in tv_map.items()
                         if getattr(args, arg, None) is not None})


def _pipeline_config(args):
    from video_analytics_tpu_torch.config import (
        PipelineConfig, PreprocessConfig)
    pre = PreprocessConfig(resize_short=args.resize_short, crop=args.crop,
                           flow_stack=args.flow_stack)
    return PipelineConfig(preprocess=pre, num_classes=args.num_classes,
                          tvl1=_tvl1_config(args), flow_algo=args.algo,
                          window=args.window)


def _add_flow_args(p) -> None:
    """The cv2 DualTVL1OpticalFlow parameter surface."""
    tv = p.add_argument_group("tvl1 (cv2 DualTVL1OpticalFlow defaults)")
    tv.add_argument("--tv-tau", type=float, default=None)
    tv.add_argument("--tv-lambda", dest="tv_lambda", type=float,
                    default=None)
    tv.add_argument("--tv-theta", type=float, default=None)
    tv.add_argument("--tv-nscales", type=int, default=None)
    tv.add_argument("--tv-warps", type=int, default=None)
    tv.add_argument("--tv-epsilon", type=float, default=None)
    tv.add_argument("--tv-inner", type=int, default=None)
    tv.add_argument("--tv-outer", type=int, default=None)
    tv.add_argument("--tv-scale-step", type=float, default=None)
    tv.add_argument("--tv-median", type=int, default=None,
                    help="median kernel between warps (0/1/3/5)")


def _add_model_args(p) -> None:
    p.add_argument("--num-classes", type=int, default=101)
    p.add_argument("--arch", choices=["resnet18"], default="resnet18",
                   help="backbone for both streams")
    p.add_argument("--flow-stack", type=int, default=10,
                   help="L consecutive flow fields per temporal input")
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--resize-short", type=int, default=256)
    p.add_argument("--width", type=int, default=64,
                   help="ResNet base width (64 = standard ResNet-18)")
    p.add_argument("--window", type=int, default=16,
                   help="frames per sliding window")


def _load_class_names(class_index: Optional[str]) -> Optional[List[str]]:
    """classInd.txt → id-ordered name list (None without a file)."""
    if not class_index:
        return None
    from video_analytics_tpu.io.dataset import read_class_index
    ci = read_class_index(class_index)
    classes: List[str] = [None] * len(ci)
    for name, idx in ci.items():
        classes[idx] = name
    return classes


def cmd_serve(args) -> int:
    """Long-running classify server over a stdin/stdout line protocol
    (runtime/serve.py).  --warmup builds the kernels and runs the path
    once before the first request."""
    import torch
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.serve import ClipServer
    from video_analytics_tpu_torch.utils.device import require_cuda

    if args.algo != "tvl1":
        print(json.dumps({"error": f"--algo {args.algo} is not ported yet "
                          "(tvl1 only; see ROADMAP.md)"}), file=sys.stderr)
        return 2
    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = TwoStreamModel.create(num_classes=args.num_classes,
                                  flow_stack=args.flow_stack,
                                  width=args.width, arch=args.arch)
    model.init(torch.Generator().manual_seed(args.seed))
    server = ClipServer(model, cfg, device,
                        classes=_load_class_names(args.class_index),
                        num_windows=args.windows, topk=args.topk,
                        normalize=not args.raw, max_frames=args.max_frames)
    if args.warmup:
        if args.raw:
            print(json.dumps({"error": "--warmup needs shape "
                              "normalisation (drop --raw)"}),
                  file=sys.stderr)
            return 2
        secs = server.warmup()
        print(json.dumps({"ready": True, "warmup_s": round(secs, 1)}),
              flush=True)
    server.serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuva-torch",
        description="video analytics on PyTorch/CUDA (two-stream + TV-L1)")
    sub = p.add_subparsers(dest="command", required=True)
    sv = sub.add_parser(
        "serve",
        help="long-running classify server (JSON lines on stdin/stdout)")
    sv.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (tvl1 is the one ported so far)")
    sv.add_argument("--class-index", default=None,
                    help="UCF101 classInd.txt for names")
    _add_model_args(sv)
    sv.add_argument("--topk", type=int, default=5)
    sv.add_argument("--windows", type=int, default=1,
                    help="snippets per clip")
    sv.add_argument("--max-frames", type=int, default=300)
    sv.add_argument("--warmup", action="store_true",
                    help="build kernels and run once before accepting "
                         "requests; prints a {ready: true} line when done")
    sv.add_argument("--raw", action="store_true",
                    help="skip host shape normalisation")
    sv.add_argument("--seed", type=int, default=0,
                    help="seed of the random model weights")
    sv.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    _add_flow_args(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130


if __name__ == "__main__":
    sys.exit(main())
