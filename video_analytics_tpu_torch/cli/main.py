"""Command line of the PyTorch/CUDA port: ``tpuva-torch``.

Port of the ``extract-frames``, ``compute-flow``, ``extract-features``,
``classify-clip``, ``serve``, ``eval-ucf101`` and ``convert-weights``
subcommands of ``video_analytics_tpu/cli/main.py``, with the same flags
and the same JSON lines (less SpyNet and its ``--spynet-checkpoint``;
less ``compute-flow``'s ``--exact`` and ``--no-bucket``, which choose
between paths the port does not have: its warp is always the exact
gather, its flow always at the native resolution; and less
``eval-ucf101``'s multi-host flags) and, for ``serve``, the same
stdin/stdout line protocol.  The model is initialised from a seed
(``serve --seed``, 0 elsewhere) unless ``--checkpoint`` names a msgpack
file, which either package may have written.  Every command that computes
runs on the first CUDA device unless ``--device`` says otherwise.

Usage::

    tpuva-torch serve --warmup                    # first CUDA device
    tpuva-torch serve --algo farneback --checkpoint two_stream.msgpack
    tpuva-torch compute-flow clip.mp4 flow/ --algo tvl1
    tpuva-torch extract-features flow/ feats.npz --stream flow
    tpuva-torch classify-clip clip.mp4 --checkpoint two_stream.msgpack
    tpuva-torch convert-weights resnet18.pth two_stream.msgpack
    tpuva-torch eval-ucf101 --videos UCF101/videos \\
        --annotations UCF101/annotations --checkpoint two_stream.msgpack \\
        --batched
    tpuva-torch serve --device cpu ...            # plain PyTorch, no kernels
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _chunked(n: int, size: int):
    for s in range(0, n, size):
        yield s, min(s + size, n)


def _load_frames(src: str, max_frames: Optional[int]):
    from video_analytics_tpu_torch.io.video import (
        VideoReader, read_frames_dir)
    if os.path.isdir(src):
        return read_frames_dir(src, max_frames=max_frames)
    with VideoReader(src) as r:
        return r.read_all(max_frames=max_frames)


def cmd_extract_frames(args) -> int:
    """Decode a clip to frame JPEGs (host only)."""
    from video_analytics_tpu_torch.io.video import VideoReader, write_frames
    with VideoReader(args.video) as r:
        frames = r.read_all(max_frames=args.max_frames)
    paths = write_frames(frames, args.out_dir, quality=args.quality)
    print(json.dumps({"frames": len(paths), "out_dir": args.out_dir,
                      "height": int(frames.shape[1]),
                      "width": int(frames.shape[2])}))
    return 0


def _write_flow(out_dir: str, idx: int, flow, fmt: str, bound: float
                ) -> None:
    """One (H, W, 2) flow field in the chosen storage format."""
    from video_analytics_tpu_torch.io.flowio import (
        flow_to_color, quantize_flow, write_flo)
    if fmt == "flo":
        write_flo(os.path.join(out_dir, f"flow_{idx:06d}.flo"), flow)
        return
    import cv2
    if fmt == "viz":
        rgb = flow_to_color(flow, max_mag=bound)
        cv2.imwrite(os.path.join(out_dir, f"flow_viz_{idx:06d}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    else:
        q = quantize_flow(flow, bound=bound)
        cv2.imwrite(os.path.join(out_dir, f"flow_x_{idx:06d}.jpg"), q[..., 0])
        cv2.imwrite(os.path.join(out_dir, f"flow_y_{idx:06d}.jpg"), q[..., 1])


def cmd_compute_flow(args) -> int:
    """Dense flow of every consecutive frame pair of a clip or frames
    directory, at the native resolution, `--batch` pairs per call."""
    import torch
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray
    from video_analytics_tpu_torch.runtime.pipeline import compute_flow
    from video_analytics_tpu_torch.utils.device import require_cuda

    if _spynet_refused(args):
        return 2
    device = require_cuda(args.device)
    frames = _load_frames(args.src, args.max_frames)
    if len(frames) < 2:
        print("error: need at least 2 frames for flow", file=sys.stderr)
        return 2
    fb, tv = _flow_configs(args)
    cfg = PipelineConfig(flow_algo=args.algo, farneback=fb, tvl1=tv)
    os.makedirs(args.out_dir, exist_ok=True)
    written = 0
    with torch.no_grad():
        gray = rgb_to_gray(torch.from_numpy(frames).to(device))
        for s, e in _chunked(len(frames) - 1, args.batch):
            flow = compute_flow(gray[s:e], gray[s + 1:e + 1], cfg)
            for i, f in enumerate(flow.cpu().numpy()):
                _write_flow(args.out_dir, s + i + 1, f, args.format,
                            args.bound)
                written += 1
    print(json.dumps({"flows": written, "algo": args.algo,
                      "format": args.format, "out_dir": args.out_dir}))
    return 0


def _flow_configs(args):
    """(FarnebackConfig, TVL1Config) from the --fb-* and --tv-* flags the
    user set (the dataclass defaults stay the single source of the cv2
    parameter values)."""
    from video_analytics_tpu_torch.config import FarnebackConfig, TVL1Config
    fb_map = {"fb_pyr_scale": "pyr_scale", "fb_levels": "levels",
              "fb_winsize": "winsize", "fb_iterations": "iterations",
              "fb_poly_n": "poly_n", "fb_poly_sigma": "poly_sigma"}
    tv_map = {"tv_tau": "tau", "tv_lambda": "lambda_",
              "tv_theta": "theta", "tv_nscales": "nscales",
              "tv_warps": "warps", "tv_epsilon": "epsilon",
              "tv_inner": "inner_iterations",
              "tv_outer": "outer_iterations",
              "tv_scale_step": "scale_step",
              "tv_median": "median_filtering"}

    def pick(m):
        return {field: getattr(args, arg) for arg, field in m.items()
                if getattr(args, arg, None) is not None}

    fb_kw = pick(fb_map)
    if getattr(args, "fb_gaussian", False):
        fb_kw["gaussian_window"] = True
    return FarnebackConfig(**fb_kw), TVL1Config(**pick(tv_map))


def _pipeline_config(args):
    """Build a PipelineConfig from the shared model/preprocess args
    (_add_model_args); fields not exposed keep their defaults."""
    from video_analytics_tpu_torch.config import (
        PipelineConfig, PreprocessConfig)
    pre = PreprocessConfig(resize_short=args.resize_short, crop=args.crop,
                           flow_stack=args.flow_stack)
    fb, tv = _flow_configs(args)
    kw = dict(preprocess=pre, num_classes=args.num_classes,
              farneback=fb, tvl1=tv, flow_algo=args.algo)
    if getattr(args, "window", None) is not None:
        kw["window"] = args.window
    return PipelineConfig(**kw)


def _add_flow_args(p) -> None:
    """The cv2 flow-parameter surface (calcOpticalFlowFarneback /
    DualTVL1OpticalFlow_create), per algorithm, with cv2's defaults."""
    fb = p.add_argument_group("farneback (cv2.calcOpticalFlowFarneback)")
    fb.add_argument("--fb-pyr-scale", type=float, default=None)
    fb.add_argument("--fb-levels", type=int, default=None)
    fb.add_argument("--fb-winsize", type=int, default=None)
    fb.add_argument("--fb-iterations", type=int, default=None)
    fb.add_argument("--fb-poly-n", type=int, default=None)
    fb.add_argument("--fb-poly-sigma", type=float, default=None)
    fb.add_argument("--fb-gaussian", action="store_true",
                    help="cv2.OPTFLOW_FARNEBACK_GAUSSIAN window")
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


def _add_model_args(p, window: bool = True) -> None:
    """Args that determine the model/pipeline geometry: they must match
    whatever wrote the checkpoint."""
    p.add_argument("--num-classes", type=int, default=101)
    p.add_argument("--arch", choices=["resnet18", "resnet34", "resnet50"],
                   default="resnet18", help="backbone for both streams")
    p.add_argument("--flow-stack", type=int, default=10,
                   help="L consecutive flow fields per temporal input")
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--resize-short", type=int, default=256)
    p.add_argument("--width", type=int, default=64,
                   help="ResNet base width (64 = standard ResNet-18)")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold BatchNorms into conv weights at load "
                        "time (inference only; exact f32 composition)")
    p.add_argument("--checkpoint", default=None,
                   help="msgpack checkpoint of both streams (written by "
                        "this package or the JAX one); without it the "
                        "weights are random")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a GPU")
    if window:
        p.add_argument("--window", type=int, default=16,
                       help="frames per sliding window")


def _spynet_refused(args) -> bool:
    if args.algo != "spynet":
        return False
    print(json.dumps({"error": "--algo spynet is not ported yet "
                      "(tvl1 and farneback are; see ROADMAP.md)"}),
          file=sys.stderr)
    return True


def _load_two_stream(args, device):
    """The two-stream model on `device`, in eval mode: made from --arch,
    --width, --num-classes and --flow-stack, initialised from a seed
    (serve's --seed, else 0), then loaded from --checkpoint and folded
    (--fold-bn) where asked."""
    import torch
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables
    model = TwoStreamModel.create(num_classes=args.num_classes,
                                  flow_stack=args.flow_stack,
                                  width=args.width, arch=args.arch)
    seed = getattr(args, "seed", 0)
    model.init(torch.Generator().manual_seed(seed))
    if args.checkpoint:
        model.load_flax_variables(
            load_variables(args.checkpoint, model.flax_variables()))
    if args.fold_bn:
        model = model.folded()
    return model.to(device).eval()


def _is_flow_dir(src: str) -> bool:
    if not os.path.isdir(src):
        return False
    names = os.listdir(src)
    return any(n.startswith("flow_x_") or n.endswith(".flo")
               for n in names)


def cmd_extract_features(args) -> int:
    """Penultimate CNN features of a clip, a frames directory or a stored
    flow directory (``compute-flow``'s output), to an .npz file."""
    import numpy as np
    import torch
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.ops.preprocess import (
        center_crop, resize_short_side, stacked_flow_input)
    from video_analytics_tpu_torch.runtime.pipeline import (
        flow_features, rgb_features)
    from video_analytics_tpu_torch.utils.device import require_cuda

    if _spynet_refused(args):
        return 2
    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)

    out = {}
    if _is_flow_dir(args.src):
        # Stored-flow input (the stage-artifact handoff: compute-flow
        # output dir → flow-stream features).
        if args.stream in ("rgb", "both"):
            print("error: rgb features need frames, got a flow dir",
                  file=sys.stderr)
            return 2
        from video_analytics_tpu_torch.io.flowio import read_flow_dir
        flows = read_flow_dir(args.src, bound=args.bound,
                              max_flows=args.max_frames)
        need = cfg.preprocess.flow_stack
        if len(flows) < need:
            print(f"error: need >= {need} stored flows", file=sys.stderr)
            return 2
        # Match the frames-path geometry (flow_features): resize short
        # side + center crop, with the (u, v) values scaled by the
        # per-axis resize factors so a checkpoint trained at `crop` sees
        # the same input distribution through the stage-handoff chain.
        with torch.no_grad():
            f = torch.from_numpy(flows).to(device)
            h, w = f.shape[1], f.shape[2]
            f = resize_short_side(f, cfg.preprocess.resize_short)
            f = f * torch.tensor([f.shape[2] / w, f.shape[1] / h],
                                 dtype=torch.float32, device=device)
            f = center_crop(f, cfg.preprocess.crop)
            stacks = stacked_flow_input(f, cfg.preprocess.flow_stack,
                                        cfg.preprocess.flow_bound)
            out["flow"] = model.temporal(
                stacks, return_features=True).cpu().numpy()
        np.savez(args.out, **out)
        print(json.dumps({k: list(v.shape) for k, v in out.items()}
                         | {"out": args.out, "source": "flow_dir"}))
        return 0

    frames = _load_frames(args.src, args.max_frames)
    # Transport crop: only the source window the fused resize+crop
    # samples crosses to the device.
    frames, cfg = apply_transport_crop(frames, cfg)
    x = torch.from_numpy(frames).to(device)
    if args.stream in ("rgb", "both"):
        out["rgb"] = rgb_features(x, model.spatial,
                                  cfg.preprocess).cpu().numpy()
    if args.stream in ("flow", "both"):
        need = cfg.preprocess.flow_stack + 1
        if len(frames) < need:
            print(f"error: flow features need >= {need} frames",
                  file=sys.stderr)
            return 2
        out["flow"] = flow_features(x, model.temporal, cfg).cpu().numpy()
    np.savez(args.out, **out)
    print(json.dumps({k: list(v.shape) for k, v in out.items()}
                     | {"out": args.out}))
    return 0


def cmd_classify_clip(args) -> int:
    """Two-stream classification of one clip: top-k classes as JSON."""
    import numpy as np
    from video_analytics_tpu_torch.runtime.evaluate import classify_clip_file
    from video_analytics_tpu_torch.utils.device import require_cuda

    if _spynet_refused(args):
        return 2
    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
    classes = _load_class_names(args.class_index)
    probs = classify_clip_file(args.video, model, cfg, device,
                               num_windows=args.windows)
    topk = np.argsort(probs)[::-1][:args.topk]
    result = {"video": args.video,
              "top1": int(topk[0]),
              "topk": [{"class_id": int(i),
                        "class_name": classes[i] if classes else None,
                        "prob": float(probs[i])} for i in topk]}
    print(json.dumps(result))
    return 0


def _load_class_names(class_index: Optional[str]) -> Optional[List[str]]:
    """classInd.txt → id-ordered name list (None without a file)."""
    if not class_index:
        return None
    from video_analytics_tpu_torch.io.dataset import read_class_index
    ci = read_class_index(class_index)
    classes: List[str] = [None] * len(ci)
    for name, idx in ci.items():
        classes[idx] = name
    return classes


def cmd_eval_ucf101(args) -> int:
    """Top-1 clip accuracy on a UCF101 split's test list: clip by clip
    (resumable with --manifest, --predictions written as JSON lines) or,
    with --batched, threaded decode and batches of --batch-clips clips with
    the correct count kept on the device."""
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.runtime.evaluate import (
        evaluate, evaluate_batched)
    from video_analytics_tpu_torch.utils.device import require_cuda

    if _spynet_refused(args):
        return 2
    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
    ds = UCF101(videos_root=args.videos, annotations_root=args.annotations,
                split=args.split)
    if args.batched:
        records = ds.test_records()
        if args.limit is not None:
            records = records[:args.limit]
        result = evaluate_batched(records, model, cfg, device,
                                  batch_clips=args.batch_clips,
                                  num_windows=args.windows, host_resize=True)
    else:
        result = evaluate(ds.test_records(), model, cfg, device,
                          manifest_path=args.manifest,
                          predictions_path=args.predictions,
                          limit=args.limit, num_windows=args.windows)
    print(json.dumps(result.as_dict()))
    return 0


_ARCH_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                "resnet50": (3, 4, 6, 3)}


def _merge_into_template(template, src, path=""):
    """Deep-merge converted arrays into freshly initialised variables:
    every leaf present in `src` replaces the template's (shape-checked);
    leaves absent from `src` (e.g. an fc of another class count) keep
    their init values.  Returns (merged, replaced leaf count)."""
    import numpy as np
    if isinstance(template, dict):
        out, n = {}, 0
        for k, tv in template.items():
            if isinstance(src, dict) and k in src:
                out[k], dn = _merge_into_template(tv, src[k], f"{path}/{k}")
                n += dn
            else:
                out[k] = tv
        return out, n
    s = np.asarray(src)
    t = np.asarray(template)
    if s.shape != t.shape:
        raise ValueError(
            f"converted weight {path} has shape {s.shape}, model "
            f"expects {t.shape}: wrong --arch/--width?")
    return s.astype(t.dtype), 1


def cmd_convert_weights(args) -> int:
    """torch(vision) ResNet state_dict file → two-stream msgpack
    checkpoint (host work only): the RGB stream takes the weights
    directly, the flow stream the same with its stem inflated across the
    flow channels (``models/convert.inflate_stem_for_flow``).  The path
    from downloaded ImageNet weights to an eval run:

        tpuva-torch convert-weights resnet18-imagenet.pth ckpt.msgpack
        tpuva-torch eval-ucf101 --checkpoint ckpt.msgpack ...

    The classifier is converted only when its class count matches
    --num-classes; otherwise both streams keep a fresh classifier drawn
    from --seed (with the port's generator, so not the JAX command's
    values)."""
    import pickle

    import torch
    from video_analytics_tpu_torch.models.convert import (
        inflate_stem_for_flow, torch_resnet_to_flax)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables

    try:
        sd = torch.load(args.state_dict, map_location="cpu",
                        weights_only=True)
    except pickle.UnpicklingError:      # a whole pickled model, not tensors
        sd = torch.load(args.state_dict, map_location="cpu",
                        weights_only=False)
    if hasattr(sd, "state_dict"):        # a whole saved model
        sd = sd.state_dict()
    for key in ("state_dict", "model"):  # common checkpoint wrappers
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]

    fc_classes = (int(sd["fc.weight"].shape[0]) if "fc.weight" in sd
                  else None)
    include_fc = fc_classes == args.num_classes
    converted = torch_resnet_to_flax(
        sd, stage_sizes=_ARCH_STAGES[args.arch], include_fc=include_fc)

    model = TwoStreamModel.create(num_classes=args.num_classes,
                                  flow_stack=args.flow_stack,
                                  width=args.width, arch=args.arch)
    variables = model.init(
        torch.Generator().manual_seed(args.seed)).flax_variables()
    spatial, n_s = _merge_into_template(variables["spatial"], converted)
    inflated = inflate_stem_for_flow(converted, args.flow_stack)
    temporal, n_t = _merge_into_template(variables["temporal"], inflated)
    save_variables(args.out, {"spatial": spatial, "temporal": temporal})
    print(json.dumps({
        "out": args.out, "arch": args.arch,
        "spatial_leaves_converted": n_s,
        "temporal_leaves_converted": n_t,
        "fc_converted": include_fc,
        "fc_classes_in_state_dict": fc_classes,
        "flow_stem_channels": 2 * args.flow_stack}))
    return 0


def cmd_serve(args) -> int:
    """Long-running classify server over a stdin/stdout line protocol
    (runtime/serve.py).  --warmup builds the kernels and runs the path
    once before the first request."""
    from video_analytics_tpu_torch.runtime.serve import ClipServer
    from video_analytics_tpu_torch.utils.device import require_cuda

    if _spynet_refused(args):
        return 2
    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
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
        description="video analytics on PyTorch/CUDA (two-stream + "
                    "TV-L1 or Farneback optical flow)")
    sub = p.add_subparsers(dest="command", required=True)

    ef = sub.add_parser("extract-frames", help="decode video to frame JPEGs")
    ef.add_argument("video")
    ef.add_argument("out_dir")
    ef.add_argument("--max-frames", type=int, default=None)
    ef.add_argument("--quality", type=int, default=95)
    ef.set_defaults(fn=cmd_extract_frames)

    cf = sub.add_parser("compute-flow",
                        help="dense optical flow for a clip/frames dir")
    cf.add_argument("src")
    cf.add_argument("out_dir")
    cf.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (spynet is not ported yet)")
    cf.add_argument("--format", choices=["flo", "jpg", "viz"],
                    default="flo",
                    help="flo = raw .flo files; jpg = quantized uint8 "
                         "x/y pairs (two-stream storage convention); "
                         "viz = HSV color-wheel PNGs for inspection")
    cf.add_argument("--bound", type=float, default=20.0,
                    help="jpg quantization range / viz magnitude "
                         "saturation, in px")
    cf.add_argument("--batch", type=int, default=8,
                    help="frame pairs per flow call")
    cf.add_argument("--max-frames", type=int, default=None)
    cf.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    _add_flow_args(cf)
    cf.set_defaults(fn=cmd_compute_flow)

    xf = sub.add_parser("extract-features",
                        help="CNN features for a clip/frames dir/flow dir")
    xf.add_argument("src")
    xf.add_argument("out", help="output .npz path")
    xf.add_argument("--stream", choices=["rgb", "flow", "both"],
                    default="rgb")
    xf.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (spynet is not ported yet)")
    _add_model_args(xf, window=False)
    xf.add_argument("--max-frames", type=int, default=None)
    xf.add_argument("--bound", type=float, default=20.0,
                    help="dequantization bound for stored uint8 flow")
    _add_flow_args(xf)
    xf.set_defaults(fn=cmd_extract_features)

    cc = sub.add_parser("classify-clip",
                        help="two-stream classification of one clip")
    cc.add_argument("video")
    cc.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (spynet is not ported yet)")
    cc.add_argument("--class-index", default=None,
                    help="UCF101 classInd.txt for names")
    _add_model_args(cc)
    cc.add_argument("--topk", type=int, default=5)
    cc.add_argument("--windows", type=int, default=1)
    _add_flow_args(cc)
    cc.set_defaults(fn=cmd_classify_clip)

    sv = sub.add_parser(
        "serve",
        help="long-running classify server (JSON lines on stdin/stdout)")
    sv.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (spynet is not ported yet)")
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
    _add_flow_args(sv)
    sv.set_defaults(fn=cmd_serve)

    ev = sub.add_parser("eval-ucf101", help="UCF101 split eval")
    ev.add_argument("--videos", required=True)
    ev.add_argument("--annotations", required=True)
    ev.add_argument("--split", type=int, default=1)
    ev.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm (spynet is not ported yet)")
    _add_model_args(ev)
    ev.add_argument("--manifest", default=None,
                    help="resume file: clips listed there are skipped, "
                         "each clip done is added (without --batched)")
    ev.add_argument("--predictions", default=None,
                    help="append {path, label, pred} JSON lines here "
                         "(without --batched)")
    ev.add_argument("--limit", type=int, default=None)
    ev.add_argument("--windows", type=int, default=1,
                    help="snippets per clip, probs averaged")
    ev.add_argument("--batched", action="store_true",
                    help="throughput path: threaded decode, batches of "
                         "clips, the correct count kept on the device")
    ev.add_argument("--batch-clips", type=int, default=8)
    _add_flow_args(ev)
    ev.set_defaults(fn=cmd_eval_ucf101)

    cw = sub.add_parser(
        "convert-weights",
        help="torch ResNet state_dict → two-stream msgpack checkpoint "
             "(RGB weights + inflated flow stem)")
    cw.add_argument("state_dict", help="torch .pth/.pt file")
    cw.add_argument("out", help="output msgpack checkpoint path")
    cw.add_argument("--arch", choices=sorted(_ARCH_STAGES),
                    default="resnet18")
    cw.add_argument("--num-classes", type=int, default=101)
    cw.add_argument("--flow-stack", type=int, default=10)
    cw.add_argument("--width", type=int, default=64)
    cw.add_argument("--seed", type=int, default=0,
                    help="init seed for layers not in the state_dict "
                         "(e.g. the fc head on a class-count mismatch)")
    cw.set_defaults(fn=cmd_convert_weights)
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
