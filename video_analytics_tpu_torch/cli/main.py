"""Command line of the PyTorch/CUDA port: ``tpuva-torch``.

Port of the ``extract-frames``, ``compute-flow``, ``extract-features``,
``classify-clip``, ``serve``, ``eval-ucf101``, ``convert-weights``,
``train`` and ``warmup`` subcommands of ``video_analytics_tpu/cli/main.py``,
with the same flags and the same JSON lines and, for ``serve``, the same
stdin/stdout line protocol.  ``compute-flow`` pads each frame pair to the
reference's 64-pixel buckets unless ``--no-bucket``.  ``eval-ucf101
--batched`` and ``train`` run as one process per device with
``--coordinator host:port --num-processes N --process-id I``
(``parallel/mesh``; NCCL between CUDA devices, gloo on the CPU).  The
model is initialised from a seed (``serve --seed`` and ``train --seed``, 0
elsewhere) unless ``--checkpoint`` (``train``: ``--init-checkpoint``)
names a msgpack file, which either package may have written.  ``--algo
spynet`` reads the learned flow's weights from ``--spynet-checkpoint`` or
the bundled file.  Every command that computes runs on the first CUDA
device unless ``--device`` says otherwise.

Usage::

    tpuva-torch serve --warmup                    # first CUDA device
    tpuva-torch serve --algo farneback --checkpoint two_stream.msgpack
    tpuva-torch compute-flow clip.mp4 flow/ --algo tvl1
    tpuva-torch classify-clip clip.mp4 --algo spynet
    tpuva-torch extract-features flow/ feats.npz --stream flow
    tpuva-torch classify-clip clip.mp4 --checkpoint two_stream.msgpack
    tpuva-torch convert-weights resnet18.pth two_stream.msgpack
    tpuva-torch eval-ucf101 --videos UCF101/videos \\
        --annotations UCF101/annotations --checkpoint two_stream.msgpack \\
        --batched
    tpuva-torch train --videos UCF101/videos \\
        --annotations UCF101/annotations --out two_stream.msgpack
    tpuva-torch train ... --coordinator 10.0.0.1:29500 \\
        --num-processes 2 --process-id 0          # and 1 on the other card
    tpuva-torch warmup --surface all --sizes 240x320
    tpuva-torch serve --device cpu ...            # plain PyTorch, no kernels
"""

from __future__ import annotations

import argparse
import contextlib
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
    directory, `--batch` pairs per call.  As in the reference, each call
    pads its pairs at the edges to the next multiple of 64 on both axes,
    computes the flow there and crops it back (``ops/bucketing``), which
    changes the flow in a border band; ``--no-bucket`` computes at the
    native resolution.  ``--exact`` sets ``PipelineConfig.exact_warp`` as
    the reference does; the port's warp is always the exact gather, so it
    changes nothing."""
    import torch
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ops.bucketing import bucketed_flow
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray
    from video_analytics_tpu_torch.runtime.pipeline import compute_flow
    from video_analytics_tpu_torch.utils.device import require_cuda

    device = require_cuda(args.device)
    flow_net = _spynet_net(args, device)
    frames = _load_frames(args.src, args.max_frames)
    if len(frames) < 2:
        print("error: need at least 2 frames for flow", file=sys.stderr)
        return 2
    fb, tv = _flow_configs(args)
    cfg = PipelineConfig(flow_algo=args.algo, farneback=fb, tvl1=tv,
                         exact_warp=args.exact)

    def flow_fn(prev, nxt):
        return compute_flow(prev, nxt, cfg, flow_net=flow_net)

    os.makedirs(args.out_dir, exist_ok=True)
    written = 0
    with torch.no_grad():
        gray = rgb_to_gray(torch.from_numpy(frames).to(device))
        for s, e in _chunked(len(frames) - 1, args.batch):
            prev, nxt = gray[s:e], gray[s + 1:e + 1]
            flow = (flow_fn(prev, nxt) if args.no_bucket
                    else bucketed_flow(flow_fn, prev, nxt))
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
    (_add_model_args); --resize-short, --crop and --window left unset, the
    normalisation and the fusion weights are --arch's
    (``models.two_stream.arch_input``); an arch whose streams take clip
    volumes builds no flow stacks, so its stack is the window's T − 1
    fields and asks no longer window; other fields keep their
    defaults."""
    from video_analytics_tpu_torch.config import (
        PipelineConfig, PreprocessConfig)
    from video_analytics_tpu_torch.models.two_stream import arch_input
    inp = arch_input(args.arch)

    def given(name: str, default):
        value = getattr(args, name, None)
        return default if value is None else value

    window = given("window", inp.window)
    pre = PreprocessConfig(resize_short=given("resize_short",
                                              inp.resize_short),
                           crop=given("crop", inp.crop), mean=inp.mean,
                           std=inp.std,
                           flow_stack=window - 1 if inp.clip
                           else args.flow_stack)
    fb, tv = _flow_configs(args)
    return PipelineConfig(preprocess=pre, num_classes=args.num_classes,
                          farneback=fb, tvl1=tv,
                          flow_algo=getattr(args, "algo", "tvl1"),
                          fusion_weights=inp.fusion_weights, window=window)


def _add_flow_args(p) -> None:
    """The cv2 flow-parameter surface (calcOpticalFlowFarneback /
    DualTVL1OpticalFlow_create), per algorithm, with cv2's defaults, and
    the learned flow's checkpoint."""
    p.add_argument("--spynet-checkpoint", default=None,
                   help="weights for --algo spynet (default: the bundled "
                        "checkpoints_data/spynet_synthetic.msgpack)")
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


def _add_model_args(p, window: bool = True, inference: bool = True,
                    clip_archs: bool = False) -> None:
    """Args that determine the model/pipeline geometry: they must match
    whatever wrote the checkpoint.  `inference` adds the inference-only
    ``--fold-bn`` and ``--checkpoint``; `clip_archs` the video archs of
    ``models.two_stream``'s registry, whose streams take clip volumes,
    and with them ``--crop``, ``--resize-short``, ``--window`` and
    ``--width`` that default to the arch's own (``arch_input``).  The
    arch names and the help come from the registry."""
    from video_analytics_tpu_torch.models import two_stream
    archs = two_stream.arch_names(images_only=not clip_archs)
    image = two_stream.ArchInput()
    geometry = {"crop": image.crop, "resize_short": image.resize_short,
                "window": image.window, "width": image.width}
    arch_help = "backbone for both streams"
    if clip_archs:
        geometry = dict.fromkeys(geometry)
        own = []
        for a in archs:
            inp = two_stream.arch_input(a)
            own.append(f"{inp.crop}, {inp.resize_short}, {inp.window}, "
                       f"{inp.width} for {a}")
        arch_help += ("; --crop, --resize-short, --window and --width "
                      "default to its own: " + "; ".join(own)
                      + " (a clip arch's window is its frames and one more "
                        "for the flow)")
    p.add_argument("--num-classes", type=int, default=101)
    p.add_argument("--arch", choices=archs, default="resnet18",
                   help=arch_help)
    p.add_argument("--flow-stack", type=int, default=10,
                   help="L consecutive flow fields per temporal input")
    p.add_argument("--crop", type=int, default=geometry["crop"])
    p.add_argument("--resize-short", type=int,
                   default=geometry["resize_short"])
    p.add_argument("--width", type=int, default=geometry["width"],
                   help="base width (64 = standard ResNet-18)")
    if inference:
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
        p.add_argument("--window", type=int, default=geometry["window"],
                       help="frames per sliding window")


def _add_distributed_args(p) -> None:
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0; with it this command is "
                        "one process of N, each on its own device")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


@contextlib.contextmanager
def _maybe_init_distributed(args):
    """The command's device, in a group of processes while the command runs
    when the launch flags are present: ``--coordinator host:port
    --num-processes N --process-id I`` make this process one of N
    (``parallel/mesh.init_distributed``; ``--device cuda`` without an
    index takes card ``I mod`` the cards visible), after which the eval and
    train loops work on this process's shard of the records."""
    from video_analytics_tpu_torch.utils.device import require_cuda
    if not args.coordinator:
        yield require_cuda(args.device)
        return
    from video_analytics_tpu_torch.parallel import mesh
    device = mesh.init_distributed(args.coordinator, args.num_processes,
                                   args.process_id, args.device)
    try:
        yield device
    finally:
        mesh.shutdown()


def _spynet_net(args, device):
    """The SpyNet of ``--algo spynet`` on `device`, in eval mode (None for
    the other algorithms): the weights of ``--spynet-checkpoint``, else
    the bundled ones, read with ``runtime/checkpoint.load_variables``.  A
    missing file raises FileNotFoundError."""
    if args.algo != "spynet":
        return None
    from video_analytics_tpu_torch.models.spynet import (
        SpyNet, default_spynet_checkpoint)
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables
    net = SpyNet(levels=4)
    path = args.spynet_checkpoint or default_spynet_checkpoint()
    net.load_flax_variables(load_variables(path, net.flax_variables()))
    return net.to(device).eval()


def _load_two_stream(args, device):
    """The two-stream model on `device`, in eval mode: made from --arch,
    --width, --num-classes and --flow-stack, initialised from a seed
    (serve's --seed, else 0), then loaded from --checkpoint and folded
    (--fold-bn) where asked."""
    import torch
    from video_analytics_tpu_torch.models.two_stream import (
        TwoStreamModel, arch_input)
    from video_analytics_tpu_torch.runtime.checkpoint import load_variables
    model = TwoStreamModel.create(
        num_classes=args.num_classes, flow_stack=args.flow_stack,
        fusion_weights=arch_input(args.arch).fusion_weights,
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
                                        cfg.preprocess.flow_bound,
                                        dtype=model.temporal.dtype)
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
        out["flow"] = flow_features(x, model.temporal, cfg,
                                    _spynet_net(args, device)).cpu().numpy()
    np.savez(args.out, **out)
    print(json.dumps({k: list(v.shape) for k, v in out.items()}
                     | {"out": args.out}))
    return 0


def cmd_classify_clip(args) -> int:
    """Two-stream classification of one clip: top-k classes as JSON."""
    import numpy as np
    from video_analytics_tpu_torch.runtime.evaluate import classify_clip_file
    from video_analytics_tpu_torch.utils.device import require_cuda

    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
    flow_net = _spynet_net(args, device)
    classes = _load_class_names(args.class_index)
    probs = classify_clip_file(args.video, model, cfg, device,
                               num_windows=args.windows, flow_net=flow_net)
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
    the correct count kept on the device.  With --coordinator (--batched
    only) each process evaluates its shard of the list and every process
    prints the global counts with its own shard's failures."""
    if args.coordinator and not args.batched:
        print("error: --coordinator needs --batched (the clip-by-clip "
              "loop runs in one process)", file=sys.stderr)
        return 2
    with _maybe_init_distributed(args) as device:
        return _eval_ucf101(args, device)


def _eval_ucf101(args, device) -> int:
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.runtime.evaluate import (
        evaluate, evaluate_batched)

    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
    flow_net = _spynet_net(args, device)
    ds = UCF101(videos_root=args.videos, annotations_root=args.annotations,
                split=args.split)
    if args.batched:
        records = ds.test_records()
        if args.limit is not None:
            records = records[:args.limit]
        result = evaluate_batched(records, model, cfg, device,
                                  batch_clips=args.batch_clips,
                                  num_windows=args.windows, host_resize=True,
                                  flow_net=flow_net)
    else:
        result = evaluate(ds.test_records(), model, cfg, device,
                          manifest_path=args.manifest,
                          predictions_path=args.predictions,
                          limit=args.limit, num_windows=args.windows,
                          flow_net=flow_net)
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


def cmd_train(args) -> int:
    """Fine-tune the two-stream model (``--stream rgb|flow|both``) on
    UCF101-layout data and write a two-stream checkpoint that
    ``classify-clip`` and ``eval-ucf101`` of either package load.

    Decode worker threads sample random windows (``TrainWindowSampler``)
    while the device runs the steps, and ``DevicePrefetcher`` copies batch
    k+1 to the device while step k runs.  Each step builds both streams'
    examples on the device (the flow through the kernels) and takes one
    SGD step per trained stream.  ``--cache-dir`` caches decoded frames as
    per-clip .npy, so later epochs decode no container.  The crop draws
    come from a ``torch.Generator`` seeded with ``--seed``, so they differ
    from the JAX command's.

    With --coordinator each process samples its windows from its own shard
    of the train records, --batch is rounded up to split evenly over the
    processes, and each step is the step on the global batch
    (``runtime/train``); every process prints the result line, process 0
    alone writes --out while the others wait for it."""
    with _maybe_init_distributed(args) as device:
        return _train(args, device)


def _train(args, device) -> int:
    import dataclasses

    import torch
    from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher
    from video_analytics_tpu_torch.ingest.train_loader import (
        DecodeWorkersExited, TrainWindowSampler)
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.parallel import mesh
    from video_analytics_tpu_torch.runtime import train_two_stream as tts
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.utils.logging import get_logger

    log = get_logger("tpuva.train")
    flow_net = _spynet_net(args, device)
    cfg = _pipeline_config(args)
    # Random crop always; horizontal flip unless --no-flip (flipped frames
    # negate the flow's u: wrong for direction-sensitive labels).
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
        cfg.preprocess, random_crop=True, random_flip=not args.no_flip))
    ds = UCF101(videos_root=args.videos, annotations_root=args.annotations,
                split=args.split)
    records = ds.train_records()
    model = TwoStreamModel.create(num_classes=args.num_classes,
                                  flow_stack=cfg.preprocess.flow_stack,
                                  width=args.width, arch=args.arch)
    model.init(torch.Generator().manual_seed(args.seed))
    if args.init_checkpoint:
        model.load_flax_variables(load_variables(args.init_checkpoint,
                                                 model.flax_variables()))
    model.to(device)
    states = tts.create_two_stream_states(model, args.lr, args.stream)
    steps = tts.make_two_stream_train_steps(states)
    procs, pid = mesh.process_count(), mesh.process_index()
    local_b = args.batch
    if procs > 1:
        records = mesh.process_local_records(records)
        global_b = mesh.global_batch_size(args.batch, procs)
        local_b = global_b // procs
        log.info("pod mode: process %d/%d, %d local records, "
                 "global batch %d (local %d)", pid, procs, len(records),
                 global_b, local_b)
    sampler = TrainWindowSampler(
        records, window=tts.train_window_len(cfg), batch=local_b,
        seed=args.seed, max_frames=args.max_frames,
        num_workers=args.num_workers, cache_dir=args.cache_dir)

    def host_batches():
        for i, batch in enumerate(sampler.batches()):
            if i >= args.steps:
                return
            yield batch

    feed = DevicePrefetcher(host_batches(), depth=2, device=device)
    metrics = None
    n_done = 0
    try:
        for metrics in tts.train_iter(
                feed, steps, cfg, args.stream,
                torch.Generator().manual_seed(args.seed),
                flow_net=flow_net):
            n_done += 1
            if n_done % args.log_every == 0:
                log.info("step %d %s (queue ahead: %d)", n_done, " ".join(
                    f"{k}: loss {float(m['loss']):.4f} "
                    f"acc {float(m['accuracy']):.3f}"
                    for k, m in metrics.items()), sampler.qsize())
    except DecodeWorkersExited as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        sampler.stop()
        feed.close()
    if pid == 0:
        save_variables(args.out, tts.two_stream_variables(model))
    if procs > 1:
        torch.distributed.barrier()
    result = {"steps": n_done, "checkpoint": args.out,
              "stream": args.stream, "ingest": dict(sampler.stats)}
    if metrics is not None:
        for k, m in metrics.items():
            result[f"final_loss_{k}"] = float(m["loss"])
    print(json.dumps(result))
    return 0


def cmd_warmup(args) -> int:
    """Pay the first-use costs of the flow and classify paths once, before
    the work that needs them: the build of the CUDA kernels into the
    checkout's ``_build/<key>/`` (kept across processes; the directory is
    printed as ``cache_dir``), cuDNN's choice of algorithms and the caching
    allocator's first blocks at each shape (both per process).

    ``--surface flow``: ``compute_flow`` on ``--batch`` pairs of zeros at
    each size's bucket (``ops/bucketing.bucket_hw``), the shape at which
    ``compute-flow --batch`` then calls it, once per bucket.  ``--surface
    classify``: the
    batch function of ``eval-ucf101 --batched`` at the shape it dispatches
    for clips of ``--src`` (decode, host resize, transport crop, a batch of
    ``--batch-clips``; ``runtime/evaluate.warm_batched``) and the serve /
    classify-clip path (``ClipServer.warmup``), on the model of the model
    flags with random weights.  ``--surface all``: both.  Each entry of
    ``compiled`` gives its wall seconds."""
    import dataclasses
    import time

    import numpy as np
    import torch
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ops.bucketing import bucket_hw
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.runtime.pipeline import compute_flow
    from video_analytics_tpu_torch.utils.device import require_cuda

    device = require_cuda(args.device)
    fb, tv = _flow_configs(args)
    algos = [a.strip() for a in args.algos.split(",") if a.strip()]
    sizes = []
    for tok in args.sizes.split(","):
        h, w = tok.lower().split("x")
        sizes.append((int(h), int(w)))

    def timed(fn):
        """fn()'s result and the wall seconds until the device is done."""
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, round(time.perf_counter() - t0, 2)

    compiled = []
    if args.surface in ("flow", "all"):
        for algo in algos:
            cfg = PipelineConfig(flow_algo=algo, farneback=fb, tvl1=tv)
            for bh, bw in dict.fromkeys(bucket_hw(h, w) for h, w in sizes):
                x = torch.zeros((args.batch, bh, bw), device=device)
                with torch.no_grad():
                    _, secs = timed(lambda: compute_flow(x, x, cfg))
                compiled.append({"algo": algo, "bucket": [bh, bw],
                                 "secs": secs})
                print(f"warmed {algo} {bh}x{bw} in {secs}s", file=sys.stderr)
    if args.surface in ("classify", "all"):
        from video_analytics_tpu_torch.ingest.windows import (
            host_resize_short, slice_crop_source)
        from video_analytics_tpu_torch.runtime.evaluate import warm_batched
        from video_analytics_tpu_torch.runtime.serve import ClipServer

        sh, sw = (int(t) for t in args.src.lower().split("x"))
        base_cfg = _pipeline_config(args)
        model = _load_two_stream(args, device)
        pre = base_cfg.preprocess
        win = max(base_cfg.window, pre.flow_stack + 1)
        # The eval-ucf101 --batched loader's geometry: a --src decode, the
        # host resize, the transport crop.
        wins = np.zeros((args.windows, win, sh, sw, 3), np.uint8)
        wins = np.stack([host_resize_short(w, pre.resize_short)
                         for w in wins])
        wins, hw = slice_crop_source(wins, pre.resize_short, pre.crop)
        for algo in algos:
            cfg = dataclasses.replace(base_cfg, flow_algo=algo)
            shape, secs = timed(lambda: warm_batched(
                model, cfg, wins.shape, hw, args.batch_clips, device))
            compiled.append({"algo": algo, "surface": "eval-batched",
                             "shape": list(shape), "secs": secs})
            print(f"warmed {algo} eval-batched {tuple(shape)} in {secs}s",
                  file=sys.stderr)
            server = ClipServer(model, cfg, device, num_windows=args.windows)
            secs = round(server.warmup(), 2)
            compiled.append({"algo": algo, "surface": "serve", "secs": secs})
            print(f"warmed {algo} serve in {secs}s", file=sys.stderr)
    print(json.dumps({"compiled": compiled, "cache_dir": _build.build_dir()}))
    return 0


def cmd_serve(args) -> int:
    """Long-running classify server over a stdin/stdout line protocol
    (runtime/serve.py).  --warmup builds the kernels and runs the path
    once before the first request."""
    from video_analytics_tpu_torch.runtime.serve import ClipServer
    from video_analytics_tpu_torch.utils.device import require_cuda

    device = require_cuda(args.device)
    cfg = _pipeline_config(args)
    model = _load_two_stream(args, device)
    server = ClipServer(model, cfg, device,
                        classes=_load_class_names(args.class_index),
                        num_windows=args.windows, topk=args.topk,
                        normalize=not args.raw, max_frames=args.max_frames,
                        flow_net=_spynet_net(args, device))
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


DEFAULT_WARMUP_SIZES = "240x320,360x480,480x640,720x1280,1080x1920"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuva-torch",
        description="video analytics on PyTorch/CUDA (two-stream + "
                    "TV-L1, Farneback or SpyNet optical flow)")
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
                    help="flow algorithm")
    cf.add_argument("--exact", action="store_true",
                    help="force the exact gather warp (cv2 warp "
                         "semantics); the port's warp always is, so this "
                         "changes nothing")
    cf.add_argument("--no-bucket", action="store_true",
                    help="compute flow at the exact native resolution "
                         "instead of padding to the 64px shape ladder "
                         "(which changes the flow in a border band)")
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
                    help="flow algorithm")
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
                    help="flow algorithm")
    cc.add_argument("--class-index", default=None,
                    help="UCF101 classInd.txt for names")
    _add_model_args(cc, clip_archs=True)
    cc.add_argument("--topk", type=int, default=5)
    cc.add_argument("--windows", type=int, default=1)
    _add_flow_args(cc)
    cc.set_defaults(fn=cmd_classify_clip)

    sv = sub.add_parser(
        "serve",
        help="long-running classify server (JSON lines on stdin/stdout)")
    sv.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm")
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
                    help="seed of the random model weights without "
                         "--checkpoint (the port's own flag; its default "
                         "is the reference's fixed seed 0)")
    _add_flow_args(sv)
    sv.set_defaults(fn=cmd_serve)

    ev = sub.add_parser("eval-ucf101", help="UCF101 split eval")
    ev.add_argument("--videos", required=True)
    ev.add_argument("--annotations", required=True)
    ev.add_argument("--split", type=int, default=1)
    ev.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm")
    _add_model_args(ev, clip_archs=True)
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
    _add_distributed_args(ev)
    _add_flow_args(ev)
    ev.set_defaults(fn=cmd_eval_ucf101)

    tr = sub.add_parser("train",
                        help="fine-tune the two-stream model on UCF101")
    tr.add_argument("--videos", required=True)
    tr.add_argument("--annotations", required=True)
    tr.add_argument("--out", required=True, help="checkpoint output path")
    tr.add_argument("--split", type=int, default=1)
    tr.add_argument("--stream", choices=["rgb", "flow", "both"],
                    default="both", help="which stream(s) to train")
    tr.add_argument("--algo", choices=["tvl1", "farneback", "spynet"],
                    default="tvl1",
                    help="flow algorithm feeding the temporal stream")
    _add_model_args(tr, inference=False)
    tr.add_argument("--fold-bn", action="store_true",
                    help="accepted for the reference's command line; "
                         "does nothing in training")
    tr.add_argument("--max-frames", type=int, default=120,
                    help="decode cap per training clip")
    tr.add_argument("--num-workers", type=int, default=2,
                    help="decode worker threads feeding the train loop")
    tr.add_argument("--cache-dir", default=None,
                    help="cache decoded frames as per-clip .npy here; "
                         "later epochs skip container decode")
    tr.add_argument("--batch", type=int, default=32)
    tr.add_argument("--steps", type=int, default=1000)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights, the window sampling "
                         "and the crop draws")
    tr.add_argument("--no-flip", action="store_true",
                    help="disable horizontal-flip augmentation (needed "
                         "for direction-sensitive label sets: flipping "
                         "frames negates the flow u channel)")
    tr.add_argument("--init-checkpoint", default=None,
                    help="msgpack checkpoint of both streams to start from")
    tr.add_argument("--log-every", type=int, default=20)
    _add_distributed_args(tr)
    _add_flow_args(tr)
    tr.set_defaults(fn=cmd_train)

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

    wu = sub.add_parser(
        "warmup",
        help="build the kernels and run the flow and classify paths once "
             "at the given shapes")
    wu.add_argument("--sizes", default=DEFAULT_WARMUP_SIZES,
                    help="comma-separated HxW video sizes "
                         f"(default: {DEFAULT_WARMUP_SIZES})")
    wu.add_argument("--algos", default="tvl1,farneback")
    wu.add_argument("--batch", type=int, default=8,
                    help="compute-flow's --batch: frame pairs per flow call")
    wu.add_argument("--surface", choices=["flow", "classify", "all"],
                    default="flow",
                    help="the compute-flow path at --sizes, the classify "
                         "paths (eval-ucf101 --batched + serve), or both")
    wu.add_argument("--src", default="240x320",
                    help="source video resolution for the classify "
                         "surface's geometry (UCF101's by default)")
    wu.add_argument("--batch-clips", type=int, default=8,
                    help="eval-ucf101's --batch-clips")
    wu.add_argument("--windows", type=int, default=1,
                    help="eval-ucf101's and serve's --windows")
    _add_model_args(wu, inference=False)
    wu.add_argument("--fold-bn", action="store_true",
                    help="warm the folded model's classify paths")
    _add_flow_args(wu)
    wu.set_defaults(fn=cmd_warmup, checkpoint=None)
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


# The reference scripts' commands, each a console script of its own
# (pyproject.toml: extract-frames-torch, ...).
def extract_frames_entry():
    sys.exit(main(["extract-frames"] + sys.argv[1:]))


def compute_flow_entry():
    sys.exit(main(["compute-flow"] + sys.argv[1:]))


def extract_features_entry():
    sys.exit(main(["extract-features"] + sys.argv[1:]))


def classify_clip_entry():
    sys.exit(main(["classify-clip"] + sys.argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
