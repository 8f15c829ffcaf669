#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports no JAX, and fails (non-zero exit, no result line) where
``torch.cuda.is_available()`` is false or the package is not beside it.
OpenCV is needed by the last phase only, as by the command it drives.
Phases, each reported on a JSON line:

1. build: compile every CUDA kernel of both serve paths from
   ``video_analytics_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc per
   source, all started together);
2. kernels: call each kernel's wrapper at the serve path's shapes (15
   frame pairs at the five pyramid sizes of a 224² crop) and hold it
   against its plain PyTorch version on the same inputs, with the
   tolerance stated; time both with CUDA events; check that an image
   stops on its own ε test (an easy pair's flow is the same alone and
   batched with a hard pair);
3. serve: build ``ClipServer`` at full width (two ResNet-18s of width 64,
   101 classes, 16-frame windows, ``TVL1Config()``) from seed 0, warm it
   up, answer a ping and three classify requests on seeded frames, with
   every kernel's launch counter reset just before the requests and
   required to be > 0 after them; hold the fused probabilities against
   the same window run through the plain versions;
4. profile: where one request's time goes.  Stage times on the host
   clock with a sync after each stage, then one request under
   ``torch.profiler``: device time per kernel name, the sum and the union
   of all device intervals, and that union's share of the profiled
   request and of an unprofiled one;
5. farneback_kernels: K-D ``fb_prologue``, K-E ``fb_warp_neq`` and K-F
   ``sep_corr`` (both axes, with and without the solve epilogue, box and
   Gaussian taps) against their plain versions at the three pyramid sizes
   of the serve path (56², 112², 224²; 16 frames, 15 pairs) and of a
   native 240×320 clip (60×80, 120×160, 240×320), timed with CUDA
   events; at the native sizes also at the pair form's batches, as
   ``compute-flow --batch 8`` calls them (8 and 7 pairs, the prologue
   over 16 and 14 frames); one whole level (3 iterations) at each of
   these shapes and one whole ``farneback_sequence`` against
   ``plain=True``;
6. farneback_serve: phase 3 with ``flow_algo="farneback"``: three
   requests, launch counts of K-D, K-E, K-F per request, the fused
   probabilities against the plain versions', the mean recovered flow
   against the scene's (1.3, −0.7), and phase 4's profile of one request;
7. compute_flow: ``tpuva-torch compute-flow --algo farneback --format
   flo`` on a 16-frame 240×320 frames directory written to a temporary
   directory, with the launch counts of K-D, K-E, K-F set to 0 just
   before the command and held to the expected numbers just after; 15
   ``.flo`` files, one read back.

Then it prints the kernel table (``{"kernels": [...]}``: for each kernel
its launches on its serve path (``sep_corr``'s two instantiations, the
one-plane correlation and the five-plane one with the solve epilogue,
have a row each), its time, its plain version's, the time
of one PyTorch call that computes the same function where there is one,
and its bound, the least time the card could take: bytes read once and
written once over 3.35 TB/s, or float32 operations over 67 TFLOP/s,
whichever is larger), the card's
``name, power.limit`` as nvidia-smi reports them, and, last, the result
line ``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = (224, 179, 143, 115, 92)       # TVL1Config() pyramid of a 224² crop
PAIRS = 15                             # frame pairs of a 16-frame window
SERVE_REQUESTS = 3

TOL_WARP = 1e-4        # K-A, on planes of [0, 255] images
TOL_ROUND = 1e-5       # K-B, u and v after one outer round
TOL_EPS = 1e-5         # ε reduction, relative to ε² (its scale here)
# Fused probabilities, kernels vs plain versions.  The flow kernels match
# their plain versions bit for bit and the CNN calls are the same, so any
# difference is a fault: with random weights the 101 probabilities sit
# near 1/101, and a looser bound would let a wrong flow through.
TOL_PROBS = 1e-6
# The Farneback kernels follow their plain versions' operation order and
# the library is built without FMA contraction: they are held to equality.
TOL_FB = 0.0
TOL_MEAN_FLOW = 0.15   # px, mean interior flow against the scene's motion
VEL = (1.3, -0.7)      # the scene's motion, px per frame
# Texture of the Farneback phases' scenes.  On the TV-L1 phases' scene
# (0.12 rad/px) the second derivatives are so small that the solve's 1e-3
# regulariser halves the flow, here as in cv2.calcOpticalFlowFarneback:
# (0.63, -0.34) for a motion of (1.3, -0.7).  At 0.4 rad/px it is recovered.
FB_FMAX = 0.4
NATIVE = (240, 320)    # UCF101's native frame size, for compute-flow
CF_BATCH = 8           # compute-flow's --batch: frame pairs per flow call
FB_FRAMES = 16

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published peak
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    `nbytes` (each input read once, each output written once) or to do
    `flops` float32 operations, whichever is larger."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOP_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scene(np, t: float, h: int, w: int, seed: int, vel=(1.3, -0.7),
          fmax: float = 0.12):
    """(h, w) smooth texture in [0, 255] translated by t·vel pixels: a
    sum of sinusoids of up to `fmax` rad/px, so sub-pixel motion is
    exact."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x = x - t * vel[0]
    y = y - t * vel[1]
    img = np.zeros((h, w))
    for _ in range(6):
        fx, fy = rng.uniform(-fmax, fmax, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * x + fy * y
                                              + rng.uniform(0, 6.3))
    img -= img.min()
    return (255.0 * img / img.max()).astype(np.float32)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds of fn() on the device, from CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_request(torch, np, server, frames, request_ms):
    """Where one request's time goes.  Returns the stage times (host
    clock, sync after each) and, from one request under torch.profiler,
    the device time per kernel name, the summed and the merged (union)
    device intervals, and the union's share of the profiled request's
    wall and of the median unprofiled request."""
    from torch.profiler import ProfilerActivity, profile

    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime import pipeline

    algo = server.cfg.flow_algo
    model, stages = server.model, {}
    mark = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = 1e3 * (now - mark[0])
        mark[0] = now

    with torch.no_grad():
        wins, cfg = apply_transport_crop(server._windows_from_frames(frames),
                                         server.cfg)
        x = server._to_device(wins)
        lap("host_windows_and_copy")
        x = pipeline._crop(x, cfg)
        lap("resize_and_crop")
        rgb = pp.normalize(x, cfg.preprocess.mean, cfg.preprocess.std)
        s_logits = model.spatial(rgb.reshape(-1, *rgb.shape[2:])).mean(0)
        lap("rgb_cnn")
        stacks = pipeline._flow_stacks(x, cfg, plain=False)[0]
        lap(f"{algo}_and_stacking")
        t_logits = model.temporal(stacks).mean(0)
        model.fuse(s_logits, t_logits).cpu()
        lap("flow_cnn_and_fuse")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server._classify(server._windows_from_frames(frames))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, per_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end      # µs
        spans.append((a, b))
        ms, n = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (ms + (b - a) / 1e3, n + 1)
    busy_ms, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_ms += (b - max(a, end)) / 1e3
            end = b
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    median_ms = float(np.median(request_ms))
    return {"stage_ms": stages, "stage_sum_ms": sum(stages.values()),
            "profiled_wall_ms": wall_ms, "device_events": len(spans),
            "device_sum_ms": sum(ms for ms, _ in per_name.values()),
            "device_busy_ms": busy_ms,
            "busy_share_of_profiled": busy_ms / wall_ms,
            "unprofiled_median_ms": median_ms,
            "busy_share_of_unprofiled": busy_ms / median_ms,
            "top_device_ms": [{"name": name[:80], "ms": ms, "count": n}
                              for name, (ms, n) in top]}


def zero_counts(kernels) -> None:
    """Set the launch count of every wrapper in {name: wrapper} to 0."""
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def zero_fb_counts(fk) -> None:
    """Set the launch counts of the Farneback wrappers to 0."""
    fk.fb_prologue.launches = fk.fb_warp_neq.launches = 0
    fk.sep_corr.launches = fk.sep_corr.launches_solve = 0


def read_fb_counts(fk):
    """Launches per Farneback kernel.  ``sep_corr`` launches one of two
    instantiations, counted apart: the one-plane correlation, and the
    five-plane one with the solve epilogue."""
    return {"fb_prologue": fk.fb_prologue.launches,
            "fb_warp_neq": fk.fb_warp_neq.launches,
            "sep_corr": fk.sep_corr.launches - fk.sep_corr.launches_solve,
            "sep_corr_x_solve": fk.sep_corr.launches_solve}


def serve_requests(server, frames, zero, read):
    """Answer SERVE_REQUESTS classify requests with every launch count
    set to 0 (`zero()`) just before and read (`read()`) just after.
    Returns (request_ms, probabilities of each request, launches per
    kernel)."""
    zero()
    request_ms, outs = [], []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        outs.append(server._classify(server._windows_from_frames(frames)))
        request_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serve path")
    return request_ms, outs, launches


def check_probs(torch, np, server, frames, probs):
    """The answer is a distribution over the classes and equals the one
    the plain versions of the kernels give.  Returns the max abs
    difference."""
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.runtime.pipeline import classify_window

    n_classes = server.cfg.num_classes
    check(probs.shape == (n_classes,), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()) and bool((probs >= 0).all()),
          "probs not finite and non-negative")
    check(abs(float(probs.sum()) - 1.0) < 1e-4, f"probs sum {probs.sum()}")
    wins, wcfg = apply_transport_crop(server._windows_from_frames(frames),
                                      server.cfg)
    x = torch.from_numpy(wins[0]).to(server.device)
    plain = classify_window(x, server.model, wcfg, plain=True).cpu().numpy()
    e = float(np.abs(plain - probs).max())
    check(e <= TOL_PROBS, f"fused probs vs plain versions: {e} > {TOL_PROBS}")
    return e


def farneback_kernels_phase(torch, np, dev):
    """Phase 5.  Returns (errs, times, bounds) keyed by kernel name; times
    and bounds are those at the finest serve level (224², 15 pairs).

    At every level the kernels get the sequence form's shapes (16 frames,
    15 pairs), which the serve path gives them.  At the native levels
    they also get the pair form's, as ``compute-flow --batch 8`` gives
    them for a 16-frame clip: chunks of 8 and 7 pairs, whose prologue
    runs over both sides of every pair (16 and 14 frames)."""
    import torch.nn as nn

    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import (
        _level_sizes, farneback_sequence)
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    cfg = FarnebackConfig()
    n_poly = 2 * cfg.poly_n + 1
    tap_sets = {"box": farneback_window_taps(cfg.winsize, False),
                "gaussian": farneback_window_taps(cfg.winsize, True)}
    errs = {"fb_prologue": 0.0, "fb_warp_neq": 0.0, "sep_corr": 0.0,
            "sep_corr_x_solve": 0.0}
    shapes = {}
    report, main_times, main_bounds = {}, {}, {}
    level_err = seq_epe = 0.0

    def diff(got, want, what):
        e = (got - want).abs().max().item()
        check(got.shape == want.shape and e <= TOL_FB,
              f"{what}: max abs {e} > {TOL_FB}")
        return e

    def check_level(src, split, lh, lw, scale):
        """Every kernel and one whole level against the plain versions,
        at one level and one batch: `src` is the frames the prologue
        sees, `split` cuts its output into the pairs' R0 and R1.  Returns
        the tensors, for timing."""
        nonlocal level_err
        B = split(src)[0].shape[0]
        what = f"{lh}x{lw}, {src.shape[0]} frames, {B} pairs"
        shapes.setdefault(f"{lh}x{lw}", []).append([src.shape[0], B])
        args = (src, scale, (lh, lw), cfg.poly_n, cfg.poly_sigma)
        R = fk.fb_prologue(*args)
        R_ref = fk.fb_prologue_plain(*args)
        errs["fb_prologue"] = max(errs["fb_prologue"],
                                  diff(R, R_ref, f"fb_prologue at {what}"))
        R0, R1 = (r.contiguous() for r in split(R_ref))
        yy, xx = np.mgrid[0:lh, 0:lw] / max(lh, lw)
        flow = torch.from_numpy(np.stack([np.stack(
            [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
            for b in range(B)]).astype(np.float32)).to(dev)
        flow[0] = torch.round(flow[0])             # floor() at exact integers
        flow[1, 0, :, :3] = -50.0                  # the clamp, far outside
        M = fk.fb_warp_neq(R0, R1, flow)
        M_ref = fk.fb_warp_neq_plain(R0, R1, flow)
        errs["fb_warp_neq"] = max(errs["fb_warp_neq"],
                                  diff(M, M_ref, f"fb_warp_neq at {what}"))
        for tname, taps in tap_sets.items():
            for axis in (0, 1):
                for solve in (False, True):
                    e = diff(fk.sep_corr(M_ref, taps, axis, solve),
                             fk.sep_corr_plain(M_ref, taps, axis, solve),
                             f"sep_corr {tname} axis {axis} solve {solve} "
                             f"at {what}")
                    name = "sep_corr_x_solve" if solve else "sep_corr"
                    errs[name] = max(errs[name], e)

        # One whole level: 3 iterations, kernels against plain versions.
        taps = tap_sets["box"]
        f_k = f_p = torch.zeros_like(flow)
        for _ in range(cfg.iterations):
            f_k = fk.sep_corr(fk.sep_corr(fk.fb_warp_neq(R0, R1, f_k),
                                          taps, 0), taps, 1, solve=True)
            f_p = fk.sep_corr_plain(fk.sep_corr_plain(
                fk.fb_warp_neq_plain(R0, R1, f_p), taps, 0), taps, 1,
                solve=True)
        level_err = max(level_err, diff(f_k, f_p, f"level at {what}"))
        return args, R0, R1, flow, M_ref

    for H, W in ((224, 224), NATIVE):
        frames = torch.from_numpy(np.stack(
            [scene(np, t, H, W, seed=3, fmax=FB_FMAX)
             for t in range(FB_FRAMES)])).to(dev)
        B = FB_FRAMES - 1
        taps = tap_sets["box"]
        for lh, lw, scale in _level_sizes(H, W, cfg):
            key = f"{lh}x{lw}"
            if (H, W) == NATIVE:
                # The pair form, as compute-flow calls it: both sides of
                # each chunk's pairs go through the prologue together.
                for s in range(0, B, CF_BATCH):
                    e = min(s + CF_BATCH, B)
                    check_level(
                        torch.cat([frames[s:e], frames[s + 1:e + 1]]),
                        lambda R, n=e - s: (R[:n], R[n:]), lh, lw, scale)
            # The sequence form, as the serve path calls it; timed below.
            args, R0, R1, flow, M_ref = check_level(
                frames, lambda R: (R[:-1], R[1:]), lh, lw, scale)

            # One PyTorch call that computes K-F without its epilogue: a
            # convolution with the taps and a replicate border.  It is
            # timed here and used nowhere in the package.
            r = len(taps) // 2
            conv = nn.Conv2d(1, 1, (len(taps), 1), padding=(r, 0),
                             padding_mode="replicate", bias=False).to(dev)
            with torch.no_grad():
                conv.weight.copy_(torch.tensor(taps).view(1, 1, -1, 1))
                planes = M_ref.reshape(B * 5, 1, lh, lw)
                lib_out = conv(planes).reshape(B, 5, lh, lw)
                scale_m = M_ref.abs().max().item()
                e = (lib_out - fk.sep_corr_plain(M_ref, taps, 0)
                     ).abs().max().item()
                check(e <= 1e-5 * scale_m,
                      f"the library convolution is not sep_corr at {key}: {e}")
                library_ms = cuda_ms(torch, lambda: conv(planes))
            times = {
                "fb_prologue": (
                    cuda_ms(torch, lambda: fk.fb_prologue(*args)),
                    cuda_ms(torch, lambda: fk.fb_prologue_plain(*args)), None),
                "fb_warp_neq": (
                    cuda_ms(torch, lambda: fk.fb_warp_neq(R0, R1, flow)),
                    cuda_ms(torch, lambda: fk.fb_warp_neq_plain(R0, R1, flow)),
                    None),
                "sep_corr": (
                    cuda_ms(torch, lambda: fk.sep_corr(M_ref, taps, 0)),
                    cuda_ms(torch, lambda: fk.sep_corr_plain(M_ref, taps, 0)),
                    library_ms),
                "sep_corr_x_solve": (
                    cuda_ms(torch, lambda: fk.sep_corr(M_ref, taps, 1, True)),
                    cuda_ms(torch, lambda: fk.sep_corr_plain(M_ref, taps, 1,
                                                             True)), None)}
            # Bytes: inputs read once, outputs written once.  Operations:
            # the separable algorithm's multiplies and adds (blur 2 passes,
            # 2 taps of each resized axis, 3 vertical + 6 horizontal
            # expansion sums and the combine; 5 bilinear samples and the
            # normal equations; one multiply-add per tap and plane).
            n_blur = len(fk._smooth_taps(scale))
            px, lpx = FB_FRAMES * H * W, FB_FRAMES * lh * lw
            resize_ops = (3 * FB_FRAMES * lh * W + 3 * lpx) if scale < 1 else 0
            bounds = {
                "fb_prologue": bound(
                    4 * px + 20 * lpx,
                    4 * n_blur * px + resize_ops + (18 * n_poly + 8) * lpx),
                "fb_warp_neq": bound(17 * 4 * B * lh * lw, 100 * B * lh * lw),
                "sep_corr": bound(10 * 4 * B * lh * lw,
                                  2 * len(taps) * 5 * B * lh * lw),
                "sep_corr_x_solve": bound(
                    7 * 4 * B * lh * lw,
                    (2 * len(taps) * 5 + 12) * B * lh * lw)}
            report[key] = {
                name: {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1]}
                for name, t in times.items()}
            if (lh, lw) == (224, 224):
                main_times, main_bounds = times, bounds

        seq = farneback_sequence(frames, cfg)
        seq_plain = farneback_sequence(frames, cfg, plain=True)
        epe = (seq - seq_plain).norm(dim=-1).max().item()
        check(epe <= TOL_FB, f"farneback_sequence at {H}x{W}: max EPE {epe}")
        seq_epe = max(seq_epe, epe)
        mean = seq[:, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
        check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
              and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
              f"farneback mean flow {mean} at {H}x{W}, expected {VEL}")
        report[f"sequence_{H}x{W}"] = {
            "mean_flow": mean,
            "ms": cuda_ms(torch, lambda: farneback_sequence(frames, cfg), 3),
            "plain_ms": cuda_ms(
                torch, lambda: farneback_sequence(frames, cfg, plain=True), 3)}
    emit({"phase": "farneback_kernels", "frames": FB_FRAMES,
          "frames_and_pairs_checked": shapes, "max_abs_err": errs, "level_max_abs_err": level_err,
          "sequence_max_epe": seq_epe, "tolerance": TOL_FB,
          "by_level": report})
    return errs, main_times, main_bounds


def farneback_serve_phase(torch, np, dev, model):
    """Phase 6.  Returns the launches of K-D, K-E, K-F over the requests."""
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime.serve import ClipServer

    frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c, fmax=FB_FMAX)
                                 for c in range(3)], axis=-1)
                       for t in range(16)]).round().astype(np.uint8)
    pcfg = PipelineConfig(flow_algo="farneback")
    server = ClipServer(model, pcfg, dev)
    warm_s = server.warmup()
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_fb_counts(fk),
        lambda: read_fb_counts(fk))
    e = check_probs(torch, np, server, frames, outs[0])

    with torch.no_grad():
        wins = server._to_device(server._windows_from_frames(frames))
        gray = pp.rgb_to_gray(pipeline._crop(wins, pcfg))
        flow = pipeline.compute_flow_sequence(gray[0], pcfg)
    check(tuple(flow.shape) == (15, 224, 224, 2), f"flow {tuple(flow.shape)}")
    mean = flow[:, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"served window's mean flow {mean}, expected {VEL}")
    emit({"phase": "farneback_serve", "warmup_s": warm_s,
          "request_ms": request_ms,
          "launches_per_request": {k: v // SERVE_REQUESTS
                                   for k, v in launches.items()},
          "top1": int(outs[0].argmax()), "probs_max_abs_vs_plain": e,
          "repeat_max_abs": max(float(np.abs(o - outs[0]).max())
                                for o in outs),
          "mean_flow": mean})
    emit({"phase": "farneback_profile",
          **profile_request(torch, np, server, frames, request_ms)})
    return launches


def compute_flow_phase(np):
    """Phase 7: the compute-flow command on a frames directory, with the
    Farneback launch counts set to 0 just before it and read just after.
    Returns the launches per kernel."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import main as cli_main
    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames

    H, W = NATIVE
    frames = np.stack([np.stack([scene(np, t, H, W, seed=c, fmax=FB_FMAX)
                                 for c in range(3)], axis=-1)
                       for t in range(FB_FRAMES)]).round().astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "frames"), os.path.join(tmp, "flow")
        write_frames(frames, src)
        zero_fb_counts(fk)
        t0 = time.perf_counter()
        rc = cli_main(["compute-flow", src, out, "--algo", "farneback",
                       "--format", "flo", "--batch", str(CF_BATCH),
                       "--device", "cuda"])
        seconds = time.perf_counter() - t0
        launches = read_fb_counts(fk)
        check(rc == 0, f"compute-flow exited {rc}")
        files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
        check(len(files) == FB_FRAMES - 1,
              f"compute-flow wrote {len(files)} .flo files")
        flow = read_flo(os.path.join(out, files[7]))
    check(flow.shape == (H, W, 2) and bool(np.isfinite(flow).all()),
          f"flow read back: {flow.shape}")
    mean = flow[16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"compute-flow mean flow {mean}, expected {VEL}")
    # Each flow call of --batch pairs launches the prologue once per level,
    # and per level and iteration K-E, K-F along y and K-F along x with the
    # solve.
    cfg = FarnebackConfig()
    calls = -(-(FB_FRAMES - 1) // CF_BATCH)
    levels = len(_level_sizes(H, W, cfg))
    per_kernel = calls * levels * cfg.iterations
    expected = {"fb_prologue": calls * levels, "fb_warp_neq": per_kernel,
                "sep_corr": per_kernel, "sep_corr_x_solve": per_kernel}
    check(launches == expected,
          f"compute-flow launched {launches}, expected {expected}")
    emit({"phase": "compute_flow", "files": len(files), "seconds": seconds,
          "read_back": files[7], "mean_flow": mean, "batch": CF_BATCH,
          "launches": launches})
    return launches


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "video_analytics_tpu_torch")):
        raise SystemExit("chip_smoke: video_analytics_tpu_torch/ is not "
                         "beside this script; run it from the repo")
    sys.path.insert(0, HERE)

    from video_analytics_tpu_torch.config import PipelineConfig, TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import (
        warp_prep, warp_prep_plain)
    from video_analytics_tpu_torch.ops.kernels import centered_gradient
    from video_analytics_tpu_torch.runtime.serve import ClipServer
    from video_analytics_tpu_torch.utils.device import require_cuda

    dev = require_cuda("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds"),
          "library": os.path.relpath(_build.build_info["path"], HERE),
          "ptxas": ptxas})

    # -- 2. kernels against their plain versions ----------------------------
    cfg = TVL1Config()
    one_round = dataclasses.replace(cfg, outer_iterations=1)
    errs = {"warp_prep": 0.0, "tvl1_pd_step": 0.0, "median5": 0.0,
            "tvl1_eps_reduce": 0.0}
    times = {}
    for size in SIZES:
        i0 = torch.from_numpy(np.stack([scene(np, b, size, size, seed=b)
                                        for b in range(PAIRS)])).to(dev)
        i1 = torch.from_numpy(np.stack([scene(np, b + 1, size, size, seed=b)
                                        for b in range(PAIRS)])).to(dev)
        i1x, i1y = centered_gradient(i1)
        i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
        yy, xx = np.mgrid[0:size, 0:size] / size
        uv = torch.from_numpy(np.stack([np.stack(
            [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
            for b in range(PAIRS)]).astype(np.float32)).to(dev)

        prep = warp_prep(i13, i0, uv)
        prep_ref = warp_prep_plain(i13, i0, uv)
        e = (prep - prep_ref).abs().max().item()
        check(e <= TOL_WARP, f"warp_prep at {size}: max abs {e} > {TOL_WARP}")
        errs["warp_prep"] = max(errs["warp_prep"], e)

        active = torch.tensor([b % 2 for b in range(PAIRS)],
                              dtype=torch.int32, device=dev)
        noisy = uv + torch.randn(uv.shape, device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     size))
        for k in (3, 5):
            for mask in (None, active):
                got = ts.median5(noisy, k, mask)
                want = ts.median5_plain(noisy, k, mask)
                check(torch.equal(got, want),
                      f"median5 k={k} at {size} is not bit-exact")

        got = ts.pd_solve(prep_ref, uv, one_round)
        want = ts.pd_solve_plain(prep_ref, uv, one_round)
        e = (got - want).abs().max().item()
        check(e <= TOL_ROUND,
              f"one outer round at {size}: max abs {e} > {TOL_ROUND}")
        errs["tvl1_pd_step"] = max(errs["tvl1_pd_step"], e)

        n_px = size * size
        eps2 = cfg.epsilon ** 2
        partial = (torch.rand((PAIRS, ts.pd_blocks(size, size)), device=dev,
                              generator=torch.Generator(dev).manual_seed(1))
                   * (4 * eps2 * n_px / ts.pd_blocks(size, size)))
        flags = [torch.ones(PAIRS, dtype=torch.int32, device=dev)
                 for _ in range(2)]
        errv = [torch.full((PAIRS,), float("inf"), device=dev)
                for _ in range(2)]
        ts.eps_reduce(partial, flags[0], errv[0], n_px, cfg.epsilon)
        ts.eps_reduce_plain(partial, flags[1], errv[1], n_px, cfg.epsilon)
        e = (errv[0] - errv[1]).abs().max().item()
        check(e <= TOL_EPS * eps2,
              f"eps_reduce at {size}: max abs {e} > {TOL_EPS} * eps^2")
        check(torch.equal(flags[0], flags[1]),
              f"eps_reduce at {size}: flags differ")
        errs["tvl1_eps_reduce"] = max(errs["tvl1_eps_reduce"], e)

        p = torch.zeros((PAIRS, 4, size, size), device=dev)
        uv_out, p_out = torch.empty_like(uv), torch.empty_like(p)
        on = torch.ones(PAIRS, dtype=torch.int32, device=dev)
        big = partial * 1e3                  # no flag clears while timing
        times[size] = {
            "warp_prep": (
                cuda_ms(torch, lambda: warp_prep(i13, i0, uv)),
                cuda_ms(torch, lambda: warp_prep_plain(i13, i0, uv))),
            "median5": (
                cuda_ms(torch, lambda: ts.median5(uv, 5, on, out=uv_out)),
                cuda_ms(torch, lambda: ts.median5_plain(uv, 5, on))),
            "tvl1_pd_step": (
                cuda_ms(torch, lambda: ts.pd_step(prep, uv, p, on, cfg,
                                                  uv_out, p_out)),
                cuda_ms(torch, lambda: ts.pd_step_plain(prep, uv, p, cfg))),
            "tvl1_eps_reduce": (
                cuda_ms(torch, lambda: ts.eps_reduce(
                    big, on, errv[0], n_px, cfg.epsilon)),
                cuda_ms(torch, lambda: ts.eps_reduce_plain(
                    big, on, errv[1], n_px, cfg.epsilon)))}
        if size == SIZES[0]:
            times[size]["pd_solve_one_warp"] = (
                cuda_ms(torch, lambda: ts.pd_solve(prep, uv, cfg), 3),
                cuda_ms(torch, lambda: ts.pd_solve_plain(prep, uv, cfg), 3))
    emit({"phase": "kernels", "sizes": list(SIZES), "pairs": PAIRS,
          "max_abs_err": errs, "median5_bit_exact": True,
          "ms_kernel_vs_plain": times})

    # Per-image ε stop: an easy pair's flow must not depend on its batch.
    size = SIZES[0]
    easy = (scene(np, 0, size, size, 99, vel=(0.3, 0.1)),
            scene(np, 1, size, size, 99, vel=(0.3, 0.1)))
    hard = (scene(np, 0, size, size, 98, vel=(3.5, -2.4)),
            scene(np, 1, size, size, 98, vel=(3.5, -2.4)))
    prev = torch.from_numpy(np.stack([easy[0], hard[0]])).to(dev)
    nxt = torch.from_numpy(np.stack([easy[1], hard[1]])).to(dev)
    both = tvl1(prev, nxt, cfg)
    alone = tvl1(prev[:1], nxt[:1], cfg)
    hard_alone = tvl1(prev[1:], nxt[1:], cfg)
    check(torch.equal(both[0], alone[0]),
          "easy pair's flow changed when batched with a hard pair")
    check(torch.equal(both[1], hard_alone[0]),
          "hard pair's flow changed when batched with an easy pair")
    mean_easy = alone[0, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    mean_hard = hard_alone[0, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
    check(abs(mean_easy[0] - 0.3) < 0.1 and abs(mean_easy[1] - 0.1) < 0.1,
          f"easy pair's mean flow {mean_easy}, expected (0.3, 0.1)")
    emit({"phase": "gating", "easy_equal_alone": True,
          "hard_equal_alone": True, "easy_mean_flow": mean_easy,
          "hard_mean_flow": mean_hard})

    # -- 3. serving at full width --------------------------------------------
    frames = np.stack([np.stack([scene(np, t, 256, 256, seed=c)
                                 for c in range(3)], axis=-1)
                       for t in range(16)]).round().astype(np.uint8)
    pcfg = PipelineConfig()
    model = TwoStreamModel.create(num_classes=pcfg.num_classes,
                                  flow_stack=pcfg.preprocess.flow_stack,
                                  width=64)
    model.init(torch.Generator().manual_seed(0))
    server = ClipServer(model, pcfg, dev)
    warm_s = server.warmup()
    pong = server.handle_request({"cmd": "ping", "id": 1})
    check(pong.get("ok") is True and pong.get("id") == 1, f"ping: {pong}")

    kernels = {"warp_prep": warp_prep, "tvl1_pd_step": ts.pd_step,
               "median5": ts.median5, "tvl1_eps_reduce": ts.eps_reduce}
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_counts(kernels),
        lambda: read_counts(kernels))
    probs = outs[0]
    e = check_probs(torch, np, server, frames, probs)
    emit({"phase": "serve", "warmup_s": warm_s, "request_ms": request_ms,
          "launches_per_request": {k: v // SERVE_REQUESTS
                                   for k, v in launches.items()},
          "top1": int(probs.argmax()),
          "probs_max_abs_vs_plain": e,
          "repeat_max_abs": max(float(np.abs(o - probs).max())
                                for o in outs)})

    # -- 4. profile ---------------------------------------------------------
    emit({"phase": "profile",
          **profile_request(torch, np, server, frames, request_ms)})

    # -- 5-7. the Farneback path ----------------------------------------------
    fb_errs, fb_times, fb_bounds = farneback_kernels_phase(torch, np, dev)
    fb_launches = farneback_serve_phase(torch, np, dev, model)
    cf_launches = compute_flow_phase(np)

    # -- the kernel table -----------------------------------------------------
    # TV-L1 bounds at 224², 15 pairs.  Planes moved: warp_prep reads I1 and
    # its gradients, I0 and the flow and writes 4; pd_step reads prep, the
    # flow and the dual (10) and writes 6; median5 reads and writes u, v;
    # eps_reduce reads the per-block sums.  Operations per pixel: 3
    # bilinear samples and the prep (~45); one primal-dual step (~70); 113
    # compare-exchanges of a min and a max per plane.
    px = PAIRS * SIZES[0] * SIZES[0]
    blocks = ts.pd_blocks(SIZES[0], SIZES[0])
    bounds = {"warp_prep": bound(10 * 4 * px, 45 * px),
              "tvl1_pd_step": bound(16 * 4 * px, 70 * px),
              "median5": bound(4 * 4 * px, 2 * 2 * 113 * px),
              "tvl1_eps_reduce": bound(4 * PAIRS * blocks + 8 * PAIRS,
                                       PAIRS * blocks),
              **fb_bounds}
    errs.update(fb_errs)
    launches.update(fb_launches)
    table_ms = {**{name: (*t, None) for name, t in times[SIZES[0]].items()},
                **fb_times}
    src = "video_analytics_tpu_torch/csrc/"
    pallas = "video_analytics_tpu/ops/pallas/"
    fbk = pallas + "farneback_kernels.py:"
    rows = [("warp_prep", "warp_prep.cu", pallas + "warp.py:157",
             [pallas + "warp.py:130", pallas + "tvl1_solve.py:584"]),
            ("tvl1_pd_step", "tvl1_pd.cu", pallas + "tvl1_solve.py:191",
             [pallas + "tvl1_solve.py:415", pallas + "tvl1_solve.py:584"]),
            ("median5", "median.cu", pallas + "tvl1_solve.py:75",
             [pallas + "tvl1_solve.py:191", pallas + "tvl1_solve.py:584"]),
            ("tvl1_eps_reduce", "tvl1_pd.cu", pallas + "tvl1_solve.py:165",
             [pallas + "tvl1_solve.py:191"]),
            ("fb_prologue", "fb_prologue.cu", fbk + "1191", [fbk + "990"]),
            ("fb_warp_neq", "fb_warp_neq.cu", fbk + "471",
             [fbk + "263", fbk + "697", fbk + "772", fbk + "946",
              pallas + "warp.py:157", pallas + "warp.py:130"]),
            ("sep_corr", "sep_corr.cu", fbk + "139",
             [fbk + "263", fbk + "471", fbk + "946"]),
            ("sep_corr_x_solve", "sep_corr.cu", fbk + "574",
             [fbk + "139", fbk + "697", fbk + "946"])]
    emit({"kernels": [{"name": name, "route": "cuda", "source": src + source,
                       "replaces": replaces, "replaces_also": also,
                       "launches": launches[name],
                       "max_abs_err": errs[name],
                       "ms": table_ms[name][0],
                       "plain_ms": table_ms[name][1],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1],
                       "library_ms": table_ms[name][2],
                       **({"launches_compute_flow": cf_launches[name]}
                          if name in cf_launches else {})}
                      for name, source, replaces, also in rows]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
