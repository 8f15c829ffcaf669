#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports no JAX, and fails (non-zero exit, no result line) where
``torch.cuda.is_available()`` is false or the package is not beside it.
OpenCV is needed by the phases that drive the command line (7, 9-11), as
by the commands themselves.  Phases, each reported on a JSON line:

1. build: compile every CUDA kernel of the port from
   ``video_analytics_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc per
   source, all started together);
2. kernels: call each kernel's wrapper at the serve path's shapes (15
   frame pairs at the five pyramid sizes of a 224² crop) and hold it
   against its plain PyTorch version on the same inputs, with the
   tolerance stated; time both with CUDA events; tvl1_warp_kernel: K-H
   ``pd_solve_warp`` (one launch per warp, an image per thread-block
   cluster of 8 blocks, or of 16 where the strips need it: 240×320 and
   280×300) against ``pd_solve_plain`` at those sizes and five others,
   with ``cudaOccupancyMaxActiveClusters`` at both cluster sizes, at ε = 0
   (bit for bit) and with ε engaged, at medians 5, 3 and
   none, timed beside the per-iteration chain and the non-adaptive chunked
   solver on the same warp; ``tvl1_scale`` (``pd_solve_scale``: every warp
   of a scale with its prep, and the scale-end median, in one launch of
   the same kernel) at the same eight sizes against the chain K-A → K-H
   per warp → K-C (bit for bit, with ε engaged too) and against its plain
   version, the launch and the chain timed in turns; check that an image
   stops on its own ε test (an easy pair's flow is the same alone and
   batched with a hard pair);
3. serve: build ``ClipServer`` at full width (two ResNet-18s of width 64,
   101 classes, 16-frame windows, ``TVL1Config()``) from seed 0, warm it
   up, answer a ping and three classify requests on seeded frames, with
   every kernel's launch counter reset just before the requests and held
   to the expected numbers after them (5 ``tvl1_scale`` per request, one
   per pyramid scale, and none of K-A, K-H, K-C or the per-iteration
   kernels); hold the fused probabilities against the same window run
   through the plain versions;
4. profile: where one request's time goes.  Stage times on the host
   clock with a sync after each stage, then one request under
   ``torch.profiler``: device time per kernel name (every kernel of the
   port, with its duration per launch), the sum and the union of all
   device intervals, and that union's share of the profiled request and
   of an unprofiled one;
5. farneback_kernels: K-D ``fb_prologue``, K-E ``fb_warp_neq``, K-F
   ``sep_corr`` (both axes, with and without the solve epilogue, box and
   Gaussian taps), ``fb_window_solve`` (both window passes and the solve
   in one launch, also against the two launches of K-F) and
   ``fb_iteration`` (the same launch with K-E as its loader, also against
   K-E then ``fb_window_solve``) against their plain versions at the
   three pyramid sizes of the serve path (56², 112², 224²; 16 frames, 15
   pairs) and of a native 240×320 clip (60×80, 120×160, 240×320), timed
   with CUDA events and, at the finest levels, by their device durations;
   at the native sizes also at the pair form's batches, as ``compute-flow
   --batch 8`` calls them (8 and 7 pairs, the prologue over 16 and 14
   frames); one whole level (3 iterations) at each of these shapes and
   one whole ``farneback_sequence`` against ``plain=True``; the sequence
   timed with an iteration as three launches, two and one;
6. farneback_serve: phase 3 with ``flow_algo="farneback"``: three
   requests, launch counts per request held to the expected numbers (3
   K-D, 9 ``fb_iteration``, none of K-E, K-F or ``fb_window_solve``), the
   fused probabilities against the plain versions', the mean recovered
   flow against the scene's (1.3, −0.7), and phase 4's profile of one
   request;
7. compute_flow: ``tpuva-torch compute-flow --algo farneback --format
   flo`` on a 16-frame 240×320 frames directory written to a temporary
   directory, with the launch counts of the Farneback kernels set to 0
   just before the command and held to the expected numbers just after;
   15 ``.flo`` files, one read back; farneback_1080p: the same command on
   3 frames of 1080×1920 with ``--fb-levels 4`` (its 1/16 level pre-blurs
   with 39 taps: K-D in two launches, the blur pass ``fb_prologue_blur``
   first) and with ``--fb-winsize 33``, counts held to the expected
   numbers and every ``.flo`` equal to the plain path's flow; K-D at 39 and
   79 taps and the three window routes (33, 75, 201 taps: ``fb_iteration``;
   K-E + ``fb_window_solve``; K-E + ``sep_corr`` twice) against their plain
   versions;
8. tvl1_chunk_kernels: K-G ``pd_chunk`` (several primal-dual iterations
   per launch on shared-memory tiles) against its plain version at the
   five TV-L1 level sizes of a 1080×1920 frame (2 pairs), with and without
   the round-opening median, at a full and a remainder chunk, with all
   bands active and with some frozen: the state bit for bit, the band
   error sums to 1e-5 relative; one whole warp through
   ``pd_solve_chunked`` against the per-iteration ``pd_solve`` (bit for
   bit at ε = 0, within 10·ε with the gates engaged), both timed;
   ``band_flags`` against its plain version; tvl1_midsize:
   ``compute-flow --algo tvl1`` on 3 frames of 280×300 and of 240×320,
   whose finest levels are under the size rule and fit only a 16-block
   cluster: 5 launches of ``tvl1_scale`` each and none of K-A, K-B, the ε
   reduction or K-C (counted), the flow at ε = 0 equal to the plain
   path's, a flow call timed; then a 20×4000 pair, whose finest level
   fits no cluster, through K-A, K-B, the ε reduction and K-C (counted),
   equal to the plain path at ε = 0;
9. tvl1_1080p: ``tpuva-torch compute-flow --algo tvl1`` with
   ``TVL1Config()`` on a frames directory of 11 frames of 1080×1920 (10
   pairs, ``--batch 8``), the launch counts of the TV-L1 kernels set to 0
   just before and held to the expected numbers just after (K-G on every
   level, the per-iteration kernels not at all); the first pair's flow
   against the plain path's and the scene's motion; one flow call of 2
   pairs timed and profiled;
10. stage_chain: a checkpoint written from seed 0 and read back, then
   ``extract-features`` on the flow directory of phase 9 and on its
   frames, and ``classify-clip --checkpoint ... --windows 3`` on a 1080p
   clip, at full width; features and probabilities against the same steps
   taken on tensors with the kernels' plain versions;
11. eval_ucf101: a synthetic UCF101 (``io/synthetic.py``: 4 classes x 4
   clips of 48 frames at 240x320, 8 of them test clips, and a truncated
   ``.avi`` added to the test list) and a full-width checkpoint from seed
   0, then ``tpuva-torch eval-ucf101`` four ways, the launch counts set to
   0 just before each and held to the expected numbers just after:
   ``--batched --batch-clips 8`` (one batch, 120 frame pairs in one
   ``tvl1`` call: 5 ``tvl1_scale``, nothing else; twice, the second
   without the first calls at its shapes), with ``--windows 3``
   (360 pairs, 5 launches), clip by clip with ``--predictions`` and
   ``--manifest`` (5 a clip; the predictions and counts equal the first
   run's) and again on that manifest (nothing evaluated, no launch), and
   ``--batched --algo farneback`` (3 K-D, 9 ``fb_iteration``); the corrupt
   clip counted as failed and named each time; a batch of the first run
   and of the Farneback run through the batch function with the kernels
   and with their plain versions (1e-6); clips/s of each run (host clock,
   decode included) and the device time of the ``tvl1_scale`` launches of
   the 120- and 360-pair calls (torch.profiler).

Then it prints the kernel table (``{"kernels": [...]}``: for each kernel
its launches on its main path and which path that is (``launches_from``:
the serve requests; for K-A, K-C, K-G and ``band_flags`` the
``compute-flow`` command of phase 9; for K-D's blur pass the
``--fb-levels 4`` command of farneback_1080p; under
``launches_eval_ucf101`` those of phase 11's commands; K-H, K-B, the ε reduction,
K-E, ``sep_corr`` and ``fb_window_solve``, whose arithmetic the commands
run inside ``tvl1_scale`` and ``fb_iteration`` or only at shapes no
command here gives, are on no command's path: 0 launches, and under
``check_launches`` those of the phase that holds them against their plain
versions; ``sep_corr``'s two instantiations, the one-plane
correlation and the five-plane one with the solve epilogue, have a row
each), its time paced by the host's launches (``ms``: CUDA events around
20 calls of the wrapper), its own duration on the device (``device_ms``:
the kernel's summed device time over its launches under
``torch.profiler``), its plain version's time, the time
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

    median_ms = float(np.median(request_ms))
    prof = device_profile(torch, lambda: server._classify(
        server._windows_from_frames(frames)))
    busy_ms = prof["device_busy_ms"]
    return {"stage_ms": stages, "stage_sum_ms": sum(stages.values()), **prof,
            "unprofiled_median_ms": median_ms,
            "busy_share_of_unprofiled": busy_ms / median_ms}


def device_profile(torch, fn):
    """One call of fn() under torch.profiler: its wall time (host clock,
    with a sync), the device time per kernel name, the summed and the
    merged (union) device intervals, and the union's share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    ours = [{"name": short_kernel_name(name), "ms": ms, "count": n,
             "ms_each": ms / n}
            for name, (ms, n) in ranked if port_kernel(name)]
    return {"profiled_wall_ms": wall_ms, "device_events": len(spans),
            "device_sum_ms": sum(ms for ms, _ in per_name.values()),
            "device_busy_ms": busy_ms,
            "busy_share_of_profiled": busy_ms / wall_ms,
            "top_device_ms": [{"name": name[:80], "ms": ms, "count": n}
                              for name, (ms, n) in ranked[:10]],
            "port_kernels_device_ms": ours}


# The __global__ functions of video_analytics_tpu_torch/csrc/*.cu, as they
# appear in a profile's kernel names.
PORT_KERNELS = ("warp_prep_kernel", "pd_step_kernel", "eps_reduce_kernel",
                "median_kernel", "pd_warp_kernel", "pd_chunk_kernel",
                "band_flags_kernel", "fb_prologue_kernel",
                "fb_blur_sample_kernel",
                "fb_warp_neq_kernel", "sep_corr_kernel",
                "fb_window_solve_kernel")


def port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def short_kernel_name(name: str) -> str:
    """A profile's kernel name without its namespace and argument list:
    ``pd_warp_kernel<13, true>``."""
    name = name.split("(anonymous namespace)::", 1)[-1]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name[:80]


def device_ms(torch, fn, kernel: str, reps: int = 5) -> float:
    """The device duration of one launch of the kernel whose name holds
    `kernel`: `reps` calls of fn() under torch.profiler, the kernel's
    summed device time over its launches.  Unlike ``cuda_ms`` it leaves
    out the host's pace between launches."""
    fn()
    # The profiler now and then drops records, at times all of a short
    # session's: any count will do, and an empty profile is taken again.
    for _ in range(3):
        prof = device_profile(torch, lambda: [fn() for _ in range(reps)])
        hits = [k for k in prof["port_kernels_device_ms"]
                if kernel in k["name"]]
        if hits:
            break
    check(len(hits) == 1 and hits[0]["count"] >= 1,
          f"profile of {kernel}: {prof['port_kernels_device_ms']}")
    return hits[0]["ms_each"]


def zero_counts(kernels) -> None:
    """Set the launch count of every wrapper in {name: wrapper} to 0."""
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def zero_fb_counts(fk) -> None:
    """Set the launch counts of the Farneback wrappers to 0."""
    fk.fb_prologue.launches = fk.fb_prologue.launches_blur = 0
    fk.fb_warp_neq.launches = 0
    fk.sep_corr.launches = fk.sep_corr.launches_solve = 0
    fk.fb_window_solve.launches = fk.fb_iteration.launches = 0


def read_fb_counts(fk):
    """Launches per Farneback kernel.  ``sep_corr`` launches one of two
    instantiations, counted apart: the one-plane correlation, and the
    five-plane one with the solve epilogue."""
    return {"fb_prologue": fk.fb_prologue.launches,
            "fb_prologue_blur": fk.fb_prologue.launches_blur,
            "fb_warp_neq": fk.fb_warp_neq.launches,
            "sep_corr": fk.sep_corr.launches - fk.sep_corr.launches_solve,
            "sep_corr_x_solve": fk.sep_corr.launches_solve,
            "fb_window_solve": fk.fb_window_solve.launches,
            "fb_iteration": fk.fb_iteration.launches}


def fb_expected(levels: int, iterations: int, calls: int = 1,
                split: int = 0, route: str = "iteration"):
    """Launches of the Farneback kernels over `calls` flow calls: the
    prologue once per level, its blur pass once per level of the
    two-launch form (`split` of them), and per level and iteration the
    kernels of the window's route (``window_route``): ``fb_iteration``;
    K-E and ``fb_window_solve``; or K-E and ``sep_corr`` twice."""
    its = calls * levels * iterations
    return {"fb_prologue": calls * levels, "fb_prologue_blur": calls * split,
            "fb_iteration": its if route == "iteration" else 0,
            "fb_warp_neq": 0 if route == "iteration" else its,
            "fb_window_solve": its if route == "window_solve" else 0,
            "sep_corr": its if route == "sep_corr" else 0,
            "sep_corr_x_solve": its if route == "sep_corr" else 0}


def serve_requests(server, frames, zero, read, per_request=None):
    """Answer SERVE_REQUESTS classify requests with every launch count
    set to 0 (`zero()`) just before and read (`read()`) just after; every
    count must be > 0 or, with `per_request`, SERVE_REQUESTS times the
    number given there.  Returns (request_ms, probabilities of each
    request, launches per kernel)."""
    zero()
    request_ms, outs = [], []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        outs.append(server._classify(server._windows_from_frames(frames)))
        request_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read()
    for name, n in launches.items():
        if per_request is None:
            check(n > 0, f"kernel {name} was not launched on the serve path")
        else:
            check(n == SERVE_REQUESTS * per_request[name],
                  f"kernel {name}: {n} launches over {SERVE_REQUESTS} "
                  f"requests, expected {per_request[name]} per request")
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
    """Phase 5.  Returns (errs, times, bounds, device durations) keyed by
    kernel name; times and bounds are those at the finest serve level
    (224², 15 pairs).

    At every level the kernels get the sequence form's shapes (16 frames,
    15 pairs), which the serve path gives them.  At the native levels
    they also get the pair form's, as ``compute-flow --batch 8`` gives
    them for a 16-frame clip: chunks of 8 and 7 pairs, whose prologue
    runs over both sides of every pair (16 and 14 frames)."""
    import torch.nn as nn

    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import (
        _level_sizes, _resize_flow, farneback_sequence)
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    def three_launches(R0, R1, flow, taps):
        """One iteration as K-E and the two launches of K-F."""
        return fk.sep_corr(fk.sep_corr(fk.fb_warp_neq(R0, R1, flow), taps, 0),
                           taps, 1, solve=True)

    def two_launches(R0, R1, flow, taps):
        """One iteration as K-E and fb_window_solve: M reaches device
        memory once."""
        return fk.fb_window_solve(fk.fb_warp_neq(R0, R1, flow), taps)

    cfg = FarnebackConfig()
    n_poly = 2 * cfg.poly_n + 1
    tap_sets = {"box": farneback_window_taps(cfg.winsize, False),
                "gaussian": farneback_window_taps(cfg.winsize, True)}
    errs = {"fb_prologue": 0.0, "fb_warp_neq": 0.0, "sep_corr": 0.0,
            "sep_corr_x_solve": 0.0, "fb_window_solve": 0.0,
            "fb_iteration": 0.0}
    shapes = {}
    report, main_times, main_bounds, main_dev = {}, {}, {}, {}
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
            # Both passes and the solve in one launch: what the two launches
            # of K-F give, and the plain version; then with K-E as its loader.
            at = f"{tname} at {what}"
            two = fk.sep_corr(fk.sep_corr(M_ref, taps, 0), taps, 1, solve=True)
            got = fk.fb_window_solve(M_ref, taps)
            errs["fb_window_solve"] = max(
                errs["fb_window_solve"],
                diff(got, two, f"fb_window_solve vs two launches, {at}"),
                diff(got, fk.fb_window_solve_plain(M_ref, taps),
                     f"fb_window_solve {at}"))
            one = fk.fb_iteration(R0, R1, flow, taps)
            errs["fb_iteration"] = max(
                errs["fb_iteration"],
                diff(one, got, f"fb_iteration vs K-E + fb_window_solve, {at}"),
                diff(one, fk.fb_iteration_plain(R0, R1, flow, taps),
                     f"fb_iteration {at}"))

        # One whole level: 3 iterations, in single launches (the path) and
        # in two, against the plain versions.
        taps = tap_sets["box"]
        f_k = f_i = f_p = torch.zeros_like(flow)
        for _ in range(cfg.iterations):
            f_k = two_launches(R0, R1, f_k, taps)
            f_i = fk.fb_iteration(R0, R1, f_i, taps)
            f_p = fk.fb_iteration_plain(R0, R1, f_p, taps)
        level_err = max(level_err, diff(f_k, f_p, f"level at {what}"),
                        diff(f_i, f_p, f"level in single launches at {what}"))
        return args, R0, R1, flow, M_ref

    for H, W in ((224, 224), NATIVE):
        frames = torch.from_numpy(np.stack(
            [scene(np, t, H, W, seed=3, fmax=FB_FMAX)
             for t in range(FB_FRAMES)])).to(dev)
        B = FB_FRAMES - 1
        taps = tap_sets["box"]
        sizes = _level_sizes(H, W, cfg)
        for lh, lw, scale in sizes:
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
                                                             True)), None),
                "fb_window_solve": (
                    cuda_ms(torch, lambda: fk.fb_window_solve(M_ref, taps)),
                    cuda_ms(torch, lambda: fk.fb_window_solve_plain(M_ref,
                                                                    taps)),
                    None),
                "fb_iteration": (
                    cuda_ms(torch, lambda: fk.fb_iteration(R0, R1, flow,
                                                           taps)),
                    cuda_ms(torch, lambda: fk.fb_iteration_plain(
                        R0, R1, flow, taps)), None)}
            # The kernels' own durations, at the finest level of each pyramid.
            dev_ms = {}
            if (lh, lw) == (H, W):
                dev_ms = {
                    "fb_prologue": device_ms(
                        torch, lambda: fk.fb_prologue(*args),
                        "fb_prologue_kernel"),
                    "fb_warp_neq": device_ms(
                        torch, lambda: fk.fb_warp_neq(R0, R1, flow),
                        "fb_warp_neq_kernel"),
                    "sep_corr": device_ms(
                        torch, lambda: fk.sep_corr(M_ref, taps, 0),
                        "sep_corr_kernel"),
                    "sep_corr_x_solve": device_ms(
                        torch, lambda: fk.sep_corr(M_ref, taps, 1, True),
                        "sep_corr_kernel"),
                    "fb_window_solve": device_ms(
                        torch, lambda: fk.fb_window_solve(M_ref, taps),
                        "fb_window_solve_kernel"),
                    "fb_iteration": device_ms(
                        torch, lambda: fk.fb_iteration(R0, R1, flow, taps),
                        "fb_window_solve_kernel")}
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
                    (2 * len(taps) * 5 + 12) * B * lh * lw),
                # M read and the flow written; both passes and the solve.
                "fb_window_solve": bound(
                    7 * 4 * B * lh * lw,
                    (2 * 2 * len(taps) * 5 + 12) * B * lh * lw),
                # R0, R1 and the flow read, the flow written; K-E's
                # operations as well.
                "fb_iteration": bound(
                    14 * 4 * B * lh * lw,
                    (100 + 2 * 2 * len(taps) * 5 + 12) * B * lh * lw)}
            report[key] = {
                name: {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1],
                       **({"device_ms": dev_ms[name]} if dev_ms else {})}
                for name, t in times.items()}
            if (lh, lw) == (224, 224):
                main_times, main_bounds, main_dev = times, bounds, dev_ms

        seq = farneback_sequence(frames, cfg)
        seq_plain = farneback_sequence(frames, cfg, plain=True)
        epe = (seq - seq_plain).norm(dim=-1).max().item()
        check(epe <= TOL_FB, f"farneback_sequence at {H}x{W}: max EPE {epe}")
        seq_epe = max(seq_epe, epe)
        mean = seq[:, 16:-16, 16:-16].reshape(-1, 2).mean(0).tolist()
        check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
              and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
              f"farneback mean flow {mean} at {H}x{W}, expected {VEL}")
        # The same sequence with an iteration as three launches (K-E and K-F
        # twice), two (K-E and fb_window_solve) and one (fb_iteration: the
        # path): equal flows, timed in turns, forwards then back.
        variants = {"three_launches": three_launches,
                    "two_launches": two_launches,
                    "one_launch": fk.fb_iteration}

        def seq_with(iterate):
            """The pyramid loop of farneback_sequence with `iterate` as
            one iteration."""
            flow = torch.zeros((B, 2, *sizes[0][:2]), device=dev)
            for i, (lh, lw, scale) in enumerate(sizes):
                if i:
                    flow = _resize_flow(flow, (lh, lw), 1.0 / cfg.pyr_scale)
                R = fk.fb_prologue(frames, scale, (lh, lw), cfg.poly_n,
                                   cfg.poly_sigma)
                for _ in range(cfg.iterations):
                    flow = iterate(R[:-1], R[1:], flow, taps)
            return flow

        for name, iterate in variants.items():
            check(torch.equal(seq_with(iterate).permute(0, 2, 3, 1), seq),
                  f"farneback_sequence at {H}x{W} with {name} differs")
        seq_ms = {name: [] for name in variants}
        for name in list(variants) + list(reversed(variants)):
            seq_ms[name].append(cuda_ms(
                torch, lambda: seq_with(variants[name]), 5))
        report[f"sequence_{H}x{W}"] = {
            "mean_flow": mean,
            "ms": cuda_ms(torch, lambda: farneback_sequence(frames, cfg), 3),
            "ms_by_launches_per_iteration": seq_ms,
            "plain_ms": cuda_ms(
                torch, lambda: farneback_sequence(frames, cfg, plain=True), 3)}
    emit({"phase": "farneback_kernels", "frames": FB_FRAMES,
          "frames_and_pairs_checked": shapes, "max_abs_err": errs, "level_max_abs_err": level_err,
          "sequence_max_epe": seq_epe, "tolerance": TOL_FB,
          "by_level": report})
    return errs, main_times, main_bounds, main_dev


def farneback_serve_phase(torch, np, dev, model):
    """Phase 6.  Returns the launches of K-D, K-E, K-F over the requests."""
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
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
    fcfg = pcfg.farneback
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_fb_counts(fk),
        lambda: read_fb_counts(fk),
        fb_expected(len(_level_sizes(224, 224, fcfg)), fcfg.iterations))
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
    # and fb_iteration once per level and iteration.
    cfg = FarnebackConfig()
    calls = -(-(FB_FRAMES - 1) // CF_BATCH)
    expected = fb_expected(len(_level_sizes(H, W, cfg)), cfg.iterations, calls)
    check(launches == expected,
          f"compute-flow launched {launches}, expected {expected}")
    emit({"phase": "compute_flow", "files": len(files), "seconds": seconds,
          "read_back": files[7], "mean_flow": mean, "batch": CF_BATCH,
          "launches": launches})
    return launches


FB_HD_FRAMES = 3       # 2 pairs: one flow call of the command


def farneback_1080p_phase(torch, np, dev):
    """The Farneback command at 1080x1920 with parameters the reference
    takes and the first kernels did not: ``--fb-levels 4`` (the coarsest
    level, 68x120 at 1/16, pre-blurs with 39 taps, and K-D takes its
    two-launch form there) and ``--fb-winsize 33``, each with the launch
    counts set to 0 just before and held to the expected numbers just
    after, and every ``.flo`` file equal to the plain path's flow.  Then
    K-D against its plain version at 1/16 and 1/32 (39 and 79 taps), timed,
    and one iteration of each window route (33, 75 and 201 taps) against
    the plain version at the 1/8 level.  Returns (launches per kernel of
    the two commands, {"fb_prologue_blur": (max_abs_err, (ms, plain_ms,
    None), bound, device_ms)} at 1/16)."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import FarnebackConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes, farneback
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    from video_analytics_tpu_torch.ops.cuda import _build

    H, W = FULL_HD
    lib = _build.library()
    # The size rules' shared-memory counts are the library's own.
    for n in (15, 33, 73, 75, 193, 195, 201):
        for planes, neq in ((5, 1), (1, 0)):
            want = fk.window_smem(n, planes)
            check(lib.va_fb_window_smem(n, neq)
                  == (want if want <= 232448 else -1),
                  f"window_smem({n}, {planes}) is not the library's")
    planes = [scene(np, t, H, W, seed=9, fmax=FB_FMAX)
              for t in range(FB_HD_FRAMES)]
    frames = np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)], axis=-1)
                       for img in planes]).round().astype(np.uint8)
    report, total = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "frames")
        write_frames(frames, src)
        gray = rgb_to_gray(torch.from_numpy(_load_frames(src, None)).to(dev))
        for flag, value in (("--fb-levels", 4), ("--fb-winsize", 33)):
            cfg = FarnebackConfig(**{flag[5:]: value})
            levels = _level_sizes(H, W, cfg)
            forms = [fk.prologue_form(H, W, lh, lw, sc, cfg.poly_n)
                     for lh, lw, sc in levels]
            for (lh, lw, sc), (form, span) in zip(levels, forms):
                args = (len(fk._smooth_taps(sc)), 2 * cfg.poly_n + 1,
                        sc < 1 and lh != H, sc < 1 and lw != W)
                if form == "fused":
                    check(lib.va_fb_prologue_smem(*map(int, args), span)
                          == fk.prologue_smem(*args, span),
                          f"prologue_smem at {lh}x{lw} is not the library's")
            forms = [form for form, _ in forms]
            taps = [len(fk._smooth_taps(sc)) for _, _, sc in levels]
            out = os.path.join(tmp, f"flow{flag}")
            zero_fb_counts(fk)
            t0 = time.perf_counter()
            rc, res = run_cli(["compute-flow", src, out, "--algo",
                               "farneback", "--format", "flo", "--batch",
                               str(CF_BATCH), flag, str(value), "--device",
                               "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_fb_counts(fk)
            check(rc == 0 and res["flows"] == FB_HD_FRAMES - 1,
                  f"compute-flow --algo farneback {flag} {value}: {rc} {res}")
            route = fk.window_route(cfg.winsize)
            expected = fb_expected(len(levels), cfg.iterations,
                                   split=forms.count("split"), route=route)
            check(launches == expected,
                  f"compute-flow {flag} {value} launched {launches}, "
                  f"expected {expected}")
            total = launches if total is None else {
                k: total[k] + n for k, n in launches.items()}
            with torch.no_grad():
                plain = farneback(gray[:-1], gray[1:], cfg,
                                  plain=True).cpu().numpy()
            files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
            flows = [read_flo(os.path.join(out, f)) for f in files]
            check(len(flows) == FB_HD_FRAMES - 1
                  and all(np.array_equal(f, p) for f, p in zip(flows, plain)),
                  f"compute-flow {flag} {value}: the flow is not the plain "
                  f"path's")
            mean = flows[0][64:-64, 64:-64].reshape(-1, 2).mean(0).tolist()
            check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
                  and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
                  f"compute-flow {flag} {value}: mean flow {mean}")
            report[f"{flag} {value}"] = {
                "levels": [[lh, lw] for lh, lw, _ in levels],
                "blur_taps": taps, "prologue_forms": forms,
                "window_route": route, "seconds": seconds,
                "launches": launches, "mean_flow": mean,
                "equal_to_plain_path": True}
    check(max(report["--fb-levels 4"]["blur_taps"]) > 31,
          "no level of --fb-levels 4 pre-blurs with more than 31 taps")

    # K-D where a tile's reach passes a block: 39 and 79 taps.
    cfg = FarnebackConfig()
    table, kd = None, {}
    for scale in (1 / 16, 1 / 32):
        lh, lw = int(round(H * scale)), int(round(W * scale))
        args = (gray, scale, (lh, lw), cfg.poly_n, cfg.poly_sigma)
        n0 = fk.fb_prologue.launches_blur
        got = fk.fb_prologue(*args)
        check(fk.fb_prologue.launches_blur == n0 + 1,
              f"fb_prologue at 1/{round(1 / scale)}: one launch")
        want = fk.fb_prologue_plain(*args)
        e = (got - want).abs().max().item()
        check(torch.equal(got, want),
              f"fb_prologue at 1/{round(1 / scale)}: max abs {e}")
        nb = len(fk._smooth_taps(scale))
        N = gray.shape[0]
        # Bytes: the frames read, the intermediate (the blurred frame at
        # 2 rows and 2 columns per level pixel) written.  Operations: the
        # vertical blur at the sample rows over every column, then the
        # horizontal one at the sample points, a multiply and an add a tap.
        px, samples = N * 2 * lh * W, N * 4 * lh * lw
        b = bound(4 * N * H * W + 4 * samples, 2 * nb * (px + samples))
        times = (cuda_ms(torch, lambda: fk.fb_prologue(*args), 5),
                 cuda_ms(torch, lambda: fk.fb_prologue_plain(*args), 2))
        dev_ms = device_ms(torch, lambda: fk.fb_prologue(*args),
                           "fb_blur_sample_kernel", 3)
        kd[f"{lh}x{lw}"] = {"blur_taps": nb, "ms_both_launches": times[0],
                            "plain_ms": times[1],
                            "blur_pass_device_ms": dev_ms,
                            "blur_pass_bound_ms": b[0], "bound_by": b[1]}
        if table is None:
            table = (e, (times[0], times[1], None), b, dev_ms)

    # The three window routes at the 1/8 level, 2 pairs.
    lh, lw = int(round(H / 8)), int(round(W / 8))
    R = fk.fb_prologue_plain(gray, 1 / 8, (lh, lw), cfg.poly_n,
                             cfg.poly_sigma)
    R0, R1 = R[:-1].contiguous(), R[1:].contiguous()
    g = torch.Generator(dev).manual_seed(11)
    flow = 2.0 * torch.randn((R0.shape[0], 2, lh, lw), device=dev,
                             generator=g)
    routes = {}
    for n in (33, 75, 201):
        taps = [1.0 / n] * n
        zero_fb_counts(fk)
        got = fk.fb_iterate(R0, R1, flow, taps)
        counts = {k: v for k, v in read_fb_counts(fk).items() if v}
        route = fk.window_route(n)
        check(counts == {k: v for k, v in fb_expected(1, 1, route=route,
                                                      ).items()
                         if v and k != "fb_prologue"},
              f"window of {n} taps ({route}) launched {counts}")
        check(torch.equal(got, fk.fb_iteration_plain(R0, R1, flow, taps)),
              f"one iteration with {n} taps ({route}) is not the plain one")
        routes[n] = {"route": route, "launches": counts,
                     "ms": cuda_ms(torch, lambda: fk.fb_iterate(
                         R0, R1, flow, taps), 5)}
    emit({"phase": "farneback_1080p", "frames": FB_HD_FRAMES,
          "commands": report, "fb_prologue_two_launch_form": kd,
          "window_routes_at": [lh, lw], "window_routes": routes,
          "tolerance": TOL_FB})
    return total, {"fb_prologue_blur": table}


def tvl1_level_inputs(torch, np, dev, h, w, pairs):
    """(i0, i13, uv) of one TV-L1 level: `pairs` frame pairs of the moving
    scene, the second frame with its centred gradient, and a smooth start
    flow a few pixels off."""
    from video_analytics_tpu_torch.ops.kernels import centered_gradient

    i0 = torch.from_numpy(np.stack([scene(np, b, h, w, seed=b)
                                    for b in range(pairs)])).to(dev)
    i1 = torch.from_numpy(np.stack([scene(np, b + 1, h, w, seed=b)
                                    for b in range(pairs)])).to(dev)
    i1x, i1y = centered_gradient(i1)
    i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    uv = torch.from_numpy(np.stack([np.stack(
        [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
        for b in range(pairs)]).astype(np.float32)).to(dev)
    return i0, i13, uv


# Levels K-H is checked at beside the serve sizes: 150 rows make strips of
# 19 with a last one of 17; 17 rows make strips of 3, 3, 3, 3, 3, 2 and two
# empty ones; at 256² (the size before the crop) the constants do not fit
# in shared memory beside the state; 240×320 (UCF101's native size) and
# 280×300 fit no cluster of 8 and take 16 blocks (strips of 15 and 18).
RAGGED = ((150, 201), (17, 40), (256, 256), (240, 320), (280, 300))


def warp_bound(rounds, h, w, inner, median_k):
    """Bound of one K-H launch: prep, u and v read and u, v written once,
    against ~70 float operations per pixel and iteration plus, with the
    median, 113 compare-exchanges (a min and a max) on each of u and v per
    round, for the rounds each image of this run took."""
    px = h * w
    per_round = 70 * inner + (2 * 2 * 113 if median_k > 1 else 0)
    return bound(8 * 4 * px * len(rounds), per_round * px * sum(rounds))


def scale_bound(rounds, h, w, inner, median_k):
    """Bound of one ``tvl1_scale`` launch: I1, its gradients, I0, u and v
    read and u, v written once, against the warp's ~45 operations a pixel
    and warp, the solver's operations for the rounds each image ran in
    each warp (`rounds`: a list per image) and the scale-end median."""
    px = h * w
    med = 2 * 2 * 113 if median_k > 1 else 0
    ops = sum(45 * len(r) + (70 * inner + med) * sum(r) + med
              for r in rounds)
    return bound(8 * 4 * px * len(rounds), ops * px)


def tvl1_warp_kernel_phase(torch, np, dev):
    """K-H ``pd_solve_warp`` against ``pd_solve_plain``, ``tvl1_scale``
    (``pd_solve_scale``: all the warps of a scale in one launch) against the
    kernels it fuses and its plain version, and one warp of the serve path
    through the three designs.  Returns {name: (max_abs_err, (ms, plain_ms,
    None), bound, device_ms)} of one warp (K-H) and one scale
    (``tvl1_scale``) of 15 pairs at 224² with ``TVL1Config()``."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import (
        warp_prep, warp_prep_plain)

    cfg = TVL1Config()
    lib = _build.library()
    report, max_err, scale_err, table = {}, 0.0, 0.0, {}

    def chain_scale(i13, i0, uv, c):
        """One scale as the kernels ``tvl1_scale`` fuses: K-A and K-H per
        warp, then K-C."""
        for _ in range(c.warps):
            uv = ts.pd_solve_warp(warp_prep(i13, i0, uv), uv, c)
        if c.median_filtering > 1:
            uv = ts.median5(uv, c.median_filtering)
        return uv
    for h, w in [(s, s) for s in SIZES] + list(RAGGED):
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, h, w, PAIRS)
        prep = warp_prep_plain(i13, i0, uv)
        geom = ts.warp_geometry(h, w)
        check(geom is not None, f"{h}x{w} does not fit a cluster")
        rows, consts, smem, blocks = geom
        check(lib.va_pd_warp_smem(h, w) == smem
              and lib.va_pd_warp_consts_in_smem(h, w) == int(consts)
              and lib.va_pd_warp_cluster(h, w) == blocks,
              f"warp_geometry({h}, {w}) = {geom}, the library says "
              f"{lib.va_pd_warp_smem(h, w)} B, constants in shared memory "
              f"{lib.va_pd_warp_consts_in_smem(h, w)}, "
              f"{lib.va_pd_warp_cluster(h, w)} blocks")
        # cudaOccupancyMaxActiveClusters at both sizes where the strips fit
        # (a negative CUDA error where they do not).
        by_size = {cl: lib.va_pd_warp_max_clusters(h, w, PAIRS, cl)
                   for cl in (8, 16)}
        clusters = by_size[blocks]
        check(clusters >= 1, f"no cluster of {blocks} blocks of {h}x{w} can "
                             f"be resident: {clusters}")
        entry = {"strip_rows": rows, "constants_in_shared_memory": consts,
                 "smem_bytes": smem, "cluster_blocks": blocks,
                 "max_active_clusters": clusters,
                 "max_active_clusters_by_size": by_size}
        rounds = torch.zeros(PAIRS, dtype=torch.int32, device=dev)

        def held(c, what, exact):
            """K-H against the plain version under config c.  Returns
            whether the two are equal to the bit."""
            nonlocal max_err
            n = ts.pd_solve_warp.launches
            got = ts.pd_solve_warp(prep, uv, c, rounds)
            check(ts.pd_solve_warp.launches == n + 1, "launch not counted")
            want = ts.pd_solve_plain(prep, uv, c)
            e = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            # With the test engaged a round may flip at the threshold on
            # the order of the sum: the reference's bound for that.
            check(equal if exact else e <= 10 * c.epsilon,
                  f"pd_solve_warp at {h}x{w}, {what}: max abs {e}")
            max_err = max(max_err, e)
            return equal

        # epsilon = 0: no test can flip, every bit must agree.
        for k in (5, 3, 0):
            held(dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2,
                                     median_filtering=k),
                 f"epsilon 0, median {k}", True)
            check(bool((rounds == 2).all()), f"rounds {rounds.tolist()}")
        # The whole warp with the test engaged: on this scene to the bit at
        # the finest serve size, as the native-resolution kernel is held.
        entry["equal_with_epsilon"] = held(cfg, "TVL1Config()",
                                           (h, w) == (SIZES[0], SIZES[0]))
        entry["rounds"] = rounds.tolist()
        check(min(entry["rounds"]) >= 1 and max(entry["rounds"])
              <= cfg.outer_iterations, f"rounds {entry['rounds']}")
        b_ms, b_by = warp_bound(entry["rounds"], h, w, cfg.inner_iterations,
                                cfg.median_filtering)
        exact = dataclasses.replace(cfg, epsilon=0.0)
        entry.update(
            ms=cuda_ms(torch, lambda: ts.pd_solve_warp(prep, uv, cfg), 5),
            bound_ms=b_ms, bound_by=b_by,
            ms_epsilon_0=cuda_ms(
                torch, lambda: ts.pd_solve_warp(prep, uv, exact), 5),
            bound_ms_epsilon_0=warp_bound(
                [cfg.outer_iterations] * PAIRS, h, w, cfg.inner_iterations,
                cfg.median_filtering)[0])
        # A warp on which every image passes the test in round 1.
        loose = dataclasses.replace(cfg, epsilon=100.0)
        held(loose, "every image converged in round 1", True)
        check(bool((rounds == 1).all()), f"rounds {rounds.tolist()}")
        entry["ms_converged_in_round_1"] = cuda_ms(
            torch, lambda: ts.pd_solve_warp(prep, uv, loose), 5)
        if (h, w) == (SIZES[0], SIZES[0]):
            # The same warp through the three designs.
            band, chunk = ts.chunk_params(h, w, cfg)
            chain = ts.pd_solve(prep, uv, cfg)
            got = ts.pd_solve_warp(prep, uv, cfg)
            entry["max_abs_vs_chain"] = (got - chain).abs().max().item()
            check(entry["max_abs_vs_chain"] <= 10 * cfg.epsilon,
                  f"pd_solve_warp vs the chain: {entry['max_abs_vs_chain']}")
            entry.update(
                chain_ms=cuda_ms(torch, lambda: ts.pd_solve(prep, uv, cfg), 3),
                chunked_ms=cuda_ms(torch, lambda: ts.pd_solve_chunked(
                    prep, uv, cfg, band, chunk, False), 3),
                chunked_band_chunk=[band, chunk],
                plain_ms=cuda_ms(
                    torch, lambda: ts.pd_solve_plain(prep, uv, cfg), 1),
                launches={"pd_solve_warp": 1,
                          "chain": cfg.outer_iterations
                          * (cfg.inner_iterations + 2),
                          "chunked": cfg.outer_iterations
                          * -(-cfg.inner_iterations // chunk) + 9})
            table["tvl1_pd_warp"] = (
                None, (entry["ms"], entry["plain_ms"], None), (b_ms, b_by),
                device_ms(torch, lambda: ts.pd_solve_warp(prep, uv, cfg),
                          "pd_warp_kernel"))

        # tvl1_scale: every warp of the scale and the scale-end median in
        # one launch, against the chain K-A -> K-H per warp -> K-C and the
        # plain version.  epsilon = 0: every bit agrees with both.
        sc = {}
        srounds = torch.zeros((PAIRS, 2), dtype=torch.int32, device=dev)
        for k in (5, 3, 0):
            c = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2,
                                    warps=2, median_filtering=k)
            n = ts.pd_solve_scale.launches
            got = ts.pd_solve_scale(i13, i0, uv, c, srounds)
            check(ts.pd_solve_scale.launches == n + 1, "launch not counted")
            check(torch.equal(got, chain_scale(i13, i0, uv, c)),
                  f"tvl1_scale at {h}x{w}, epsilon 0, median {k}: not the "
                  f"chain's flow")
            want = ts.pd_solve_scale_plain(i13, i0, uv, c)
            e = (got - want).abs().max().item()
            check(torch.equal(got, want),
                  f"tvl1_scale at {h}x{w}, epsilon 0, median {k}: max abs "
                  f"{e} from the plain version")
            check(bool((srounds == 2).all()), f"rounds {srounds.tolist()}")
        # One warp: K-A, K-H and K-C in one launch.
        one = dataclasses.replace(cfg, warps=1)
        check(torch.equal(ts.pd_solve_scale(i13, i0, uv, one),
                          chain_scale(i13, i0, uv, one)),
              f"tvl1_scale of one warp at {h}x{w} is not K-A, K-H, K-C")
        # With the test engaged: the chain's flow to the bit (same strips,
        # same order of the sums); against the plain version a round may
        # flip at the threshold in any of the warps.
        srounds = torch.zeros((PAIRS, cfg.warps), dtype=torch.int32,
                              device=dev)
        got = ts.pd_solve_scale(i13, i0, uv, cfg, srounds)
        chain = chain_scale(i13, i0, uv, cfg)
        check(torch.equal(got, chain),
              f"tvl1_scale at {h}x{w}, TVL1Config(): max abs "
              f"{(got - chain).abs().max().item()} from the chain")
        want = ts.pd_solve_scale_plain(i13, i0, uv, cfg)
        e = (got - want).abs().max().item()
        sc["equal_to_plain_with_epsilon"] = torch.equal(got, want)
        check(sc["equal_to_plain_with_epsilon"]
              if (h, w) == (SIZES[0], SIZES[0])
              else e <= 10 * cfg.epsilon * cfg.warps,
              f"tvl1_scale at {h}x{w}, TVL1Config(): max abs {e} from the "
              f"plain version")
        scale_err = max(scale_err, e)
        sc["rounds"] = srounds.tolist()
        sb_ms, sb_by = scale_bound(sc["rounds"], h, w, cfg.inner_iterations,
                                   cfg.median_filtering)
        # In turns: the launch, the chain, the chain, the launch.
        t = [cuda_ms(torch, f, 3) for f in (
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg),
            lambda: chain_scale(i13, i0, uv, cfg),
            lambda: chain_scale(i13, i0, uv, cfg),
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg))]
        sc.update(ms=min(t[0], t[3]), ms_both=[t[0], t[3]],
                  chain_ms=min(t[1], t[2]), chain_ms_both=[t[1], t[2]],
                  chain_launches=2 * cfg.warps + 1, bound_ms=sb_ms,
                  bound_by=sb_by,
                  ms_one_warp=cuda_ms(
                      torch, lambda: ts.pd_solve_scale(i13, i0, uv, one), 5),
                  ms_one_warp_three_launches=cuda_ms(
                      torch, lambda: chain_scale(i13, i0, uv, one), 5))
        if (h, w) == (SIZES[0], SIZES[0]):
            sc["plain_ms"] = cuda_ms(
                torch, lambda: ts.pd_solve_scale_plain(i13, i0, uv, cfg), 1)
            sc["device_ms"] = device_ms(
                torch, lambda: ts.pd_solve_scale(i13, i0, uv, cfg),
                "pd_warp_kernel", 3)
            table["tvl1_scale"] = (None, (sc["ms"], sc["plain_ms"], None),
                                   (sb_ms, sb_by), sc["device_ms"])
        entry["tvl1_scale"] = sc
        report[f"{h}x{w}"] = entry

    # One image and three windows' worth (more clusters than the card holds
    # at once), and a level that fits no cluster.
    for B in (1, 45):
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, SIZES[0], SIZES[0], B)
        prep = warp_prep_plain(i13, i0, uv)
        short = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=1,
                                    warps=2)
        check(torch.equal(ts.pd_solve_warp(prep, uv, short),
                          ts.pd_solve_plain(prep, uv, short)),
              f"pd_solve_warp at batch {B}")
        # The whole-scale launch at the batch classify-clip --windows 3
        # gives it.
        got = ts.pd_solve_scale(i13, i0, uv, short)
        check(torch.equal(got, chain_scale(i13, i0, uv, short)),
              f"tvl1_scale at batch {B}: not the chain's flow")
        check(torch.equal(got, ts.pd_solve_scale_plain(i13, i0, uv, short)),
              f"tvl1_scale at batch {B}: not the plain version's flow")
    check(ts.warp_geometry(*CHAIN) is None
          and lib.va_pd_warp_smem(*CHAIN) < 0
          and lib.va_pd_warp_cluster(*CHAIN) < 0, f"{CHAIN} fits a cluster?")
    emit({"phase": "tvl1_warp_kernel", "pairs": PAIRS,
          "max_abs_err": max_err, "tolerance": 0.0,
          "tolerance_where_a_round_may_flip": 10 * cfg.epsilon,
          "tvl1_scale_max_abs_err": scale_err,
          "tvl1_scale_equal_to_chain": True,
          "by_level": report})
    return {"tvl1_pd_warp": (max_err, *table["tvl1_pd_warp"][1:]),
            "tvl1_scale": (scale_err, *table["tvl1_scale"][1:])}


# Finest levels under the size rule that fit no cluster of 8 blocks (PR 5's
# per-iteration chain) and fit one of 16: every level takes tvl1_scale.
MIDS = ((280, 300), (240, 320))
MID_FRAMES = 3
CHAIN = (20, 4000)     # a level too wide for 16 strips: K-A, K-B, ε, K-C


def tvl1_midsize_phase(torch, np, dev):
    """``compute-flow --algo tvl1`` on frames of 280x300 and of 240x320:
    every level, the finest in 16-block clusters, is one launch of
    ``tvl1_scale`` (counted, and K-A, K-B, the ε reduction, K-C and K-H
    held to 0); the flow at ε = 0 against the plain path's; one flow call
    of 2 pairs timed.  Then a pair of 20x4000, whose finest level fits no
    cluster, through ``tvl1``: K-A, K-B, the ε reduction and K-C on it
    (counted) and the flow at ε = 0 against the plain path's.  Returns
    (launches per kernel of the commands, launches of the 20x4000 pair)."""
    import tempfile

    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import (
        _level_sizes, level_solver, tvl1)
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    cfg = TVL1Config()
    kernels = {"tvl1_pd_step": ts.pd_step, "tvl1_eps_reduce": ts.eps_reduce,
               "median5": ts.median5, "warp_prep": warp_prep,
               "tvl1_scale": ts.pd_solve_scale,
               "tvl1_pd_warp": ts.pd_solve_warp, "tvl1_pd_chunk": ts.pd_chunk}
    exact = dataclasses.replace(cfg, epsilon=0.0, warps=2, outer_iterations=2)
    report, total = {}, dict.fromkeys(kernels, 0)
    for size in MIDS:
        sizes = _level_sizes(*size, cfg)
        takes = [level_solver(h, w, cfg.median_filtering) for h, w in sizes]
        check(takes == ["warp"] * len(sizes)
              and ts.warp_geometry(*size)[3] == 16,
              f"levels of {size} take {takes}")
        planes = [scene(np, t, *size, seed=7) for t in range(MID_FRAMES)]
        frames = np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)],
                                    axis=-1)
                           for img in planes]).round().astype(np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            src, out = os.path.join(tmp, "frames"), os.path.join(tmp, "flow")
            write_frames(frames, src)
            zero_counts(kernels)
            t0 = time.perf_counter()
            rc, res = run_cli(["compute-flow", src, out, "--algo", "tvl1",
                               "--format", "flo", "--batch", str(CF_BATCH),
                               "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts(kernels)
            check(rc == 0 and res["flows"] == MID_FRAMES - 1,
                  f"compute-flow --algo tvl1 at {size} exited {rc}: {res}")
            # The same command again: what a second clip of the size pays.
            t0 = time.perf_counter()
            rc, _ = run_cli(["compute-flow", src, out + "_again", "--algo",
                             "tvl1", "--format", "flo", "--batch",
                             str(CF_BATCH), "--device", "cuda"])
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
            check(rc == 0, f"compute-flow at {size}, again: {rc}")
            flow = read_flo(os.path.join(out, sorted(os.listdir(out))[0]))
            gray = rgb_to_gray(torch.from_numpy(_load_frames(src, 3)).to(dev))
        expected = {**dict.fromkeys(kernels, 0), "tvl1_scale": len(sizes)}
        check(launches == expected,
              f"compute-flow at {size} launched {launches}, expected "
              f"{expected}")
        for name, n in launches.items():
            total[name] += n
        check(flow.shape == (*size, 2) and bool(np.isfinite(flow).all()),
              f"flow read back: {flow.shape}")
        mean = flow[32:-32, 32:-32].reshape(-1, 2).mean(0).tolist()
        check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
              and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
              f"mean flow {mean} at {size}, expected {VEL}")
        # With no test to flip, at a smaller depth, the pyramid through
        # tvl1_scale is the plain path's to the bit.
        with torch.no_grad():
            e = float((tvl1(gray[:2], gray[1:3], exact)
                       - tvl1(gray[:2], gray[1:3], exact, plain=True)
                       ).abs().max())
            check(e == 0.0, f"flow at {size}, epsilon 0, vs the plain path: "
                            f"{e}")
            call_ms = cuda_ms(torch, lambda: tvl1(gray[:2], gray[1:3], cfg),
                              3)
        # The finest level alone, 2 pairs: the launch against the route it
        # replaces (per warp K-A and the per-iteration chain, then K-C), in
        # turns.
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, *size, 2)

        def old_route():
            u = uv
            for _ in range(cfg.warps):
                u = ts.pd_solve(warp_prep(i13, i0, u), u, cfg)
            return ts.median5(u, cfg.median_filtering)

        t = [cuda_ms(torch, f, 3) for f in (
            lambda: ts.pd_solve_scale(i13, i0, uv, cfg), old_route,
            old_route, lambda: ts.pd_solve_scale(i13, i0, uv, cfg))]
        report[f"{size[0]}x{size[1]}"] = {
            "levels_take": takes, "command_seconds": seconds,
            "command_seconds_again": again,
            "launches": launches, "mean_flow": mean,
            "max_abs_vs_plain_path_at_epsilon_0": e,
            "flow_call_pairs": 2, "flow_call_ms": call_ms,
            "finest_level_ms": [t[0], t[3]],
            "finest_level_ms_per_iteration_route": [t[1], t[2]]}

    # A level no cluster holds keeps the per-iteration chain.
    h, w = CHAIN
    chain_cfg = dataclasses.replace(exact, warps=1)
    sizes = _level_sizes(h, w, chain_cfg)
    takes = [level_solver(a, b, cfg.median_filtering) for a, b in sizes]
    check(takes == ["chain", "warp"], f"levels of {CHAIN} take {takes}")
    with torch.no_grad():
        prev = torch.from_numpy(scene(np, 0, h, w, seed=8)[None]).to(dev)
        nxt = torch.from_numpy(scene(np, 1, h, w, seed=8)[None]).to(dev)
        zero_counts(kernels)
        got = tvl1(prev, nxt, chain_cfg)
        chain = read_counts(kernels)
        e_chain = float((got - tvl1(prev, nxt, chain_cfg, plain=True)
                         ).abs().max())
    rounds = chain_cfg.warps * chain_cfg.outer_iterations
    expected = {**dict.fromkeys(kernels, 0), "warp_prep": chain_cfg.warps,
                "tvl1_pd_step": rounds * chain_cfg.inner_iterations,
                "tvl1_eps_reduce": rounds, "median5": rounds + 1,
                "tvl1_scale": 1}
    check(chain == expected,
          f"tvl1 at {CHAIN} launched {chain}, expected {expected}")
    check(e_chain == 0.0, f"flow at {CHAIN}, epsilon 0, vs the plain path: "
                          f"{e_chain}")
    emit({"phase": "tvl1_midsize", "by_size": report,
          "chain_level": {"size": list(CHAIN), "levels_take": takes,
                          "launches": chain,
                          "max_abs_vs_plain_path_at_epsilon_0": e_chain}})
    return total, chain


FULL_HD = (1080, 1920)     # a native-resolution frame: every TV-L1 level
                           # of it is above the whole-plane size rule
HD_PAIRS = 2               # pairs per flow call in the K-G checks
TOL_CHUNK_ERR = 1e-5       # K-G band sums, relative (their order differs)


def chunk_bound(B, h, w, iters, median_k):
    """Bound of one K-G launch: 10 planes read and 6 written once, against
    ~70 float operations per pixel and iteration plus, with the median,
    113 compare-exchanges (a min and a max) on each of u and v."""
    px = B * h * w
    return bound(16 * 4 * px,
                 (70 * iters + (2 * 2 * 113 if median_k > 1 else 0)) * px)


def tvl1_chunk_kernels_phase(torch, np, dev, sweep: bool):
    """K-G ``pd_chunk`` against its plain version at the five level sizes
    of a 1080x1920 frame, ``band_flags`` against its plain version, and
    ``pd_solve_chunked`` against the per-iteration ``pd_solve``.  Returns
    {name: (max_abs_err, (ms, plain_ms, None), bound, device_ms)} for K-G
    (a full chunk) and ``band_flags`` at 1080x1920."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import (
        _level_sizes, whole_plane_level)
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep_plain
    from video_analytics_tpu_torch.ops.kernels import centered_gradient

    cfg = TVL1Config()
    K, k = cfg.inner_iterations, cfg.median_filtering
    report, max_err, max_sum_err = {}, 0.0, 0.0
    table = {}
    for h, w in _level_sizes(*FULL_HD, cfg):
        check(not whole_plane_level(h, w, k), f"{h}x{w} is a whole-plane level")
        band, chunk = ts.chunk_params(h, w, cfg)
        tile, halo = ts.chunk_tile(chunk, cfg)
        n_bands = -(-h // band)
        i0 = torch.from_numpy(np.stack([scene(np, b, h, w, seed=b)
                                        for b in range(HD_PAIRS)])).to(dev)
        i1 = torch.from_numpy(np.stack([scene(np, b + 1, h, w, seed=b)
                                        for b in range(HD_PAIRS)])).to(dev)
        i1x, i1y = centered_gradient(i1)
        i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        uv = torch.from_numpy(np.stack([np.stack(
            [2.5 * np.sin(6 * yy + b), -2.0 * np.cos(5 * xx - b)])
            for b in range(HD_PAIRS)]).astype(np.float32)).to(dev)
        prep = warp_prep_plain(i13, i0, uv)
        on = torch.ones((HD_PAIRS, n_bands), dtype=torch.int32, device=dev)
        # A state with live dual variables: two iterations from p = 0.
        state, _ = ts.pd_chunk_plain(
            prep, torch.cat([uv, torch.zeros((HD_PAIRS, 4, h, w), device=dev)],
                            dim=1), on, cfg, 2, band, False)
        act = on.clone()
        act[0, 1::2] = 0                      # some bands frozen
        act[1, :1] = 0
        out = torch.empty_like(state)
        partial = torch.empty(
            (HD_PAIRS, n_bands, ts.chunk_partials(h, w, band, tile)),
            device=dev)
        rest = K % chunk or chunk
        for iters in sorted({chunk, rest}):
            for do_median in (True, False):
                for flags in (on, act):
                    out.fill_(float("nan"))
                    partial.fill_(float("nan"))
                    ts.pd_chunk(prep, state, flags, cfg, iters, band, tile,
                                halo, do_median, out, partial)
                    err = partial.sum(dim=2)
                    want, want_err = ts.pd_chunk_plain(
                        prep, state, flags, cfg, iters, band, do_median)
                    e = (out - want).abs().max().item()
                    what = (f"pd_chunk at {h}x{w}, {iters} iterations, "
                            f"median {do_median}")
                    check(torch.equal(out, want), f"{what}: max abs {e}")
                    rel = ((err - want_err).abs()
                           / want_err.abs().clamp(min=1e-30)).max().item()
                    check(rel <= TOL_CHUNK_ERR,
                          f"{what}: band sums differ by {rel} relative")
                    max_err, max_sum_err = max(max_err, e), max(max_sum_err,
                                                                rel)
        # A band frozen in two launches running is left alone the second
        # time: `out` holds the first launch's copy of it.
        ts.pd_chunk(prep, state, act, cfg, chunk, band, tile, halo, False,
                    out, partial)
        want, _ = ts.pd_chunk_plain(prep, state, act, cfg, chunk, band, False)
        ts.pd_chunk(prep, state, act, cfg, chunk, band, tile, halo, False,
                    out, partial, act)
        check(torch.equal(out, want),
              f"pd_chunk at {h}x{w} with prev_act: the frozen rows moved")
        off = torch.zeros_like(on)
        times = {
            "ms": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, False, out)),
            "ms_with_median": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, True, out)),
            "ms_with_error_sums": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, on, cfg, chunk, band, tile, halo, False, out,
                partial)),
            "ms_all_frozen": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, off, cfg, chunk, band, tile, halo, False, out)),
            "ms_all_frozen_before_too": cuda_ms(torch, lambda: ts.pd_chunk(
                prep, state, off, cfg, chunk, band, tile, halo, False, out,
                None, off)),
            "plain_ms": cuda_ms(torch, lambda: ts.pd_chunk_plain(
                prep, state, on, cfg, chunk, band, False), 3)}
        b_ms, b_by = chunk_bound(HD_PAIRS, h, w, chunk, 0)
        bm_ms, _ = chunk_bound(HD_PAIRS, h, w, chunk, k)
        report[f"{h}x{w}"] = {"band": band, "chunk": chunk, "tile": tile,
                              "halo": halo, **times, "bound_ms": b_ms,
                              "bound_by": b_by,
                              "bound_ms_with_median": bm_ms}
        # band_flags: sums near the two thresholds, some bands not run.
        gen = torch.Generator(dev).manual_seed(h)
        eps2 = cfg.epsilon ** 2
        n_part = partial.shape[2]
        sums = (torch.rand(partial.shape, device=dev, generator=gen)
                * (2 * eps2 * band * w / n_part))
        sums[0] *= 0.5
        kept = torch.rand((HD_PAIRS, n_bands), device=dev, generator=gen)
        flag_err = 0.0
        for adaptive in (True, False):
            errs = [(kept * 2 * eps2 * band * w).clone() for _ in range(2)]
            nxt = [torch.full_like(act, -1) for _ in range(2)]
            ts.band_flags(sums, act, errs[0], nxt[0], band, h, w,
                          cfg.epsilon, adaptive)
            ts.band_flags_plain(sums, act, errs[1], nxt[1], band, h, w,
                                cfg.epsilon, adaptive)
            rel = ((errs[0] - errs[1]).abs() / errs[1].abs()).max().item()
            check(rel <= TOL_CHUNK_ERR and torch.equal(nxt[0], nxt[1]),
                  f"band_flags at {h}x{w}, adaptive {adaptive}: sums differ "
                  f"by {rel} relative, flags {nxt[0].tolist()} vs "
                  f"{nxt[1].tolist()}")
            flag_err = max(flag_err, (errs[0] - errs[1]).abs().max().item())
        times["band_flags_ms"] = cuda_ms(torch, lambda: ts.band_flags(
            sums, on, errs[0], nxt[0], band, h, w, cfg.epsilon, True))
        times["band_flags_plain_ms"] = cuda_ms(
            torch, lambda: ts.band_flags_plain(
                sums, on, errs[1], nxt[1], band, h, w, cfg.epsilon, True))
        if (h, w) == FULL_HD:
            table["tvl1_pd_chunk"] = (
                max_err, (times["ms"], times["plain_ms"], None), (b_ms, b_by),
                device_ms(torch, lambda: ts.pd_chunk(
                    prep, state, on, cfg, chunk, band, tile, halo, False,
                    out), "pd_chunk_kernel"))
            # Read: the partials, the flags, the errors; written: errors and
            # flags.  One add per partial.
            table["tvl1_band_flags"] = (
                flag_err, (times["band_flags_ms"],
                           times["band_flags_plain_ms"], None),
                bound(4 * sums.numel() + 16 * act.numel(), sums.numel()),
                device_ms(torch, lambda: ts.band_flags(
                    sums, on, errs[0], nxt[0], band, h, w, cfg.epsilon, True),
                    "band_flags_kernel"))
            # One whole warp, both solvers.  At epsilon = 0 no flag clears
            # and the tiling cannot show: bit for bit.
            exact = dataclasses.replace(cfg, epsilon=0.0, outer_iterations=2)
            got = ts.pd_solve_chunked(prep, uv, exact, band, chunk, False)
            chain = ts.pd_solve(prep, uv, exact)
            check(torch.equal(got, chain),
                  "pd_solve_chunked(adaptive=False) != pd_solve at epsilon 0: "
                  f"{(got - chain).abs().max().item()}")
            check(torch.equal(got, ts.pd_solve_chunked(prep, uv, exact, band,
                                                       chunk, True)),
                  "adaptive differs from non-adaptive with no band converged")
            # With the default epsilon the gates decide: the sums' order may
            # flip a round, so the bound is the reference's 10 * epsilon.
            got = ts.pd_solve_chunked(prep, uv, cfg, band, chunk, False)
            chain = ts.pd_solve(prep, uv, cfg)
            gated = (got - chain).abs().max().item()
            check(gated <= 10 * cfg.epsilon,
                  f"pd_solve_chunked vs pd_solve, gated: {gated}")
            adaptive = ts.pd_solve_chunked(prep, uv, cfg, band, chunk, True)
            a_dev = (adaptive - chain).abs().max().item()
            check(a_dev <= 10 * cfg.epsilon,
                  f"adaptive pd_solve_chunked vs pd_solve: {a_dev}")
            report["one_warp_1080x1920"] = {
                "pairs": HD_PAIRS,
                "gated_max_abs_vs_chain": gated,
                "adaptive_max_abs_vs_chain": a_dev,
                "chunked_adaptive_ms": cuda_ms(
                    torch, lambda: ts.pd_solve_chunked(prep, uv, cfg, band,
                                                       chunk, True), 2),
                "chunked_ms": cuda_ms(
                    torch, lambda: ts.pd_solve_chunked(prep, uv, cfg, band,
                                                       chunk, False), 2),
                "chain_ms": cuda_ms(
                    torch, lambda: ts.pd_solve(prep, uv, cfg), 2),
                "launches_chunked": cfg.outer_iterations * -(-K // chunk)
                + cfg.outer_iterations - 1,
                "launches_chain": cfg.outer_iterations * (K + 2)}
            if sweep:
                sw = {}
                for c in (2, 3, 4, 5, 6, 8, 10, 15):
                    t, _ = ts.chunk_tile(c, cfg)
                    sw[c] = {"tile": t, "ms": cuda_ms(
                        torch, lambda: ts.pd_solve_chunked(
                            prep, uv, cfg, _TILE_ROWS * t, c, False), 2)}
                report["chunk_sweep_1080x1920"] = sw
    emit({"phase": "tvl1_chunk_kernels", "pairs": HD_PAIRS,
          "state_max_abs_err": max_err, "state_bit_exact": True,
          "band_sum_max_rel_err": max_sum_err, "tolerance": TOL_CHUNK_ERR,
          "by_level": report})
    return table


_TILE_ROWS = 4     # tile rows per gating band in the chunk sweep

HD_FRAMES = 11             # 10 pairs: one stack of the flow stream's fields
CLIP_FRAMES = 24           # the classify-clip phase's 1080p clip
CLIP_WINDOWS = 3


def hd_frames(np, n: int, seed: int):
    """n RGB frames of 1080x1920, uint8: one texture translating by VEL
    pixels per frame, its three channels at different gains."""
    planes = [scene(np, t, *FULL_HD, seed=seed) for t in range(n)]
    return np.stack([np.stack([g * img for g in (1.0, 0.85, 0.7)], axis=-1)
                     for img in planes]).round().astype(np.uint8)


def run_cli(argv):
    """The port's command line in this process.  Returns (exit code, the
    JSON object of its last output line or None)."""
    import contextlib
    import io

    from video_analytics_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def tvl1_1080p_phase(torch, np, dev, work: str):
    """``compute-flow --algo tvl1`` with ``TVL1Config()`` on a frames
    directory of 1080x1920 frames under `work`, with the launch counts of
    the TV-L1 kernels set to 0 just before the command and held to the
    expected numbers just after; the first pair's flow against the plain
    path's.  Returns (launches per kernel, frames directory, flow
    directory)."""
    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import _level_sizes, tvl1
    from video_analytics_tpu_torch.io.flowio import read_flo
    from video_analytics_tpu_torch.io.video import write_frames
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.ops.preprocess import rgb_to_gray

    cfg = TVL1Config()
    src, out = os.path.join(work, "frames_1080p"), os.path.join(work,
                                                                "flow_1080p")
    write_frames(hd_frames(np, HD_FRAMES, seed=5), src)
    kernels = {"tvl1_pd_chunk": ts.pd_chunk, "tvl1_band_flags": ts.band_flags,
               "warp_prep": warp_prep, "median5": ts.median5,
               "tvl1_pd_step": ts.pd_step, "tvl1_eps_reduce": ts.eps_reduce,
               "tvl1_pd_warp": ts.pd_solve_warp,
               "tvl1_scale": ts.pd_solve_scale}
    zero_counts(kernels)
    t0 = time.perf_counter()
    rc, res = run_cli(["compute-flow", src, out, "--algo", "tvl1", "--format",
                       "flo", "--batch", str(CF_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0 and res["flows"] == HD_FRAMES - 1,
          f"compute-flow --algo tvl1 exited {rc}: {res}")

    # Each flow call of --batch pairs runs, per level, `warps` times one
    # warp_prep and one chunked solve (outer_iterations rounds of
    # ceil(K / chunk) launches, with one of band_flags between rounds), then
    # the scale-end median.  Every level of a 1080x1920 frame is above the
    # size rule: neither the per-iteration kernels nor the cluster solver
    # are launched at all.
    calls = -(-(HD_FRAMES - 1) // CF_BATCH)
    levels = _level_sizes(*FULL_HD, cfg)
    per_call = sum(
        cfg.warps * cfg.outer_iterations
        * -(-cfg.inner_iterations // ts.chunk_params(h, w, cfg)[1])
        for h, w in levels)
    expected = {"tvl1_pd_chunk": calls * per_call,
                "tvl1_band_flags": calls * len(levels) * cfg.warps
                * (cfg.outer_iterations - 1),
                "warp_prep": calls * len(levels) * cfg.warps,
                "median5": calls * len(levels), "tvl1_pd_step": 0,
                "tvl1_eps_reduce": 0, "tvl1_pd_warp": 0, "tvl1_scale": 0}
    check(launches == expected,
          f"compute-flow --algo tvl1 launched {launches}, expected {expected}")
    files = sorted(f for f in os.listdir(out) if f.endswith(".flo"))
    check(len(files) == HD_FRAMES - 1, f"{len(files)} .flo files")
    flow = read_flo(os.path.join(out, files[0]))
    check(flow.shape == (*FULL_HD, 2) and bool(np.isfinite(flow).all()),
          f"flow read back: {flow.shape}")
    mean = flow[64:-64, 64:-64].reshape(-1, 2).mean(0).tolist()
    check(abs(mean[0] - VEL[0]) < TOL_MEAN_FLOW
          and abs(mean[1] - VEL[1]) < TOL_MEAN_FLOW,
          f"1080p TV-L1 mean flow {mean}, expected {VEL}")

    # The same pair through the plain versions, from the same decoded
    # frames.  The kernels' states are bit-equal to the plain versions'; a
    # band's error sum is taken in another order and can flip a flag at the
    # threshold, which moves the flow by less than the reference's bound
    # for a skipped round, 10 * epsilon.
    with torch.no_grad():
        gray = rgb_to_gray(torch.from_numpy(_load_frames(src, 3)).to(dev))
        plain = tvl1(gray[:1], gray[1:2], cfg, plain=True)[0].cpu().numpy()
        dev_abs = float(np.abs(flow - plain).max())
        check(dev_abs <= 10 * cfg.epsilon,
              f"1080p flow vs the plain path: max abs {dev_abs}")
        # With no gate to flip (epsilon = 0, at a smaller depth) the whole
        # pyramid is the plain path's to the bit.
        exact = dataclasses.replace(cfg, epsilon=0.0, warps=2,
                                    outer_iterations=2)
        e_exact = float((tvl1(gray[:1], gray[1:2], exact)
                         - tvl1(gray[:1], gray[1:2], exact, plain=True)
                         ).abs().max())
        check(e_exact == 0.0,
              f"1080p flow at epsilon 0 vs the plain path: {e_exact}")

        def flow_call():
            return tvl1(gray[:2], gray[1:3], cfg)

        def chain_call():
            return tvl1(gray[:2], gray[1:3], cfg,
                        whole_plane=lambda h, w, k: True)

        chain_dev = float((flow_call() - chain_call()).abs().max())
        check(chain_dev <= 10 * cfg.epsilon,
              f"1080p flow, chunked vs per-iteration path: {chain_dev}")
        call_ms = cuda_ms(torch, flow_call, 2)
        chain_ms = cuda_ms(torch, chain_call, 2)
        prof = device_profile(torch, flow_call)
    emit({"phase": "tvl1_1080p", "frames": HD_FRAMES, "batch": CF_BATCH,
          "command_seconds": seconds,
          "command_seconds_per_pair": seconds / (HD_FRAMES - 1),
          "launches": launches, "mean_flow": mean,
          "max_abs_vs_plain_path": dev_abs,
          "bit_equal_to_plain_path": bool(np.array_equal(flow, plain)),
          "tolerance": 10 * cfg.epsilon,
          "max_abs_vs_plain_path_at_epsilon_0": e_exact,
          "flow_call_pairs": 2, "flow_call_ms": call_ms,
          "flow_call_ms_per_pair": call_ms / 2,
          "flow_call_ms_per_iteration_path": chain_ms,
          "max_abs_vs_per_iteration_path": chain_dev,
          "busy_share_of_unprofiled": prof["device_busy_ms"] / call_ms,
          "profile": prof})
    return launches, src, out


def stage_chain_phase(torch, np, dev, work: str, frames_dir: str,
                      flow_dir: str):
    """A checkpoint written from seed 0, then ``extract-features`` on the
    stored flow and on the frames of the phase before, and ``classify-clip
    --checkpoint`` on a 1080p clip, each at full width and held against
    the same steps taken on tensors with the kernels' plain versions."""
    from video_analytics_tpu_torch.cli.main import _load_frames
    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.io.flowio import read_flow_dir
    from video_analytics_tpu_torch.io.video import synthesize_video
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.runtime import pipeline
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    from video_analytics_tpu_torch.runtime.evaluate import classify_clip_file

    cfg = PipelineConfig()
    pre = cfg.preprocess

    def make():
        return TwoStreamModel.create(num_classes=cfg.num_classes,
                                     flow_stack=pre.flow_stack, width=64)

    ckpt = os.path.join(work, "two_stream.msgpack")
    written = make().init(torch.Generator().manual_seed(0))
    save_variables(ckpt, written.flax_variables())
    model = make()
    model.load_flax_variables(load_variables(ckpt, model.flax_variables()))
    for k, v in written.state_dict().items():
        check(torch.equal(model.state_dict()[k], v),
              f"checkpoint round trip changed {k}")
    model = model.to(dev).eval()
    dim = model.temporal.feature_dim

    def close(got, want, what):
        e = float(np.abs(got - want).max())
        check(got.shape == want.shape and bool(np.isfinite(got).all())
              and e <= TOL_PROBS * max(1.0, float(np.abs(want).max())),
              f"{what}: max abs {e}")
        return e

    # 1. The stored flow of compute-flow: resize, per-axis rescale, crop.
    out1 = os.path.join(work, "features_flow.npz")
    rc, res = run_cli(["extract-features", flow_dir, out1, "--stream", "flow",
                       "--checkpoint", ckpt, "--device", "cuda"])
    check(rc == 0 and res.get("source") == "flow_dir"
          and res["flow"] == [1, dim], f"extract-features (flow dir): {res}")
    with torch.no_grad():
        f = torch.from_numpy(read_flow_dir(flow_dir)).to(dev)
        h, w = f.shape[1], f.shape[2]
        f = pp.resize_short_side(f, pre.resize_short)
        f = f * torch.tensor([f.shape[2] / w, f.shape[1] / h], device=dev)
        f = pp.center_crop(f, pre.crop)
        want = model.temporal(pp.stacked_flow_input(
            f, pre.flow_stack, pre.flow_bound), return_features=True)
    e_stored = close(np.load(out1)["flow"], want.cpu().numpy(),
                     "flow features of the stored flow")

    # 2. The frames: both streams, TV-L1 on the 224² crop (every level
    # there fits a cluster: tvl1_scale, and nothing else).
    kernels = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
               "tvl1_pd_warp": ts.pd_solve_warp,
               "median5": ts.median5, "tvl1_pd_step": ts.pd_step,
               "tvl1_eps_reduce": ts.eps_reduce,
               "tvl1_pd_chunk": ts.pd_chunk}
    out2 = os.path.join(work, "features_frames.npz")
    zero_counts(kernels)
    rc, res = run_cli(["extract-features", frames_dir, out2, "--stream",
                       "both", "--algo", "tvl1", "--checkpoint", ckpt,
                       "--device", "cuda"])
    xf_launches = read_counts(kernels)
    check(rc == 0 and res["rgb"] == [HD_FRAMES, dim]
          and res["flow"] == [1, dim], f"extract-features (frames): {res}")
    # Its 10 pairs ride in one flow batch: one launch per scale.
    n_scales = len(SIZES)
    check(xf_launches == {**dict.fromkeys(kernels, 0),
                          "tvl1_scale": n_scales},
          f"extract-features on the 224² crop launched {xf_launches}")
    with torch.no_grad():
        frames, fcfg = apply_transport_crop(_load_frames(frames_dir, None),
                                            cfg)
        x = torch.from_numpy(frames).to(dev)
        want_rgb = pipeline.rgb_features(x, model.spatial, fcfg.preprocess)
        stacks = pipeline._flow_stacks(pipeline._crop(x, fcfg)[None], fcfg,
                                       plain=True)[0]
        want_flow = model.temporal(stacks, return_features=True)
    got = np.load(out2)
    e_rgb = close(got["rgb"], want_rgb.cpu().numpy(), "rgb features")
    e_flow = close(got["flow"], want_flow.cpu().numpy(),
                   "flow features of the frames")

    # 3. A 1080p clip through classify-clip.
    clip = synthesize_video(os.path.join(work, "clip_1080p.mp4"),
                            hd_frames(np, CLIP_FRAMES, seed=6))
    zero_counts(kernels)
    t0 = time.perf_counter()
    rc, res = run_cli(["classify-clip", clip, "--checkpoint", ckpt,
                       "--windows", str(CLIP_WINDOWS), "--topk",
                       str(cfg.num_classes), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cc_launches = read_counts(kernels)
    check(rc == 0 and len(res["topk"]) == cfg.num_classes,
          f"classify-clip: {rc}")
    # Its windows' 45 pairs ride in one flow batch: one launch per scale.
    check(cc_launches == {**dict.fromkeys(kernels, 0),
                          "tvl1_scale": n_scales},
          f"classify-clip launched {cc_launches}")
    probs = np.zeros(cfg.num_classes, np.float32)
    for entry in res["topk"]:
        probs[entry["class_id"]] = entry["prob"]
    check(abs(float(probs.sum()) - 1.0) < 1e-4, f"probs sum {probs.sum()}")
    check(res["top1"] == int(probs.argmax()), "top1 is not the argmax")
    plain = classify_clip_file(clip, model, cfg, dev,
                               num_windows=CLIP_WINDOWS, plain=True)
    e_probs = float(np.abs(plain - probs).max())
    check(e_probs <= TOL_PROBS,
          f"classify-clip probs vs plain versions: {e_probs} > {TOL_PROBS}")
    emit({"phase": "stage_chain", "checkpoint_bytes": os.path.getsize(ckpt),
          "features_max_abs_vs_tensors": {"stored_flow": e_stored,
                                          "rgb": e_rgb, "flow": e_flow},
          "extract_features_launches": xf_launches,
          "classify_clip": {"frames": CLIP_FRAMES, "windows": CLIP_WINDOWS,
                            "seconds": seconds, "top1": res["top1"],
                            "probs_max_abs_vs_plain": e_probs,
                            "launches": cc_launches},
          "tolerance": TOL_PROBS})



EVAL_CLASSES = 4           # the synthetic UCF101: 4 classes x 4 clips, half
EVAL_CLIPS_PER_CLASS = 4   # of them test clips: 8, at UCF101's 240x320
EVAL_FRAMES = 48
EVAL_BATCH = 8             # --batch-clips: the 8 test clips in one batch


def eval_ucf101_phase(torch, np, dev):
    """``tpuva-torch eval-ucf101`` on a synthetic UCF101 at 240x320 (8 test
    clips and a truncated one) from a full-width checkpoint written from
    seed 0: ``--batched`` (120 frame pairs in one ``tvl1`` call), with
    ``--windows 3`` (360), clip by clip with a manifest and a predictions
    file, again on that manifest, and ``--batched --algo farneback``; the
    launch counts set to 0 just before each command and held to the
    expected numbers just after.  One batch of the first run and one of
    the Farneback run through the batch function with the kernels and with
    their plain versions, and the ``tvl1_scale`` launches of the 120- and
    360-pair calls profiled.  Returns the launches per kernel summed over
    the commands."""
    import tempfile

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.flow.farneback import _level_sizes
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep
    from video_analytics_tpu_torch.runtime import evaluate as ev
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables

    cfg = PipelineConfig()
    pairs = cfg.window - 1
    n_scales = len(SIZES)
    tv_kernels = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
                  "tvl1_pd_warp": ts.pd_solve_warp, "median5": ts.median5,
                  "tvl1_pd_step": ts.pd_step,
                  "tvl1_eps_reduce": ts.eps_reduce,
                  "tvl1_pd_chunk": ts.pd_chunk,
                  "tvl1_band_flags": ts.band_flags}

    def read():
        return {**read_counts(tv_kernels), **read_fb_counts(fk)}

    nothing = dict.fromkeys(read(), 0)
    # What the batch function was called with in a command (one call a
    # batch), and the order in which the decode workers handed the clips
    # over: the rows of a batch.
    calls, streamed, started = [], [], []
    real_metrics, real_prefetch = ev.batch_clip_metrics, ev.prefetch_clips

    def metrics_spy(windows, labels, valid, model, bcfg):
        out = real_metrics(windows, labels, valid, model, bcfg)
        calls.append((windows, bcfg, out[1]))
        return out

    def prefetch_spy(*a, **kw):
        started.append(time.perf_counter())
        for item in real_prefetch(*a, **kw):
            streamed.append(item[0])
            yield item

    def command(base, extra, expected):
        """One command with every launch count set to 0 just before it and
        held to `expected` (the rest 0) just after."""
        del calls[:], streamed[:], started[:]
        zero_counts(tv_kernels)
        zero_fb_counts(fk)
        t0 = time.perf_counter()
        rc, res = run_cli(base + extra)
        torch.cuda.synchronize()
        end = time.perf_counter()
        launches = read()
        check(rc == 0, f"eval-ucf101 {extra} exited {rc}: {res}")
        want = {**nothing, **expected}
        check(launches == want,
              f"eval-ucf101 {extra} launched {launches}, expected {want}")
        run = {"seconds": end - t0, "launches": launches}
        if started:         # --batched: from the start of its decode
            run["eval_seconds"] = end - started[0]
        return res, run

    runs = {}
    ev.batch_clip_metrics, ev.prefetch_clips = metrics_spy, prefetch_spy
    try:
        with tempfile.TemporaryDirectory() as work:
            ds = build_synthetic_ucf101(
                os.path.join(work, "ucf101"), num_classes=EVAL_CLASSES,
                clips_per_class=EVAL_CLIPS_PER_CLASS, num_frames=EVAL_FRAMES,
                h=NATIVE[0], w=NATIVE[1], seed=0)
            n_clips = len(ds.test_records())
            # A corrupt clip in the test list: a truncated container.
            corrupt = os.path.join(ds.videos_root, "Right",
                                   "v_Right_g99_c01.avi")
            with open(ds.test_records()[0].path, "rb") as f, \
                    open(corrupt, "wb") as g:
                g.write(f.read(256))
            with open(os.path.join(ds.annotations_root, "testlist01.txt"),
                      "a") as f:
                f.write("Right/v_Right_g99_c01.avi\n")
            ckpt = os.path.join(work, "two_stream.msgpack")
            model = TwoStreamModel.create(
                num_classes=cfg.num_classes,
                flow_stack=cfg.preprocess.flow_stack,
                width=64).init(torch.Generator().manual_seed(0))
            save_variables(ckpt, model.flax_variables())
            model = model.to(dev).eval()
            base = ["eval-ucf101", "--videos", ds.videos_root,
                    "--annotations", ds.annotations_root, "--checkpoint",
                    ckpt, "--device", "cuda"]

            def counts_ok(res, what):
                check(res["total"] == n_clips and res["failed"] == 1
                      and res["failures"][0]["path"] == corrupt
                      and 0 <= res["correct"] <= n_clips,
                      f"eval-ucf101 {what}: {res}")

            # 1. --batched: one batch of 8 clips, 120 pairs in one call.
            batched = ["--batched", "--batch-clips", str(EVAL_BATCH)]
            res, runs["batched"] = command(base, batched,
                                           {"tvl1_scale": n_scales})
            counts_ok(res, "--batched")
            check(len(calls) == 1 and tuple(calls[0][0].shape[:3])
                  == (n_clips, 1, cfg.window),
                  f"--batched: batches {[c[0].shape for c in calls]}")
            one = calls[0]
            batch_preds = dict(zip(streamed, one[2].tolist()))
            runs["batched"].update(result=res, pairs_per_tvl1_call=n_clips
                                   * pairs)
            # Again: the first run's seconds hold the first calls at its
            # shapes (cuDNN's choice of algorithms, allocations).
            res_again, runs["batched_again"] = command(
                base, batched, {"tvl1_scale": n_scales})
            check(res_again == res, f"--batched again: {res_again} != {res}")

            # 2. --windows 3: 360 pairs in one call.
            res3, runs["batched_windows3"] = command(
                base, batched + ["--windows", "3"], {"tvl1_scale": n_scales})
            counts_ok(res3, "--batched --windows 3")
            check(len(calls) == 1
                  and tuple(calls[0][0].shape[:2]) == (n_clips, 3),
                  f"--windows 3: batches {[c[0].shape for c in calls]}")
            three = calls[0]
            runs["batched_windows3"].update(result=res3,
                                            pairs_per_tvl1_call=3 * n_clips
                                            * pairs)

            # 3. Clip by clip, then again on the same manifest.
            preds_file = os.path.join(work, "predictions.jsonl")
            seq = ["--predictions", preds_file, "--manifest",
                   os.path.join(work, "manifest.txt")]
            res_s, runs["sequential"] = command(
                base, seq, {"tvl1_scale": n_scales * n_clips})
            counts_ok(res_s, "sequential")
            with open(preds_file) as f:
                seq_preds = {e["path"]: e["pred"]
                             for e in map(json.loads, f.read().splitlines())}
            check(seq_preds == batch_preds
                  and res_s["correct"] == res["correct"],
                  f"sequential predictions {seq_preds}, correct "
                  f"{res_s['correct']}; --batched {batch_preds}, "
                  f"{res['correct']}")
            runs["sequential"]["result"] = res_s
            res_r, runs["sequential_rerun"] = command(base, seq, {})
            check(res_r["total"] == 0 and res_r["failed"] == 1,
                  f"rerun on the manifest: {res_r}")
            runs["sequential_rerun"]["result"] = res_r

            # 4. Farneback, batched.
            fcfg = cfg.farneback
            res_f, runs["farneback_batched"] = command(
                base, batched + ["--algo", "farneback"],
                fb_expected(len(_level_sizes(cfg.preprocess.crop,
                                             cfg.preprocess.crop, fcfg)),
                            fcfg.iterations))
            counts_ok(res_f, "--batched --algo farneback")
            fb_one = calls[0]
            runs["farneback_batched"]["result"] = res_f
    finally:
        ev.batch_clip_metrics, ev.prefetch_clips = real_metrics, real_prefetch
    # Clips a second over the whole command (checkpoint load and model
    # set-up included) and, for --batched, from the start of its
    # decode to the end of its device work.
    for name in ("batched", "batched_again", "batched_windows3",
                 "sequential", "farneback_batched"):
        runs[name]["clips_per_s"] = n_clips / runs[name]["seconds"]
        if "eval_seconds" in runs[name]:
            runs[name]["eval_clips_per_s"] = (n_clips
                                              / runs[name]["eval_seconds"])

    # Answer agreement: a batch of run 1 and one of run 4 through the batch
    # function with the kernels and with their plain versions.
    agree = {}
    for name, (windows, bcfg, preds) in (("tvl1", one),
                                         ("farneback", fb_one)):
        got = ev.batch_clip_probs(windows, model, bcfg)
        want = ev.batch_clip_probs(windows, model, bcfg, plain=True)
        e = float((got - want).abs().max())
        check(e <= TOL_PROBS and torch.equal(got.argmax(-1), preds),
              f"eval batch ({name}) vs plain versions: {e} > {TOL_PROBS}")
        agree[name] = e
    # The device time of the tvl1_scale launches of the 120- and 360-pair
    # calls.  The profiler now and then drops records: a short count is
    # taken again.
    scale_ms = {}
    for name, (windows, bcfg, _) in (("pairs_120", one),
                                     ("pairs_360", three)):
        for _ in range(3):
            prof = device_profile(torch, lambda: ev.batch_clip_probs(
                windows, model, bcfg))
            hits = [k for k in prof["port_kernels_device_ms"]
                    if "pd_warp_kernel" in k["name"]]
            if sum(k["count"] for k in hits) == n_scales:
                break
        check(sum(k["count"] for k in hits) == n_scales,
              f"profile of the {name} call: {prof['port_kernels_device_ms']}")
        scale_ms[name] = {"tvl1_scale_device_ms": sum(k["ms"] for k in hits),
                          "by_launch": hits,
                          "batch_call_wall_ms": prof["profiled_wall_ms"],
                          "device_busy_ms": prof["device_busy_ms"]}
    emit({"phase": "eval_ucf101", "clips": n_clips, "corrupt": 1,
          "frames": EVAL_FRAMES, "size": list(NATIVE),
          "batch_clips": EVAL_BATCH, "runs": runs,
          "probs_max_abs_vs_plain": agree, "tolerance": TOL_PROBS,
          "tvl1_scale_per_batch_call": scale_ms})
    total = dict(nothing)
    for run in runs.values():
        for k, n in run["launches"].items():
            total[k] += n
    return total


def native_phases(torch, np, dev, chain: bool = True):
    """The native-resolution flow command and, with `chain`, the stage
    commands that read what it wrote, in one temporary directory.  Returns
    the flow command's launches per kernel."""
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        launches, frames_dir, flow_dir = tvl1_1080p_phase(torch, np, dev,
                                                          work)
        if chain:
            stage_chain_phase(torch, np, dev, work, frames_dir, flow_dir)
    return launches


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    choices=["tvl1_warp_kernel", "farneback_kernels",
                             "farneback_1080p", "tvl1_midsize",
                             "tvl1_chunk_kernels", "tvl1_1080p",
                             "stage_chain", "eval_ucf101"],
                    help="run the build and this phase alone (stage_chain "
                         "with tvl1_1080p, whose directories it reads), for "
                         "work on it; prints no result line")
    ap.add_argument("--sweep-chunk", action="store_true",
                    help="with the tvl1_chunk_kernels phase: also time one "
                         "1080x1920 warp at several iterations per launch")
    args = ap.parse_args(argv)

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

    if args.only == "tvl1_warp_kernel":
        tvl1_warp_kernel_phase(torch, np, dev)
    elif args.only == "farneback_kernels":
        farneback_kernels_phase(torch, np, dev)
    elif args.only == "farneback_1080p":
        farneback_1080p_phase(torch, np, dev)
    elif args.only == "tvl1_midsize":
        tvl1_midsize_phase(torch, np, dev)
    elif args.only == "tvl1_chunk_kernels":
        tvl1_chunk_kernels_phase(torch, np, dev, args.sweep_chunk)
    elif args.only == "eval_ucf101":
        eval_ucf101_phase(torch, np, dev)
    elif args.only:
        native_phases(torch, np, dev, args.only == "stage_chain")
    if args.only:
        print(gpu, flush=True)
        return 0

    # -- 2. kernels against their plain versions ----------------------------
    cfg = TVL1Config()
    one_round = dataclasses.replace(cfg, outer_iterations=1)
    errs = {"warp_prep": 0.0, "tvl1_pd_step": 0.0, "median5": 0.0,
            "tvl1_eps_reduce": 0.0}
    times = {}
    for size in SIZES:
        i0, i13, uv = tvl1_level_inputs(torch, np, dev, size, size, PAIRS)

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
            dev_times = {
                "warp_prep": device_ms(
                    torch, lambda: warp_prep(i13, i0, uv),
                    "warp_prep_kernel"),
                "median5": device_ms(
                    torch, lambda: ts.median5(uv, 5, on, out=uv_out),
                    "median_kernel"),
                "tvl1_pd_step": device_ms(
                    torch, lambda: ts.pd_step(prep, uv, p, on, cfg, uv_out,
                                              p_out), "pd_step_kernel"),
                "tvl1_eps_reduce": device_ms(
                    torch, lambda: ts.eps_reduce(big, on, errv[0], n_px,
                                                 cfg.epsilon),
                    "eps_reduce_kernel")}
    emit({"phase": "kernels", "sizes": list(SIZES), "pairs": PAIRS,
          "max_abs_err": errs, "median5_bit_exact": True,
          "ms_kernel_vs_plain": times,
          f"device_ms_at_{SIZES[0]}": dev_times})

    # K-H is on no command's path since tvl1_scale: its launches are those
    # of this phase, which holds it against its plain version.
    ts.pd_solve_warp.launches = 0
    kh = tvl1_warp_kernel_phase(torch, np, dev)
    own_check = {"tvl1_pd_warp": ts.pd_solve_warp.launches}

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

    # Every level of a 224² crop fits a cluster: per request and level one
    # launch of tvl1_scale (its 5 warps and the scale-end median inside);
    # K-A, K-H, K-C and the per-iteration kernels not at all.
    kernels = {"tvl1_scale": ts.pd_solve_scale, "warp_prep": warp_prep,
               "tvl1_pd_warp": ts.pd_solve_warp, "median5": ts.median5,
               "tvl1_pd_step": ts.pd_step, "tvl1_eps_reduce": ts.eps_reduce}
    request_ms, outs, launches = serve_requests(
        server, frames, lambda: zero_counts(kernels),
        lambda: read_counts(kernels),
        {**dict.fromkeys(kernels, 0), "tvl1_scale": len(SIZES)})
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
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    zero_fb_counts(fk)
    fb_errs, fb_times, fb_bounds, fb_dev = farneback_kernels_phase(
        torch, np, dev)
    own_check.update(read_fb_counts(fk))
    fb_launches = farneback_serve_phase(torch, np, dev, model)
    cf_launches = compute_flow_phase(np)
    fhd_launches, fhd = farneback_1080p_phase(torch, np, dev)

    # -- 8-10. native-resolution TV-L1 and the stage chain -------------------
    kg = tvl1_chunk_kernels_phase(torch, np, dev, args.sweep_chunk)
    mid_launches, chain_launches = tvl1_midsize_phase(torch, np, dev)
    # K-B and the ε reduction are on no command's path since the levels
    # between take 16-block clusters: their launches are those of the level
    # that fits no cluster.
    own_check.update({name: chain_launches[name]
                      for name in ("tvl1_pd_step", "tvl1_eps_reduce")})
    hd_launches = native_phases(torch, np, dev)

    # -- 11. eval-ucf101 ----------------------------------------------------
    eval_launches = eval_ucf101_phase(torch, np, dev)

    # -- the kernel table -----------------------------------------------------
    # TV-L1 bounds at 224², 15 pairs.  Planes moved: warp_prep reads I1 and
    # its gradients, I0 and the flow and writes 4; pd_step reads prep, the
    # flow and the dual (10) and writes 6; median5 reads and writes u, v;
    # eps_reduce reads the per-block sums.  Operations per pixel: 3
    # bilinear samples and the prep (~45); one primal-dual step (~70); 113
    # compare-exchanges of a min and a max per plane.  pd_solve_warp's and
    # tvl1_scale's are those of the rounds their images took (warp_bound,
    # scale_bound).  Launches are those of the serve requests where the
    # serve path runs the kernel; tvl1_scale's also on the mid-size
    # commands' path (launches_tvl1_midsize); K-A, K-C, K-G and band_flags
    # on the 1080p TV-L1 command's; K-D's blur pass on the 1080p Farneback
    # command's (--fb-levels 4); K-H, K-B, the ε reduction, K-E, sep_corr
    # and fb_window_solve are on no command's path (tvl1_scale and
    # fb_iteration hold their arithmetic; K-B and ε take only a level too
    # wide for a cluster; K-E, sep_corr and fb_window_solve only windows
    # beyond 73 taps): their launches are 0, and check_launches counts
    # those of the phase that holds them against their plain versions.
    px = PAIRS * SIZES[0] * SIZES[0]
    blocks = ts.pd_blocks(SIZES[0], SIZES[0])
    bounds = {"warp_prep": bound(10 * 4 * px, 45 * px),
              "tvl1_pd_step": bound(16 * 4 * px, 70 * px),
              "median5": bound(4 * 4 * px, 2 * 2 * 113 * px),
              "tvl1_eps_reduce": bound(4 * PAIRS * blocks + 8 * PAIRS,
                                       PAIRS * blocks),
              **fb_bounds,
              **{name: v[2] for name, v in {**kh, **kg, **fhd}.items()}}
    errs.update(fb_errs)
    errs.update({name: v[0] for name, v in {**kh, **kg, **fhd}.items()})
    launches.update(fb_launches)
    launches_from = {name: "serve" for name, n in launches.items() if n > 0}
    for source, counts in (("tvl1_midsize", mid_launches),
                           ("tvl1_1080p", hd_launches),
                           ("farneback_1080p", fhd_launches)):
        for name, n in counts.items():
            if launches.get(name, 0) == 0 and n > 0:
                launches[name], launches_from[name] = n, source
    table_ms = {**{name: (*t, None) for name, t in times[SIZES[0]].items()},
                **fb_times,
                **{name: v[1] for name, v in {**kh, **kg, **fhd}.items()}}
    dev_times.update(fb_dev)
    dev_times.update({name: v[3] for name, v in {**kh, **kg, **fhd}.items()})
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
            ("tvl1_pd_warp", "tvl1_pd_warp.cu", pallas + "tvl1_solve.py:191",
             [pallas + "tvl1_solve.py:415", pallas + "tvl1_solve.py:584"]),
            ("tvl1_scale", "tvl1_pd_warp.cu", pallas + "tvl1_solve.py:584",
             [pallas + "tvl1_solve.py:500"]),
            ("tvl1_pd_chunk", "tvl1_pd_chunk.cu", pallas + "tvl1_solve.py:890",
             [pallas + "tvl1_solve.py:720", pallas + "tvl1_solve.py:1001"]),
            ("tvl1_band_flags", "tvl1_pd_chunk.cu",
             pallas + "tvl1_solve.py:1001", []),
            ("fb_prologue", "fb_prologue.cu", fbk + "1191", [fbk + "990"]),
            ("fb_prologue_blur", "fb_prologue.cu", fbk + "1191",
             [fbk + "990"]),
            ("fb_warp_neq", "fb_warp_neq.cu", fbk + "471",
             [fbk + "263", fbk + "697", fbk + "772", fbk + "946",
              pallas + "warp.py:157", pallas + "warp.py:130"]),
            ("sep_corr", "sep_corr.cu", fbk + "139",
             [fbk + "263", fbk + "471", fbk + "946"]),
            ("sep_corr_x_solve", "sep_corr.cu", fbk + "697",
             [fbk + "139", fbk + "574", fbk + "946"]),
            ("fb_window_solve", "fb_window_solve.cu", fbk + "574",
             [fbk + "263", fbk + "471", fbk + "697", fbk + "946"]),
            ("fb_iteration", "fb_window_solve.cu", fbk + "946",
             [fbk + "826"])]
    off_path = ("tvl1_pd_warp", "tvl1_pd_step", "tvl1_eps_reduce",
                "fb_warp_neq", "sep_corr", "sep_corr_x_solve",
                "fb_window_solve")
    for name, *_ in rows:
        if name in off_path:
            check(launches.get(name, 0) == 0 and own_check[name] > 0,
                  f"kernel {name}: {launches.get(name)} launches on a path, "
                  f"{own_check[name]} against its plain version")
            launches[name] = 0
        else:
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was launched on no path")
    emit({"kernels": [{"name": name, "route": "cuda", "source": src + source,
                       "replaces": replaces, "replaces_also": also,
                       "launches": launches[name],
                       "launches_from": launches_from.get(name),
                       **({"check_launches": own_check[name]}
                          if name in off_path else {}),
                       "max_abs_err": errs[name],
                       "ms": table_ms[name][0],
                       "device_ms": dev_times[name],
                       "plain_ms": table_ms[name][1],
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1],
                       "library_ms": table_ms[name][2],
                       **({"launches_compute_flow": cf_launches[name]}
                          if name in cf_launches else {}),
                       **({"launches_tvl1_1080p": hd_launches[name]}
                          if name in hd_launches else {}),
                       **({"launches_tvl1_midsize": mid_launches[name]}
                          if name in mid_launches else {}),
                       **({"launches_farneback_1080p": fhd_launches[name]}
                          if name in fhd_launches else {}),
                       "launches_eval_ucf101": eval_launches.get(name, 0)}
                      for name, source, replaces, also in rows]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
