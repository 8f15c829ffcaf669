#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports no JAX and no OpenCV, and fails (non-zero exit, no result
line) where ``torch.cuda.is_available()`` is false or the package is not
beside it.  Phases, each reported on a JSON line:

1. build: compile every CUDA kernel of the serve path from
   ``video_analytics_tpu_torch/csrc/`` with nvcc for sm_90a;
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
   request and of an unprofiled one.

Then it prints the kernel table (``{"kernels": [...]}``), the card's
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scene(np, t: float, h: int, w: int, seed: int, vel=(1.3, -0.7)):
    """(h, w) smooth texture in [0, 255] translated by t·vel pixels: a
    sum of sinusoids, so sub-pixel motion is exact."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x = x - t * vel[0]
    y = y - t * vel[1]
    img = np.zeros((h, w))
    for _ in range(6):
        fx, fy = rng.uniform(-0.12, 0.12, 2)
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
        lap("tvl1_and_stacking")
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
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.ops.cuda import _build
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import (
        warp_prep, warp_prep_plain)
    from video_analytics_tpu_torch.ops.kernels import centered_gradient
    from video_analytics_tpu_torch.runtime.pipeline import classify_window
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
    for fn in kernels.values():
        fn.launches = 0
    request_ms, outs = [], []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        outs.append(server._classify(server._windows_from_frames(frames)))
        request_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serve path")

    probs = outs[0]
    check(probs.shape == (pcfg.num_classes,), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()) and bool((probs >= 0).all()),
          "probs not finite and non-negative")
    check(abs(float(probs.sum()) - 1.0) < 1e-4, f"probs sum {probs.sum()}")
    wins, wcfg = apply_transport_crop(server._windows_from_frames(frames),
                                      pcfg)
    x = torch.from_numpy(wins[0]).to(dev)
    plain = classify_window(x, server.model, wcfg, plain=True).cpu().numpy()
    e = float(np.abs(plain - probs).max())
    check(e <= TOL_PROBS, f"fused probs vs plain versions: {e} > {TOL_PROBS}")
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

    src = "video_analytics_tpu_torch/csrc/"
    rows = [("warp_prep", src + "warp_prep.cu",
             "video_analytics_tpu/ops/pallas/warp.py:157"),
            ("tvl1_pd_step", src + "tvl1_pd.cu",
             "video_analytics_tpu/ops/pallas/tvl1_solve.py:191"),
            ("median5", src + "median.cu",
             "video_analytics_tpu/ops/pallas/tvl1_solve.py:75"),
            ("tvl1_eps_reduce", src + "tvl1_pd.cu",
             "video_analytics_tpu/ops/pallas/tvl1_solve.py:165")]
    emit({"kernels": [{"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": errs[name],
                       "ms": times[SIZES[0]][name][0],
                       "plain_ms": times[SIZES[0]][name][1]}
                      for name, source, replaces in rows]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
