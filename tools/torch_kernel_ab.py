#!/usr/bin/env python3
"""Device time of the port's K-C ``median5``, K-F ``sep_corr`` and TV-L1
solver warps at the shapes their command paths give them, from the
package of one checkout.

    python3 tools/torch_kernel_ab.py [--root DIR] [--tag NAME]
                                     [--only median|sep_corr|tvl1]

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
then x with the solve).  TV-L1 with ``TVL1Config()``: one warp of the
chunked solver (``pd_solve_chunked``, K-G) on 2 pairs of the finest
1080×1920 level, one warp of the per-iteration chain (``pd_solve``, K-B
and K-C) on a 20×4000 pair, and a whole ``tvl1`` flow call on 2 pairs of
1080×1920: for each the device time of every kernel it launches and
their number (torch.profiler, one call), the call's time between CUDA
events, and a sha256 of the flow, so that two checkouts' answers can be
compared bit for bit.  Where the checkout's ``pd_chunk`` and ``pd_step``
take the round's test (``count``), also one last launch of a round with
the test and without it.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
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


def kernel_name(name: str) -> str:
    """A profile's kernel name without its return type, namespace and
    argument list: ``pd_chunk_kernel<true>``."""
    name = name.split("(anonymous namespace)::", 1)[-1]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.removeprefix("void ")[:80]


def launches(torch, fn):
    """Every device kernel of one call of fn() (after a first call): their
    summed device ms, their number, and per kernel name (without its
    argument list) its launches and ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = kernel_name(ev.name)
            n, ms = per.get(name, (0, 0.0))
            per[name] = (n + 1, ms + (ev.time_range.end
                                      - ev.time_range.start) / 1e3)
        if per:
            return {"device_ms": sum(ms for _, ms in per.values()),
                    "launches": sum(n for n, _ in per.values()),
                    "by_kernel": {k: {"launches": n, "ms": ms}
                                  for k, (n, ms) in sorted(per.items())}}
    raise RuntimeError("no device time recorded")


def event_ms(torch, fn, reps: int = 5) -> float:
    """Mean ms of fn() between CUDA events, over `reps` calls after one."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sha256(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def smooth_pairs(torch, dev, pairs: int, h: int, w: int):
    """(i0, i1): `pairs` smooth [0, 255] images and their successors
    moved by (1.3, -0.7) px, from fixed phases."""
    y = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    x = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    frames = []
    for t in (0.0, 1.0):
        imgs = []
        for b in range(pairs):
            xs, ys = x - 1.3 * t, y + 0.7 * t
            imgs.append(127.5 + 40 * torch.sin(0.071 * xs + b)
                        + 30 * torch.cos(0.053 * ys - 0.4 * b)
                        + 20 * torch.sin(0.031 * (xs + ys) + 1.7 * b))
        frames.append(torch.stack(imgs).float().contiguous())
    return frames


def tvl1_warps(torch, dev):
    """One chunked warp at 1080x1920 and one chain warp at 20x4000 (2 and
    1 pairs, TVL1Config(), a start flow from the pair's motion), and one
    2-pair 1080x1920 flow call."""
    from video_analytics_tpu_torch.config import TVL1Config
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts
    from video_analytics_tpu_torch.ops.cuda.warp import warp_prep_plain
    from video_analytics_tpu_torch.ops.kernels import centered_gradient

    cfg = TVL1Config()
    out = {}
    for name, pairs, (h, w), chunked in (
            ("chunked_warp_2x1080x1920", 2, (1080, 1920), True),
            ("chain_warp_1x20x4000", 1, (20, 4000), False)):
        i0, i1 = smooth_pairs(torch, dev, pairs, h, w)
        i1x, i1y = centered_gradient(i1)
        i13 = torch.stack([i1, i1x, i1y], dim=1).contiguous()
        uv = torch.stack([torch.full_like(i0, 1.0), torch.full_like(i0, -0.5)],
                         dim=1)
        prep = warp_prep_plain(i13, i0, uv)
        if chunked:
            band, chunk = ts.chunk_params(h, w, cfg)

            def solve():
                return ts.pd_solve_chunked(prep, uv, cfg, band, chunk)
        else:
            def solve():
                return ts.pd_solve(prep, uv, cfg)
        out[name] = {**launches(torch, solve), "event_ms": event_ms(
            torch, solve), "flow_sha256": sha256(solve())}
        if chunked:
            out[name].update(last_launch_ms(torch, ts, prep, uv, cfg, band,
                                            chunk))
        del i0, i1, i13, uv, prep
    i0, i1 = smooth_pairs(torch, dev, 2, 1080, 1920)

    def call():
        return tvl1(i0, i1, cfg)

    out["flow_call_2x1080x1920"] = {**launches(torch, call),
                                    "event_ms": event_ms(torch, call, 3),
                                    "flow_sha256": sha256(call())}
    return out


def last_launch_ms(torch, ts, prep, uv, cfg, band, chunk):
    """A round's last ``pd_chunk`` launch with the bands' test and without
    it (the error sums alone), where the checkout's ``pd_chunk`` takes
    the test; device ms per launch."""
    if "count" not in inspect.signature(ts.pd_chunk).parameters:
        return {}
    B, _, H, W = uv.shape
    tile, halo = ts.chunk_tile(chunk, cfg)
    n_bands = -(-H // band)
    state = torch.cat([uv, torch.zeros((B, 4, H, W), device=uv.device)],
                      dim=1)
    out = torch.empty_like(state)
    partial = torch.empty((B, n_bands, ts.chunk_partials(H, W, band, tile)),
                          device=uv.device)
    act = torch.ones((B, n_bands), dtype=torch.int32, device=uv.device)
    nxt = torch.empty_like(act)
    err = torch.full((B, n_bands), float("inf"), device=uv.device)
    count = torch.zeros(B, dtype=torch.int32, device=uv.device)
    iters = cfg.inner_iterations % chunk or chunk
    return {"last_launch_device_ms_with_test": device_ms(
                torch, lambda: ts.pd_chunk(prep, state, act, cfg, iters, band,
                                           tile, halo, False, out, partial,
                                           None, count, err, nxt),
                "pd_chunk_kernel"),
            "last_launch_device_ms_sums_only": device_ms(
                torch, lambda: ts.pd_chunk(prep, state, act, cfg, iters, band,
                                           tile, halo, False, out, partial),
                "pd_chunk_kernel")}


def median_ms(torch, ts, dev, g):
    """K-C at k = 5: 15 pairs of 224², 2 pairs at each 1080p level."""
    median = {}
    for pairs, (h, w) in [(15, (224, 224))] + [(2, s) for s in TVL1_1080P]:
        uv = 2.0 * torch.randn((pairs, 2, h, w), device=dev, generator=g)
        on = torch.ones(pairs, dtype=torch.int32, device=dev)
        dst = torch.empty_like(uv)
        median[f"{pairs}x{h}x{w}"] = device_ms(
            torch, lambda: ts.median5(uv, 5, on, out=dst), "median_kernel")
        del uv, dst
    return median


def sep_corr_ms(torch, fk, dev, g):
    """K-F at 201 Gaussian taps on both axes, with and without the solve,
    at the 1/8 level of 1080p and at 1080x1920, 2 pairs."""
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

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
    return sep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("median", "sep_corr", "tvl1"),
                    help="time one group of kernels alone")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs an NVIDIA GPU")
    from video_analytics_tpu_torch.ops.cuda import farneback as fk
    from video_analytics_tpu_torch.ops.cuda import tvl1_solve as ts

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    out = {"tag": args.tag, "root": os.path.abspath(args.root),
           "package": os.path.dirname(ts.__file__)}

    if args.only in (None, "median"):
        out["median5_device_ms"] = median_ms(torch, ts, dev, g)
    if args.only in (None, "sep_corr"):
        out["sep_corr_201_device_ms"] = sep_corr_ms(torch, fk, dev, g)
    if args.only in (None, "tvl1"):
        out["tvl1"] = tvl1_warps(torch, dev)
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
