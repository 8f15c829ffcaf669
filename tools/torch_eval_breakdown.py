"""Where the clips/s of batched evaluation goes, on the PyTorch port: the
twin of tools/eval_breakdown.py (the same protocol, legs, JSON keys and
per-clip ledger), on the first CUDA device unless --device says otherwise.

    python3 tools/torch_eval_breakdown.py [--device cuda:1]

The protocol is the reference's clips leg (bench.py's): a synthetic UCF101
of 32 test clips (8 classes, 4 clips each, 48 frames at 240x320) built
into a temporary directory of this run's own,
``PipelineConfig(flow_algo="farneback", window=16)``, the two-stream
model with ``dtype=torch.bfloat16`` from seed 0 in eval mode, batches of 8
clips and 2 decode workers.  ``breakdown`` measures, each leg alone:

  - decode per clip: ``decode_snippet_windows`` + ``slice_crop_source``
    (the decode worker's body), serial, the median;
  - host preparation per batch: ``np.stack`` of a batch's clips;
  - the copy to the card per batch: ``runtime.evaluate._place_batch`` as
    ``evaluate_batched`` calls it, which copies the batch into pinned
    memory and then to the card without blocking, so this leg includes the
    pageable-to-pinned copy that ``evaluate_batched`` pays; each pass on
    distinct content and fenced by a scalar that depends on every byte;
  - device time per batch of ``batch_clip_metrics``: "deep" (groups of
    3 x batches calls, one read of the summed counts a group) and
    "single" (a read after every call); their difference is the host's
    launch-and-sync cost per batch;
  - end to end: ``evaluate_batched`` clips/s, a warm pass on 2 clips, then
    the median of 3 passes.

Each device call sees distinct content: one element of the placed batch
has a device scalar added in place first (no copy of the batch, no host
sync).  The reference needs that for its TPU's transport; it is kept only
so that the legs compare with the reference's.

Prints the card's name and power limit (as nvidia-smi reports them), the
reference's JSON line and its readable ledger.  With --device cuda and no
card it fails; there is no CPU fallback.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The reference's clips leg, copied from bench.py:31,42,350-356 (this tool
# does not import bench.py, which imports JAX).
SRC_H, SRC_W = 240, 320
FLOW_STACK = 10
NUM_CLASSES, CLIPS_PER_CLASS, NUM_FRAMES = 8, 4, 48
BATCH_CLIPS, NUM_WORKERS, PASSES = 8, 2, 3
HOSTPREP_REPS = 20


def ledger(res, batch_clips: int, workers: int):
    """Per-clip ledger (ms) of a ``breakdown`` result, with the arithmetic
    of tools/eval_breakdown.py: decode runs in `workers` threads beside
    the consumer (host preparation, the copy, the device calls and their
    launch-and-sync cost), so only the part of decode/workers that exceeds
    the consumer's terms is counted; what is left of the wall time per clip
    is unattributed."""
    wall_clip = 1e3 / res["clips_per_sec_e2e"]
    out = {
        "wall_ms_per_clip": round(wall_clip, 2),
        "decode_per_clip_2workers": round(
            res["decode_ms_per_clip"] / workers, 2),
        "deviceput_per_clip": round(
            res["deviceput_ms_per_batch"] / batch_clips, 2),
        "device_compute_per_clip": round(
            res["device_ms_per_batch_deep"] / batch_clips, 2),
        "dispatch_rtt_per_clip": round(
            res["dispatch_rtt_ms"] / batch_clips, 2),
        "hostprep_per_clip": round(
            res["hostprep_ms_per_batch"] / batch_clips, 2),
    }
    consumer = sum(v for k, v in out.items()
                   if k not in ("wall_ms_per_clip",
                                "decode_per_clip_2workers"))
    decode_eff = max(0.0, res["decode_ms_per_clip"] / workers - consumer)
    out["decode_not_hidden"] = round(decode_eff, 2)
    out["unattributed"] = round(wall_clip - consumer - decode_eff, 2)
    return out


def breakdown(records, model, cfg, device, batch_clips: int = BATCH_CLIPS,
              num_workers: int = NUM_WORKERS, passes: int = PASSES,
              counters=None):
    """The legs of ``evaluate_batched(records, model, cfg, device,
    batch_clips, num_workers)``, each measured alone (the module's
    docstring), and the ledger: the reference's result dict.  `model` is
    on `device` in eval mode.  With `counters`, a pair of callables (zero,
    read), every timed end-to-end pass is run between ``zero()`` and
    ``read()``, outside the clock, and the reads are returned as
    ``launches_per_pass``.  Raises if a pass does not evaluate every clip
    or counts a failure."""
    import numpy as np
    import torch

    from video_analytics_tpu_torch.io.video import decode_snippet_windows
    from video_analytics_tpu_torch.ingest.windows import slice_crop_source
    from video_analytics_tpu_torch.runtime.evaluate import (
        _place_batch, _window_frames, _with_src_hw, batch_clip_metrics,
        evaluate_batched)

    device = torch.device(device)
    res = {}

    # -- 1. host decode + transport crop (the loader body), serial ---------
    win = _window_frames(cfg)
    decode_ms, batches, pend, hw = [], [], [], None
    for rec in records:
        t0 = time.perf_counter()
        wins = decode_snippet_windows(rec.path, win, 1, max_frames=300)
        wins, hw = slice_crop_source(wins, cfg.preprocess.resize_short,
                                     cfg.preprocess.crop)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        pend.append(wins)
        if len(pend) == batch_clips:
            batches.append(np.stack(pend))
            pend = []
    if not batches:
        raise ValueError(f"{len(records)} clips make no batch of "
                         f"{batch_clips}")
    res["decode_ms_per_clip"] = round(float(np.median(decode_ms)), 3)
    labels = np.zeros(batch_clips, np.int64)

    # -- 2. host preparation (np.stack, the flush() body's host cost) ------
    group = list(batches[0])
    t0 = time.perf_counter()
    for _ in range(HOSTPREP_REPS):
        np.stack(group)
    res["hostprep_ms_per_batch"] = round(
        (time.perf_counter() - t0) / HOSTPREP_REPS * 1e3, 3)

    # -- 3. the copy to the card, fenced by a scalar of every byte ---------
    def force(a):
        return int(a.to(torch.int32).sum())

    force(_place_batch(batches[0], labels, device)[0])
    put_ms = []
    for b in batches:
        b = b.copy()
        b[0, 0, 0, 0, 0, 0] ^= 1       # distinct content per pass
        t0 = time.perf_counter()
        a, _, _ = _place_batch(b, labels, device)
        force(a)
        put_ms.append((time.perf_counter() - t0) * 1e3)
    res["deviceput_ms_per_batch"] = round(float(np.median(put_ms)), 3)
    res["batch_mb"] = round(batches[0].nbytes / 2**20, 2)
    res["implied_transfer_mbps"] = round(
        batches[0].nbytes / 2**20 / (np.median(put_ms) / 1e3), 1)

    # -- 4. device time, deep: one read a group of calls -------------------
    bcfg = _with_src_hw(cfg, hw)
    placed = [_place_batch(b, labels, device) for b in batches]
    for a, _, _ in placed:
        force(a)                       # contents resident before timing
    pert = torch.arange(1, 256, dtype=torch.uint8, device=device)
    calls = 0

    def metrics(a, l, v):
        """One batch call on content that no call saw before: a device
        scalar added in place to one element first."""
        nonlocal calls
        a[0, 0, 0, 0, 0, 0].add_(pert[calls % len(pert)])
        calls += 1
        return batch_clip_metrics(a, l, v, model, bcfg)[0]

    int(metrics(*placed[0]))           # first call at this shape
    deep = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [metrics(a, l, v) for a, l, v in placed * 3]
        int(torch.stack(outs).sum())
        deep.append((time.perf_counter() - t0) / len(outs) * 1e3)
    res["device_ms_per_batch_deep"] = round(float(np.median(deep)), 3)

    # -- 5. device time, single: a read after every call -------------------
    single = []
    for a, l, v in placed * 3:
        t0 = time.perf_counter()
        int(metrics(a, l, v))
        single.append((time.perf_counter() - t0) * 1e3)
    res["device_ms_per_batch_single"] = round(float(np.median(single)), 3)
    res["dispatch_rtt_ms"] = round(
        res["device_ms_per_batch_single"]
        - res["device_ms_per_batch_deep"], 3)
    del placed

    # -- 6. end to end, the bench's protocol -------------------------------
    evaluate_batched(records[:2], model, cfg, device,
                     batch_clips=batch_clips, num_workers=num_workers)
    e2e, launches = [], []
    for _ in range(passes):
        if counters:
            counters[0]()
        t0 = time.perf_counter()
        r = evaluate_batched(records, model, cfg, device,
                             batch_clips=batch_clips,
                             num_workers=num_workers)
        dt = time.perf_counter() - t0
        if counters:
            launches.append(counters[1]())
        if r.total != len(records) or r.failed:
            raise RuntimeError(f"a pass evaluated {r.as_dict()} of "
                               f"{len(records)} clips")
        e2e.append(len(records) / dt)
    res["clips_per_sec_e2e"] = round(float(np.median(e2e)), 2)
    res["e2e_passes"] = [round(x, 2) for x in sorted(e2e)]
    res["ledger"] = ledger(res, batch_clips, num_workers)
    if counters:
        res["launches_per_pass"] = launches
    return res


def print_ledger(res, workers: int) -> None:
    """The readable ledger, and what its terms mean on a card attached
    directly to its host."""
    print("\nper-clip ledger (ms):")
    for k, v in res["ledger"].items():
        print(f"  {k:28s} {v:8.2f}")
    print(f"\nOn a card attached directly to its host, dispatch_rtt_ms "
          f"({res['dispatch_rtt_ms']} ms a batch, single minus deep) is the "
          f"host's launch and sync cost per batch, with no transport round "
          f"trip in it; implied_transfer_mbps "
          f"({res['implied_transfer_mbps']} MB/s) covers the copy from "
          f"pageable into pinned memory plus PCIe.  The bound is "
          f"max(decode/workers, device) = "
          f"max({res['decode_ms_per_clip']:.1f}/{workers}, "
          f"{res['ledger']['device_compute_per_clip']:.1f}) ms/clip.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    args = ap.parse_args(argv)

    import torch

    from video_analytics_tpu_torch.config import PipelineConfig
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.utils.device import (
        card_name, require_cuda)

    device = require_cuda(args.device)
    cfg = PipelineConfig(flow_algo="farneback", window=16)
    model = TwoStreamModel.create(num_classes=101, flow_stack=FLOW_STACK,
                                  dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    with tempfile.TemporaryDirectory(prefix="torch_eval_breakdown_") as root:
        records = build_synthetic_ucf101(
            root, num_classes=NUM_CLASSES, clips_per_class=CLIPS_PER_CLASS,
            num_frames=NUM_FRAMES, h=SRC_H, w=SRC_W,
            train_fraction=0.0).test_records()
        res = breakdown(records, model, cfg, device)
    print(card_name(device), flush=True)
    print(json.dumps(res), flush=True)
    print_ledger(res, NUM_WORKERS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
