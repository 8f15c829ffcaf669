"""Closed-loop batch traffic: a dataset evaluation or offline tagging job
with decode left out.

The traffic file gives ``batch_clips`` (clips a call), ``frames`` (a
clip's window), ``pool_clips`` (clips made from the seed and held in
host memory as decoded uint8 frames) and ``content`` (``clips.py``).
Batch k takes the pool's clips [B·(k mod P/B), B·(k mod P/B) + B), is
cut to the source region of the device crop (``apply_transport_crop``,
as ``evaluate_batched`` does) and handed to the program's
``DevicePrefetcher``, whose worker thread copies it into a pinned buffer
and on to the card ahead of the batches it is running; the host then
launches ``classify_batch`` and queues the probabilities for the host
behind it, and waits for batch k only after launching batch k + 1, so
the card always holds the next batch.

End to end: ``clips_per_s``, all clips whose probabilities reached host
memory over the whole window (from the first batch's start to the last
batch's answer), and ``setup_s``.  The comparison: one checked clip per
batch slot, drawn from the seed; every answer of those clips in the
window against the reference's, and the flow stacks that the temporal
stream took for each checked clip (its first batch in the window, read
by a forward pre-hook on ``model.temporal``) against the reference's
flow, stacked and rounded to the same dtype.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_h100 import clips, harness, trace, weights, work
from bench_h100.reference import pipeline as ref

PREFETCH_DEPTH = 2


class BatchView:
    """What the per-layer metrics of a batch cell read."""

    kind = "batch"

    def __init__(self, loop: "BatchLoop"):
        self._loop = loop
        self.config = loop.cfg
        self.window_s = 0.0
        self.batches = 0
        self.batch_clips = loop.B
        self.n_distinct = loop.n_distinct
        self.host_prep_ms: Optional[float] = None
        self.batch_counts: Dict[int, int] = {}
        self.slice: Optional[trace.Slice] = None
        self._levels: Dict[int, list] = {}

    def flow_levels(self, j: int):
        """TV-L1's recorded levels for distinct batch j (None for
        Farneback)."""
        if self.config["flow"]["algo"] != "tvl1":
            return None
        if j not in self._levels:
            loop = self._loop
            gray = loop.gray_batch(j)
            _, self._levels[j] = loop.program.recorded_rounds(
                lambda: loop.program.batch_flow(gray, loop.pcfg))
        return self._levels[j]

    def flow_work(self, j: int) -> work.Work:
        return work.flow_work(self.config, self.batch_clips, self._loop.T,
                              self.flow_levels(j))

    def batch_work(self, j: int) -> work.Work:
        loop = self._loop
        return work.two_stream_work(self.config, loop.B, loop.T,
                                    loop.src_hw, self.flow_work(j))

    def flow_seconds(self) -> Optional[float]:
        """Device-busy seconds (torch.profiler) of one pass over every
        distinct batch's flow call; None without a device trace."""
        loop = self._loop
        grays = [loop.gray_batch(j) for j in range(loop.n_distinct)]
        return trace.busy_seconds(
            lambda: [loop.program.batch_flow(g, loop.pcfg) for g in grays],
            reps=1)

    def cnn_seconds(self):
        """(device-busy seconds (torch.profiler) of both streams on batch
        0's inputs, or None without a device trace; their Work)."""
        loop = self._loop
        p, pcfg, model = loop.program, loop.pcfg, loop.model
        x, bcfg = loop.host_batch(0)
        with torch.no_grad():
            cropped = p.crop(x, bcfg)
            rgb = p.normalize(cropped, bcfg).reshape(-1, *cropped.shape[2:])
            flow = p.batch_flow(p.gray(cropped), pcfg)
            stacks = p.flow_stacks(flow, pcfg, model.temporal.dtype)

            def both():
                model.spatial(rgb)
                model.temporal(stacks)
            s = trace.busy_seconds(both, reps=5)
        spatial, temporal = work.model_cnn_work(self.config, rgb.shape[0],
                                                stacks.shape[0])
        return s, spatial + temporal


class BatchLoop:
    def __init__(self, run):
        self.program = run.program
        self.cfg, self.tr, self.device = run.config, run.traffic, run.device
        self.B = self.tr["batch_clips"]
        self.T = self.tr["frames"]
        self.P = self.tr["pool_clips"]
        self.n_distinct = self.P // self.B
        content = self.tr["content"]
        self.src_hw = (content["height"], content["width"])
        self.weights = weights.make_weights(run.seed, self.device,
                                            self.cfg["model"])
        self.model = self.program.build_model(self.cfg, self.weights,
                                              self.device)
        self.pcfg = self.program.pipeline_config(self.cfg)
        made = clips.make_clips(run.seed, [self.T] * self.P, content,
                                self.device)
        self.pool = torch.stack(made).cpu().numpy()
        del made
        if self.device.type == "cuda":     # the program's peak, not the
            torch.cuda.reset_peak_memory_stats(self.device)   # clips'
        self.crop_s, self.crops = 0.0, 0
        self.prefetcher = self.program.device_prefetcher(
            self.host_batches(), PREFETCH_DEPTH, self.device)
        self.batches = iter(self.prefetcher)
        # The temporal stream's input for each checked slot (slot s of
        # distinct batch want[s]), from its first batch while capturing.
        pre = self.cfg["preprocess"]
        self.n_stacks = self.T - pre["flow_stack"]
        self.want: List[int] = []
        self.stacks: Dict[int, torch.Tensor] = {}
        self._grab: List[int] = []

    def host_batches(self):
        """(k, windows, config) for k = 0, 1, ...: distinct batch k mod
        P/B cut to the crop's source region, on the host; the
        prefetcher's worker thread draws them."""
        k = 0
        while True:
            t = time.perf_counter()
            j = k % self.n_distinct
            wins, bcfg = self.program.with_transport_crop(
                self.pool[j * self.B:(j + 1) * self.B], self.pcfg)
            self.crop_s += time.perf_counter() - t
            self.crops += 1
            yield k, wins, bcfg
            k += 1

    def host_batch(self, j: int):
        """Distinct batch j cut and copied to the card at once, for the
        per-layer readers: (device uint8 windows, its config)."""
        wins, bcfg = self.program.with_transport_crop(
            self.pool[j * self.B:(j + 1) * self.B], self.pcfg)
        return torch.from_numpy(wins).to(self.device), bcfg

    def host_prep_ms(self) -> float:
        """Host milliseconds a batch spends being cut and placed (the
        crop, then the prefetcher's pinned copy and issue), off the
        launching thread."""
        put = self.prefetcher.stats
        return 1e3 * (self.crop_s / max(1, self.crops)
                      + put["put_s"] / max(1, put["batches"]))

    def capture(self, module, args):
        x = args[0]
        n = self.n_stacks
        for s in self._grab:
            if x.shape[0] >= (s + 1) * n:
                self.stacks[s] = x[s * n:(s + 1) * n].clone()
        self._grab = []

    def gray_batch(self, j: int) -> torch.Tensor:
        p = self.program
        x, bcfg = self.host_batch(j)
        with torch.no_grad():
            return p.gray(p.crop(x, bcfg))

    def launch(self, capturing: bool = False):
        rf = torch.profiler.record_function
        with rf("bench/prefetch_wait"):
            k, x, bcfg = next(self.batches)
        if capturing:
            j = k % self.n_distinct
            self._grab = [s for s, w in enumerate(self.want)
                          if w == j and s not in self.stacks]
        with rf("bench/classify"), torch.no_grad():
            probs = self.program.classify_batch(x, self.model, bcfg)
        out = probs.to("cpu", non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return k, out, done

    def finish(self, pending) -> np.ndarray:
        k, out, done = pending
        with torch.profiler.record_function("bench/fetch"):
            if done is not None:
                done.synchronize()
        return out.numpy()

    def drive(self, seconds: float, outputs: Optional[list]) -> tuple:
        """Batches until `seconds` have passed (none launched after), the
        last answered; with `outputs`, each answer is kept and the
        checked slots' flow stacks are captured.  Returns (batches,
        window seconds)."""
        n, pending = 0, None
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            nxt = self.launch(outputs is not None)
            n += 1
            if pending is not None:
                arr = self.finish(pending)
                if outputs is not None:
                    outputs.append((pending[0], arr))
            pending = nxt
            if time.perf_counter() >= end:
                break
        arr = self.finish(pending)
        if outputs is not None:
            outputs.append((pending[0], arr))
        return n, time.perf_counter() - t0


def run(run) -> dict:
    loop = BatchLoop(run)
    # Every shape of the window, and every pinned buffer of the
    # prefetcher's pool.
    for _ in range(PREFETCH_DEPTH + 1):
        loop.finish(loop.launch())
    B, n_distinct, T = loop.B, loop.n_distinct, loop.T
    checked = np.random.default_rng([run.seed, 2]).integers(
        0, n_distinct, size=B)
    loop.want = [int(j) for j in checked]
    temporal = getattr(loop.model, "temporal", None)
    hook = (temporal.register_forward_pre_hook(loop.capture)
            if isinstance(temporal, torch.nn.Module) else None)
    setup_s = time.perf_counter() - run.t_start
    outputs: List[tuple] = []
    n, window_s = loop.drive(run.seconds, outputs)
    if hook is not None:
        hook.remove()
    view = BatchView(loop)
    view.window_s, view.batches = window_s, n
    view.host_prep_ms = loop.host_prep_ms()
    for k, _ in outputs:
        j = k % loop.n_distinct
        view.batch_counts[j] = view.batch_counts.get(j, 0) + 1
    device = harness.device_info(run.device, run.cell["chips"])
    breakdown = None
    if run.trace:
        view.slice = trace.profiled(
            lambda s: (s.start(), loop.drive(trace.SLICE_S, None),
                       s.stop()))
    per_layer = run.read_metrics(view) if run.trace else {}
    loop.prefetcher.close()
    e2e = {"clips_per_s": n * loop.B / window_s, "setup_s": setup_s}
    if view.slice is not None:
        device.update(busy_s=view.slice.busy_s,
                      window_s=view.slice.window_s)
        breakdown = view.slice.breakdown()

    # The comparison, once the program's state is freed.
    wins = np.stack([loop.pool[j * B + s] for s, j in enumerate(checked)])
    w = loop.weights
    got_stacks = {s: x.float().cpu() for s, x in loop.stacks.items()}
    stack_dtype = {s: x.dtype for s, x in loop.stacks.items()}
    recorded = view._levels           # TV-L1's rounds, read by the metrics
    del loop, view, hook
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref_levels: list = []
    with torch.no_grad():
        expect = ref.classify(torch.from_numpy(wins).to(run.device),
                              run.config, w, rounds=ref_levels).cpu().numpy()
    if recorded:
        same, total = rounds_agree(recorded, ref_levels, checked, T - 1)
        harness.note(f"TV-L1 rounds of the checked clips equal to the "
                     f"reference's in {same} of {total} image-warps")
    answers = [(arr[s], expect[s]) for k, arr in outputs
               for s in range(B) if k % n_distinct == checked[s]]
    pre = run.config["preprocess"]
    flow = ref.classify.last_flow
    ran = {k % n_distinct for k, _ in outputs}
    stacks = [(got_stacks.get(s),
               ref.flow_stacks(flow[s], pre["flow_stack"], pre["flow_bound"]
                               ).to(stack_dtype.get(s, torch.float32)
                                    ).float().cpu())
              for s in range(B) if checked[s] in ran]
    return {"attempted": n * B, "failed": 0, "e2e": e2e,
            "per_layer": per_layer, "device": device,
            "breakdown": breakdown, "answers": answers,
            "stacks": stacks, "flow_bound": pre["flow_bound"]}


def rounds_agree(recorded, ref_levels, checked, pairs: int):
    """(equal, total) image-warps: the program's rounds for the checked
    clips (slot s of distinct batch checked[s]) against the reference's
    on the same clips (its slot s), level by level."""
    same = total = 0
    for s, j in enumerate(checked):
        if int(j) not in recorded:
            continue
        for mine, theirs in zip(recorded[int(j)], ref_levels):
            if mine.solver != "warp":
                continue
            a = mine.rounds[s * pairs:(s + 1) * pairs].cpu()
            b = theirs.rounds[s * pairs:(s + 1) * pairs].cpu()
            same += int((a == b).sum())
            total += a.numel()
    return same, total
