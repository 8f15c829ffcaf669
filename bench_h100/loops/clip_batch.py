"""Closed-loop batch traffic on two-stream models whose streams take clip
volumes (R(2+1)D): a dataset evaluation or offline tagging job with
decode left out.

The traffic file gives what ``closed_batch.py``'s does (``batch_clips``,
``frames``, ``pool_clips``, ``content``) and the loop is that loop
(``closed_batch.BatchLoop``: batches cut by ``apply_transport_crop``,
placed by the program's ``DevicePrefetcher``, batch k + 1 launched before
batch k is read), with the configuration's R(2+1)D weights
(``weights_r2p1d.py``) in place of the ResNets'.

End to end: ``clips_per_s`` (every window whose probabilities reached
host memory, over the whole window) and ``setup_s``.  The comparison:
one checked window per batch slot, drawn from the seed; every answer of
those windows in the window against ``reference/clip_pipeline.py``'s,
and the flow volume that the temporal stream took for each checked
window (its first batch in the window, read by a forward pre-hook on
``model.temporal``) against the reference's flow, clipped, scaled and
rounded to the same dtype.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_h100 import clips, harness, trace, weights_r2p1d, work_r2p1d
from bench_h100.loops import closed_batch
from bench_h100.reference import clip_pipeline as ref

PREFETCH_DEPTH = closed_batch.PREFETCH_DEPTH


class ClipView(closed_batch.BatchView):
    """What the per-layer metrics of a clip cell read: a batch view whose
    work is R(2+1)D's."""

    def batch_work(self, j: int = 0):
        loop = self._loop
        return work_r2p1d.batch_work(self.config, loop.B, loop.T,
                                     loop.src_hw)

    def cnn_work(self):
        """Both streams' work over one batch."""
        return work_r2p1d.cnn_work(self.config, self._loop.B,
                                   self._loop.T - 1)

    def flow_work(self, j: int = 0):
        return work_r2p1d.flow_work(self.config, self._loop.B, self._loop.T)


class ClipLoop(closed_batch.BatchLoop):
    def __init__(self, run):
        self.program = run.program
        self.cfg, self.tr, self.device = run.config, run.traffic, run.device
        self.B = self.tr["batch_clips"]
        self.T = self.tr["frames"]
        self.P = self.tr["pool_clips"]
        self.n_distinct = self.P // self.B
        content = self.tr["content"]
        self.src_hw = (content["height"], content["width"])
        self.weights = weights_r2p1d.make_weights(run.seed, self.device,
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
        # The temporal stream's volume for each checked slot (slot s of
        # distinct batch want[s]), from its first batch while capturing.
        self.want: List[int] = []
        self.stacks: Dict[int, torch.Tensor] = {}
        self._grab: List[int] = []

    def capture(self, module, args):
        x = args[0]
        for s in self._grab:
            if x.shape[0] > s:
                self.stacks[s] = x[s:s + 1].clone()
        self._grab = []


def run(run) -> dict:
    loop = ClipLoop(run)
    # Every shape of the window, and every pinned buffer of the
    # prefetcher's pool.
    for _ in range(PREFETCH_DEPTH + 1):
        loop.finish(loop.launch())
    B, n_distinct = loop.B, loop.n_distinct
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
    view = ClipView(loop)
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
    got = {s: x.float().cpu() for s, x in loop.stacks.items()}
    dtype = {s: x.dtype for s, x in loop.stacks.items()}
    del loop, view, hook
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        expect = ref.classify(torch.from_numpy(wins).to(run.device),
                              run.config, w).cpu().numpy()
    answers = [(arr[s], expect[s]) for k, arr in outputs
               for s in range(B) if k % n_distinct == checked[s]]
    bound = run.config["preprocess"]["flow_bound"]
    flow = ref.classify.last_flow
    ran = {k % n_distinct for k, _ in outputs}
    stacks = [(got.get(s), ref.volume(flow[s:s + 1], bound).to(
                  dtype.get(s, torch.float32)).float().cpu())
              for s in range(B) if checked[s] in ran]
    return {"attempted": n * B, "failed": 0, "e2e": e2e,
            "per_layer": per_layer, "device": device,
            "breakdown": breakdown, "answers": answers,
            "stacks": stacks, "flow_bound": bound}
