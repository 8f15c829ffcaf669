"""Closed-loop batch traffic on two-stream Video Swins: a dataset
evaluation or offline tagging job with a hierarchical video transformer,
decode left out.

The traffic file gives what ``clip_batch.py``'s does and the loop is
that loop (``clip_batch.ClipLoop``: batches cut by
``apply_transport_crop``, placed by the program's ``DevicePrefetcher``,
batch k + 1 launched before batch k is read, the temporal stream's volume
of each checked window captured by a forward pre-hook), with the
configuration's Video Swin weights (``weights_swin.py``), its work
(``work_swin.py``) and its reference (``reference/swin_pipeline.py``).

End to end: ``clips_per_s`` and ``setup_s``.  The comparison: one checked
window per batch slot, drawn from the seed; every answer of those
windows in the window against the reference's, and the flow volume the
temporal stream took for each checked window against the reference's
flow, clipped, scaled and rounded to the same dtype.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_h100 import clips, harness, trace, weights_swin, work_swin
from bench_h100.loops import clip_batch
from bench_h100.reference import swin_pipeline as ref
from bench_h100.reference.clip_pipeline import volume

PREFETCH_DEPTH = clip_batch.PREFETCH_DEPTH


class SwinView(clip_batch.ClipView):
    """What the per-layer metrics of a Video Swin cell read: a batch view
    whose work is the Video Swin's."""

    def batch_work(self, j: int = 0):
        loop = self._loop
        return work_swin.batch_work(self.config, loop.B, loop.T,
                                    loop.src_hw)

    def cnn_work(self):
        """Both streams' work over one batch."""
        return work_swin.total(self.swin_ops())

    def swin_ops(self):
        """Both streams' operations over one batch."""
        return work_swin.cnn_ops(self.config, self._loop.B, self._loop.T - 1)

    def window_attn_ops(self):
        """The window attention's operations over one batch."""
        return work_swin.attn_ops(self.config, self._loop.B,
                                  self._loop.T - 1)


class SwinLoop(clip_batch.ClipLoop):
    def __init__(self, run):
        self.program = run.program
        self.cfg, self.tr, self.device = run.config, run.traffic, run.device
        self.B = self.tr["batch_clips"]
        self.T = self.tr["frames"]
        self.P = self.tr["pool_clips"]
        self.n_distinct = self.P // self.B
        content = self.tr["content"]
        self.src_hw = (content["height"], content["width"])
        self.weights = weights_swin.make_weights(run.seed, self.device,
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
        self.want: List[int] = []
        self.stacks: Dict[int, torch.Tensor] = {}
        self._grab: List[int] = []


def run(run) -> dict:
    loop = SwinLoop(run)
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
    view = SwinView(loop)
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
    stacks = [(got.get(s), volume(flow[s:s + 1], bound).to(
                  dtype.get(s, torch.float32)).float().cpu())
              for s in range(B) if checked[s] in ran]
    return {"attempted": n * B, "failed": 0, "e2e": e2e,
            "per_layer": per_layer, "device": device,
            "breakdown": breakdown, "answers": answers,
            "stacks": stacks, "flow_bound": bound}
