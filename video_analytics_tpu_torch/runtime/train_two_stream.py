"""Two-stream training: spatial, flow-stream or joint fine-tuning.

Port of ``video_analytics_tpu/runtime/train_two_stream.py``, on one
device or, with ``parallel/mesh``, one process per device, each holding
its own rows of the global batch:

- ``build_examples`` turns a batch of uint8 frame windows into training
  inputs for either or both streams on the device: resize → a random crop
  and flip shared by a window's frames → the normalized middle frame, and
  dense flow over the cropped window (the port's kernels on a GPU) →
  stacked 2L-channel input.  The flow never leaves the device between the
  solver and the CNN.  The crop draws are an argument (``draw_crops`` makes
  them from a ``torch.Generator``): the reference draws them from its PRNG
  key inside the jitted function.
- per-stream train steps (``runtime/train.make_train_step``);
- ``train_iter``, the loop the ``train`` command runs: one batch from the
  feed, its examples, one step per stream;
- ``two_stream_variables``: the checkpoint tree of both streams, which
  ``classify-clip`` and ``eval-ucf101`` of either package load.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.models.spynet import SpyNet
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.parallel.mesh import (
    process_count, process_index)
from video_analytics_tpu_torch.runtime.pipeline import _sequence_flow
from video_analytics_tpu_torch.runtime.profiling import StageTimer
from video_analytics_tpu_torch.runtime.train import (
    TrainState, create_train_state, make_train_step)

STREAMS = ("rgb", "flow", "both")

Crops = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def train_window_len(cfg: PipelineConfig) -> int:
    """Frames per training window: enough for one flow stack."""
    return cfg.preprocess.flow_stack + 1


def _stage(timer: Optional[StageTimer], name: str, fence=None):
    return (contextlib.nullcontext() if timer is None
            else timer.stage(name, fence))


def draw_crops(generator: torch.Generator, windows: torch.Tensor,
               cfg: PipelineConfig) -> Crops:
    """One crop offset (and flip, with ``cfg.preprocess.random_flip``) per
    window of a (B, T, H, W, 3) batch, at the size ``resize_short``
    gives its frames.  In a group of processes, each holding B rows of the
    global batch, every process draws for the whole global batch (the
    generators are seeded alike) and keeps its own rows, so the crops are
    those of one process drawing for the global batch."""
    B, _, H, W, _ = windows.shape
    pre = cfg.preprocess
    h, w = pp.short_side_hw(H, W, pre.resize_short)
    draws = pp.sample_crop_flip(generator, B * process_count(), h, w,
                                pre.crop, pre.random_flip)
    first = B * process_index()
    return tuple(d[first:first + B] for d in draws)


@torch.no_grad()
def build_examples(windows: torch.Tensor, cfg: PipelineConfig, stream: str,
                   crops: Crops, plain: bool = False,
                   timer: Optional[StageTimer] = None,
                   flow_net: Optional[SpyNet] = None
                   ) -> Dict[str, torch.Tensor]:
    """(B, T, H, W, 3) uint8 frame windows → per-stream training inputs.

    Returns {"rgb": (B, c, c, 3)} and/or {"flow": (B, c, c, 2L)} (NHWC, the
    networks' input layout) with c = cfg.preprocess.crop and L =
    cfg.preprocess.flow_stack (T >= L + 1).  `crops` are the (tops, lefts,
    flips) host tensors of ``draw_crops``: one crop per window, shared by
    its frames, so the flow sees a temporally coherent crop.  Flipping
    frames negates the flow's u channel, which suits flip-invariant labels
    only: leave ``cfg.preprocess.random_flip`` off (``--no-flip``) for
    direction-sensitive ones.  The flow of the L consecutive pairs of
    every window runs as one batch (``runtime/pipeline._sequence_flow``:
    the same flow as the reference's ``compute_flow`` on the B·L pairs,
    with Farneback's per-frame work once per frame); ``plain=True`` runs
    the kernels' plain versions.  With ``flow_algo="spynet"`` the flow is
    the frozen `flow_net` (the reference's ``flow_variables``): the flow
    stream trains on learned flow while SpyNet itself stays fixed.  Under
    ``torch.no_grad`` (not ``inference_mode``: the outputs feed a backward
    pass); with `timer`, the stage ``flow`` is timed with a device
    fence."""
    if stream not in STREAMS:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    pre = cfg.preprocess
    B, T = windows.shape[:2]
    L = pre.flow_stack
    if not pre.random_flip and bool(crops[2].any()):
        raise ValueError("crops flip windows but random_flip is off")
    x = pp.resize_short_side(windows, pre.resize_short)
    x = pp.crop_flip(x, *crops, pre.crop)               # (B, T, c, c, 3)
    out: Dict[str, torch.Tensor] = {}
    if stream in ("rgb", "both"):
        out["rgb"] = pp.normalize(x[:, T // 2], pre.mean, pre.std)
    if stream in ("flow", "both"):
        if T < L + 1:
            raise ValueError(f"need window >= {L + 1} frames, got {T}")
        with _stage(timer, "flow", windows.device):
            gray = pp.rgb_to_gray(x[:, :L + 1])        # (B, L + 1, c, c)
            flow = _sequence_flow(gray, cfg, plain,     # (B, L, c, c, 2)
                                  flow_net)
        c = flow.shape[2]
        # (B, c, c, L, 2) → channels ordered [u0, v0, u1, v1, ...], as
        # ops.preprocess.stack_flow_windows orders them.
        stacks = flow.permute(0, 2, 3, 1, 4).reshape(B, c, c, 2 * L)
        out["flow"] = pp.normalize_flow_stack(stacks, pre.flow_bound)
    return out


def create_two_stream_states(model: TwoStreamModel, lr: float,
                             stream: str) -> Dict[str, TrainState]:
    """One TrainState per trained stream (keys 'rgb', 'flow'), each
    training that stream of `model` in place."""
    states: Dict[str, TrainState] = {}
    if stream in ("rgb", "both"):
        states["rgb"] = create_train_state(model.spatial, lr)
    if stream in ("flow", "both"):
        states["flow"] = create_train_state(model.temporal, lr)
    return states


def make_two_stream_train_steps(states: Dict[str, TrainState]
                                ) -> Dict[str, Callable]:
    """Per-stream train steps {name: step(x, y) → metrics}."""
    return {name: make_train_step(s.model, s.optimizer)
            for name, s in states.items()}


def two_stream_variables(model: TwoStreamModel) -> Dict[str, Any]:
    """Both streams' weights as the reference's variable tree
    (``{"spatial": {"params", "batch_stats"}, "temporal": ...}``) through
    ``models/convert.two_stream_torch_to_flax``: what
    ``runtime/checkpoint.save_variables`` writes.  The model owns the
    trained streams' weights; a stream that was not trained keeps its
    initial or loaded values, as in the reference."""
    return model.flax_variables()


def train_iter(feed: Iterable[Tuple[torch.Tensor, torch.Tensor]],
               steps: Dict[str, Callable], cfg: PipelineConfig, stream: str,
               generator: torch.Generator,
               timer: Optional[StageTimer] = None,
               flow_net: Optional[SpyNet] = None
               ) -> Iterator[Dict[str, Dict[str, torch.Tensor]]]:
    """The training loop: for each (windows, labels) batch of `feed`, its
    examples (crops drawn from `generator`) and one step of each stream;
    yields {stream: {"loss", "accuracy"}} per step, 0-d device tensors.
    With `timer` the stages ``host_wait`` (the next batch), ``build_examples``
    (of it ``flow``) and ``step_<stream>`` are timed, each fenced on the
    device: the fences stop the host from queueing ahead.  `flow_net`: the
    frozen SpyNet of ``flow_algo="spynet"``."""
    it = iter(feed)
    while True:
        with _stage(timer, "host_wait"):
            try:
                windows, y = next(it)
            except StopIteration:
                return
        with _stage(timer, "build_examples", windows.device):
            examples = build_examples(windows, cfg, stream,
                                      draw_crops(generator, windows, cfg),
                                      timer=timer, flow_net=flow_net)
        metrics = {}
        for name, step in steps.items():
            with _stage(timer, f"step_{name}", windows.device):
                metrics[name] = step(examples[name], y)
        yield metrics
