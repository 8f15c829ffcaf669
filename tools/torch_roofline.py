"""Roofline and MFU of the PyTorch port's hot programs on an NVIDIA H100:
the counterpart of tools/roofline.py (the same nine programs, names,
shapes, timing discipline, JSON keys and table), on the first CUDA device
unless --device says otherwise.

    python3 tools/torch_roofline.py [--skip-1080p] [--reps N] [--device cuda:1]

For each program: wall ms per call (the median over 3 deep groups of
--reps calls, each call's first input perturbed in place by a device
scalar, one host sync per group on a value that depends on every output,
after one warm call), the same group's CUDA-event time as ``device_ms``,
and its work: GFLOP and GB, TFLOP/s, GB/s, FLOP per byte, and the share
of each peak of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):

  - ``mfu_mxu_pct``: the bfloat16 products of the CNNs (the only work the
    tensor cores take here; the reference's MXU) against 989 TFLOP/s;
  - ``mfu_vpu_pct``: the float32 work (flow, preprocessing, stacking: the
    CUDA cores, the reference's VPU) against 67 TFLOP/s;
  - ``hbm_pct``: the bytes against HBM3's 3.35 TB/s.

Each share counts only the work that runs on that unit, so none can pass
100 % unless the count is wrong: the tool raises then rather than print
it.  Printed beside the rows: the card's name and power limit (nvidia-smi)
and the peaks.

The work is counted here, from the configuration, the shapes and, for
TV-L1, the rounds the ε test let each image run; never from what a
kernel's code happens to do, so a redesigned kernel keeps its yardstick.
The reference read its count from XLA's cost model, which counted a
300-iteration solve as one iteration and rode the Pallas calls' estimates;
PyTorch has no such model, and ``FlopCounterMode`` does not see the
ctypes launches of ``csrc/``.  Per stage:

  - preprocessing: the fused resize and crop (2 taps a multiply and an add
    along rows, then along columns), gray (5 a pixel), normalize (3 an
    element), flow stacking (clip and scale, 3 a flow element);
  - Farneback, per level: the prologue's blur, resize and polynomial
    expansion, and per iteration 100 operations a pixel for the warp and
    normal equations, 2·2·taps·5 for the window and 12 for the solve
    (``farneback_kernel_work``);
  - TV-L1, per scale: 45 operations a pixel and warp (3 bilinear samples
    and the prep), 70 a pixel and primal-dual iteration and 2·2·113 a
    round for the 5×5 median (a min and a max per compare-exchange of the
    pruned network, on u and v) for the rounds each image (each row band
    on a chunked level) ran, and the scale-end median; the pyramid and the
    gradients, plain tensor code, are not counted;
  - the CNNs: 2 per multiply-add of every convolution and linear layer
    that runs, every tap included (XLA's count leaves out the taps that
    fall in the padding); BatchNorm, ReLU, the residual add and pooling,
    which can ride a convolution's epilogue, are not counted.  The same
    count of the port's R(2+1)D-34 over clip volumes (its 3-D
    convolutions): ``r2plus1d_work``, which ``bench_h100/work_r2p1d.py``
    keeps frozen.  The port's TimeSformer: every product (the patch
    embedding, each projection, the attention products Q·Kᵀ and
    weights·V, the MLP, the head) as one operation, its bytes its
    operands and output once (Q, K, V and the output for attention):
    ``timesformer_ops``, which ``bench_h100/work_tsf.py`` keeps frozen.

Bytes are per stage, each input read once and each output written once
(a CNN layer's input, weights and output in the layer's dtype; a TV-L1
scale's I1, gradients, I0 and flow read and flow written): a floor, not
XLA's "bytes accessed", which counts every operand of every HLO.  A
TV-L1 row counts the rounds of its warm call (``"count": "rounds"``);
the other rows' work is fixed by their shapes (``"count": "shapes"``).

The reference's headline and flow-sequence programs pass ``bounded=True``
(the reduced warp envelope), which the port does not have: its warp is
always the exact gather (``PARAMS_NOT_PORTED``).  With --device cpu the
programs run on the CPU and every share and ``device_ms`` is null (the
peaks are the card's); with --device cuda and no card it fails, with no
fallback.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The reference's sizes, copied from bench.py:31-42 (this tool does not
# import bench.py, which imports JAX).
SRC_H, SRC_W = 240, 320
N_FRAMES = 65
FLOW_STACK = 10

# One H100 SXM, NVIDIA's data sheet, dense, at the full 700 W.
BF16_FLOP_PER_S = 989e12       # bfloat16 on the tensor cores ("MXU")
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores ("VPU")
HBM_BYTES_PER_S = 3.35e12      # HBM3

NAMES = ("headline_64f", "preproc_resize_crop", "farneback_seq_64p",
         "flow_cnn_55x224", "rgb_cnn_65x224", "tvl1_64p_224",
         "eval_batch_8clips", "sustained_1080p_b4x16", "tvl1_1080p_b4")

# TV-L1 operations a pixel: one warp's 3 bilinear samples and the
# solver's prep; one primal-dual iteration.
TVL1_WARP_OPS = 45
TVL1_PD_OPS = 70
# Compare-exchanges of the pruned 25-input median network; every median
# is counted at it (the 5x5 median is the default and the only one on a
# path).
BATCHER_25 = 113
# Farneback operations a pixel: K-E's 5 bilinear samples and the normal
# equations; the 2x2 solve.
FB_NEQ_OPS = 100
FB_SOLVE_OPS = 12


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved (each input read once, each output written once) and
    operations: float32 ones on the CUDA cores and bfloat16 products on
    the tensor cores."""

    bytes: int = 0
    f32: int = 0
    bf16: int = 0

    @property
    def flops(self) -> int:
        return self.f32 + self.bf16

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.f32 + other.f32,
                    self.bf16 + other.bf16)

    def __mul__(self, k: int) -> "Work":
        return Work(self.bytes * k, self.f32 * k, self.bf16 * k)

    __rmul__ = __mul__


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    `nbytes` (each input read once, each output written once) or to do
    `flops` float32 operations, whichever is larger."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOP_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# -- TV-L1 ---------------------------------------------------------------------

def median_ops(k: int) -> int:
    """Operations a pixel of one median of u and v (k > 1): a min and a
    max per compare-exchange of the pruned 5×5 network, on each plane."""
    return 2 * 2 * BATCHER_25 if k > 1 else 0


def tvl1_level_work(pixel_rounds: int, images: int, h: int, w: int,
                    warps: int, inner: int, median_k: int) -> Work:
    """One TV-L1 pyramid scale of `images` images of h×w: I1, its two
    gradients, I0, u and v read and u, v written once; the warps' prep,
    the solver's iterations and medians for `pixel_rounds` (the outer
    rounds run, summed over images and warps, each weighted by the pixels
    that ran it), and the scale-end median."""
    px = h * w
    med = median_ops(median_k)
    return Work(bytes=8 * 4 * px * images,
                f32=images * px * (TVL1_WARP_OPS * warps + med)
                + (TVL1_PD_OPS * inner + med) * pixel_rounds)


def scale_work(rounds, h: int, w: int, inner: int, median_k: int) -> Work:
    """One ``tvl1_scale`` launch: `rounds`, a list per image of the rounds
    it ran in each warp."""
    return tvl1_level_work(h * w * sum(sum(r) for r in rounds), len(rounds),
                           h, w, len(rounds[0]), inner, median_k)


def scale_bound(rounds, h: int, w: int, inner: int, median_k: int):
    """Bound of one ``tvl1_scale`` launch (``scale_work``)."""
    work = scale_work(rounds, h, w, inner, median_k)
    return bound(work.bytes, work.f32)


def chunk_bound(B: int, h: int, w: int, iters: int, median_k: int):
    """Bound of one K-G launch: 10 planes read and 6 written once, against
    `iters` primal-dual iterations a pixel plus, with the median, its
    compare-exchanges."""
    px = B * h * w
    return bound(16 * 4 * px, (TVL1_PD_OPS * iters + median_ops(median_k))
                 * px)


def tvl1_work(levels, cfg) -> Work:
    """A ``tvl1`` call's work from its levels' ``LevelRounds`` (what
    ``rounds_of`` records): every scale by ``tvl1_level_work``, whichever
    solver ran it."""
    total = Work()
    for lv in levels:
        h, w = lv.hw
        r = lv.rounds.cpu().long()
        if lv.solver == "chunked":
            rows = [min(lv.band, h - lv.band * i) for i in range(r.shape[-1])]
            pixel_rounds = sum(int(n) * rows[i] * w
                               for i, n in enumerate(r.sum(dim=(0, 1))))
            images = r.shape[1]
        else:
            pixel_rounds = int(r.sum()) * h * w
            images = r.shape[0] if lv.solver == "warp" else r.shape[1]
        total += tvl1_level_work(pixel_rounds, images, h, w, cfg.warps,
                                 cfg.inner_iterations, cfg.median_filtering)
    return total


def tvl1_budget_work(B: int, H: int, W: int, cfg) -> Work:
    """A ``tvl1`` call's work if every image ran every round: the count a
    route that cannot report its rounds would give."""
    from video_analytics_tpu_torch.flow.tvl1 import _level_sizes

    return sum((tvl1_level_work(B * cfg.warps * cfg.outer_iterations * h * w,
                                B, h, w, cfg.warps, cfg.inner_iterations,
                                cfg.median_filtering)
                for h, w in _level_sizes(H, W, cfg)), Work())


def rounds_of(fn, args):
    """One call ``fn(*args)`` with ``tvl1.rounds`` recording: the list of
    ``LevelRounds`` of every ``tvl1`` call it made."""
    from video_analytics_tpu_torch.flow.tvl1 import tvl1

    log = []
    tvl1.rounds = log
    try:
        fence([fn(*args)])
    finally:
        tvl1.rounds = None
    return log


# -- Farneback -----------------------------------------------------------------

def farneback_kernel_work(frames: int, pairs: int, H: int, W: int, lh: int,
                          lw: int, scale: float, n_blur: int, n_poly: int,
                          taps: int):
    """{kernel: (bytes, operations)} of each Farneback kernel at one
    pyramid level of (lh, lw), for `frames` frames of H×W through the
    prologue and `pairs` pairs through an iteration; `n_blur` taps of the
    pre-blur, `n_poly` of the expansion, `taps` of the window.  Bytes:
    inputs read once, outputs written once.  Operations: the separable
    algorithm's multiplies and adds (blur 2 passes, 2 taps of each resized
    axis, 3 vertical + 6 horizontal expansion sums and the combine; 5
    bilinear samples and the normal equations; one multiply-add per tap
    and plane; the solve)."""
    px, lpx, ppx = frames * H * W, frames * lh * lw, pairs * lh * lw
    resize = (3 * frames * lh * W + 3 * lpx) if scale < 1 else 0
    window = 2 * taps * 5
    return {
        "fb_prologue": (4 * px + 20 * lpx,
                        4 * n_blur * px + resize + (18 * n_poly + 8) * lpx),
        "fb_warp_neq": (17 * 4 * ppx, FB_NEQ_OPS * ppx),
        "sep_corr": (10 * 4 * ppx, window * ppx),
        "sep_corr_x_solve": (7 * 4 * ppx, (window + FB_SOLVE_OPS) * ppx),
        # M read and the flow written; both passes and the solve.
        "fb_window_solve": (7 * 4 * ppx, (2 * window + FB_SOLVE_OPS) * ppx),
        # R0, R1 and the flow read, the flow written; K-E's operations too.
        "fb_iteration": (14 * 4 * ppx,
                         (FB_NEQ_OPS + 2 * window + FB_SOLVE_OPS) * ppx)}


def farneback_work(frames: int, pairs: int, H: int, W: int, cfg) -> Work:
    """A Farneback flow call over `frames` distinct frames of H×W and
    `pairs` pairs (the sequence form): per level the prologue once a frame
    and ``cfg.iterations`` iterations, each as one fused iteration."""
    from video_analytics_tpu_torch.flow.farneback import (
        _level_sizes, _smooth_taps)
    from video_analytics_tpu_torch.ops.kernels import farneback_window_taps

    taps = len(farneback_window_taps(cfg.winsize, cfg.gaussian_window))
    total = Work()
    for lh, lw, scale in _level_sizes(H, W, cfg):
        k = farneback_kernel_work(frames, pairs, H, W, lh, lw, scale,
                                  len(_smooth_taps(scale)),
                                  2 * cfg.poly_n + 1, taps)
        total += Work(*k["fb_prologue"])
        total += cfg.iterations * Work(*k["fb_iteration"])
    return total


# -- preprocessing and the CNNs ------------------------------------------------

def resize_crop_work(n: int, src_hw: Tuple[int, int], short: int,
                     crop: int) -> Work:
    """The fused resize of the short side and centre crop of `n` uint8 RGB
    frames of `src_hw`: the source window it samples read, the float32
    crop written; two taps a multiply and an add along rows, then along
    columns."""
    from video_analytics_tpu_torch.ops.preprocess import crop_source_geometry

    (r0, r1, c0, c1), _, _ = crop_source_geometry(*src_hw, short, crop)
    return Work(bytes=n * 3 * ((r1 - r0) * (c1 - c0) + 4 * crop * crop),
                f32=n * 3 * 4 * crop * ((c1 - c0) + crop))


def gray_work(pixels: int) -> Work:
    """``rgb_to_gray``: 3 float32 channels read, one written; 3 multiplies
    and 2 adds."""
    return Work(bytes=16 * pixels, f32=5 * pixels)


def normalize_work(pixels: int, out_size: int = 4) -> Work:
    """``normalize`` of 3 float32 channels a pixel, written in `out_size`
    bytes an element: a scale, a shift and a division."""
    return Work(bytes=3 * pixels * (4 + out_size), f32=9 * pixels)


def stack_work(flows: int, stacks: int, h: int, w: int, stack: int,
               out_size: int) -> Work:
    """``stacked_flow_input``: `flows` float32 (u, v) fields read, `stacks`
    stacks of 2·`stack` channels written in `out_size` bytes; a clip (2)
    and a scale a flow element."""
    return Work(bytes=8 * flows * h * w + stacks * h * w * 2 * stack
                * out_size, f32=3 * 2 * flows * h * w)


def cnn_work(net, x, return_features: bool = False) -> Work:
    """One forward pass of `net` on a tensor of `x`'s shape and dtype: 2
    operations per multiply-add of every convolution and linear layer
    that runs (from the output shapes that hooks see), in the layer's
    dtype (bfloat16 on the tensor cores); bytes the layer's input, weights
    and output once in that dtype.  Runs the pass on zeros."""
    import torch

    parts = []

    def hook(m, inp, out):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            per = m.in_channels // m.groups * math.prod(m.kernel_size)
        else:
            per = m.in_features
        dtype = getattr(m, "dtype", out.dtype)
        size = torch.empty((), dtype=dtype).element_size()
        params = sum(p.numel() for p in m.parameters(recurse=False))
        ops = 2 * out.numel() * per
        unit = "bf16" if dtype == torch.bfloat16 else "f32"
        parts.append(Work(bytes=size * (inp[0].numel() + params
                                        + out.numel()), **{unit: ops}))

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                               torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(torch.zeros_like(x), return_features=return_features)
    finally:
        for h in hooks:
            h.remove()
    return sum(parts, Work())


def r2plus1d_work(clips: int, frames: int, crop: int, in_channels: int,
                  num_classes: int = 101, width: int = 64,
                  dtype=None) -> Work:
    """One forward pass of the port's R(2+1)D-34 over `clips` clips of
    `frames` frames of crop² with `in_channels` channels (3 for RGB, 2
    for a flow volume): ``cnn_work`` on the model built on the meta
    device, so nothing is computed."""
    import torch
    from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34

    dtype = torch.bfloat16 if dtype is None else dtype
    with torch.device("meta"):
        net = r2plus1d_34(num_classes, in_channels, dtype, width).eval()
        x = torch.empty((clips, frames, crop, crop, in_channels),
                        dtype=dtype)
    return cnn_work(net, x)


def timesformer_ops(clips: int, in_channels: int, num_classes: int = 101,
                    width: int = 768, dtype=None):
    """[(name, Work)]: every product of one forward pass of the port's
    TimeSformer-Base (``models/timesformer``) at `width` over `clips`
    clips of its own frames and image size, in order: the patch
    embedding; per block the time half's qkv, attention, proj and
    temporal_fc, the space half's qkv, attention and proj, the MLP's fc1
    and fc2 over the clip's 1 + T·P tokens; the head (float32).  The
    shapes are read from the model, built on the meta device."""
    import torch
    from video_analytics_tpu_torch.models.timesformer import (
        timesformer_base)

    dtype = torch.bfloat16 if dtype is None else dtype
    with torch.device("meta"):
        net = timesformer_base(num_classes, in_channels, dtype, width)
    size = torch.empty((), dtype=dtype).element_size()
    D, T, P = net.width, net.frames, net.num_patches
    unit = "bf16" if dtype == torch.bfloat16 else "f32"

    def product(name, layer, rows, size=size, unit=unit):
        n_in, n_out = layer.weight[0].numel(), layer.weight.shape[0]
        params = sum(p.numel() for p in layer.parameters())
        return (name, Work(bytes=size * (rows * (n_in + n_out) + params),
                           **{unit: 2 * rows * n_in * n_out}))

    def attention(name, seqs, length):
        return (name, Work(bytes=size * 4 * seqs * length * D,
                           **{unit: 4 * seqs * length * length * D}))

    patches, frame_tokens = clips * T * P, clips * T * (P + 1)
    ops = [product("patch", net.patch_embed.proj, patches)]
    for b in net.blocks:
        ops += [product("time.qkv", b.temporal_attn.qkv, patches),
                attention("time.attn", clips * P, T),
                product("time.proj", b.temporal_attn.proj, patches),
                product("time.fc", b.temporal_fc, patches),
                product("space.qkv", b.attn.qkv, frame_tokens),
                attention("space.attn", clips * T, P + 1),
                product("space.proj", b.attn.proj, frame_tokens),
                product("mlp.fc1", b.mlp.fc1, clips * (1 + T * P)),
                product("mlp.fc2", b.mlp.fc2, clips * (1 + T * P))]
    ops.append(product("head", net.head, clips, 4, "f32"))
    return ops


def two_stream_work(model, cfg, seqs: int, T: int, src_hw, device,
                    features: bool) -> Work:
    """Both streams over `seqs` windows of T uint8 frames of `src_hw`
    (``classify_batch``, or with `features` the headline's features):
    the resize and crop, normalize and the spatial CNN on every frame;
    gray, one Farneback call over all windows' pairs, the stacks and the
    temporal CNN."""
    import torch

    pre = cfg.preprocess
    c, n, L = pre.crop, seqs * T, pre.flow_stack
    stacks = seqs * (T - 1 - L + 1)
    dt = model.temporal.dtype
    return (resize_crop_work(n, src_hw, pre.resize_short, c)
            + normalize_work(n * c * c)
            + cnn_work(model.spatial, torch.empty((n, c, c, 3),
                                                  device=device), features)
            + gray_work(n * c * c)
            + farneback_work(n, seqs * (T - 1), c, c, cfg.farneback)
            + stack_work(seqs * (T - 1), stacks, c, c, L,
                         torch.empty((), dtype=dt).element_size())
            + cnn_work(model.temporal,
                       torch.empty((stacks, c, c, 2 * L), dtype=dt,
                                   device=device), features))


# -- timing -------------------------------------------------------------------

def _first(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def fence(outs) -> float:
    """One host sync on a value that depends on every output (the first
    tensor of each)."""
    import torch

    return float(torch.stack([_first(o).float().sum() for o in outs]).sum())


def measure(name, fn, args, work, device, reps: int = 8, passes: int = 3,
            counters=None):
    """Time `fn(*args)`: one warm call, then `passes` groups of `reps`
    calls, each call's first argument first perturbed in place by a
    device scalar (no copy, no host sync), one fence a group; the row of
    the reference's keys with ``device_ms`` (CUDA events around each
    group) and ``count``.  `work` is a ``Work``, or a callable that makes
    the warm call itself and returns its ``Work`` (TV-L1: the rounds run).
    With `counters` (zero, read), the launches of the warm call are
    returned beside the row.  On the card a share over 100 % raises."""
    import numpy as np
    import torch

    cuda = device.type == "cuda"
    a0 = args[0]
    pert = torch.arange(1, 256, device=device).to(a0.dtype)
    if counters:
        counters[0]()
    if callable(work):
        work, count = work(), "rounds"
    else:
        fence([fn(*args)])
        count = "shapes"
    launches = counters[1]() if counters else None
    times, dev = [], []
    for p in range(passes):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        outs = []
        for i in range(reps):
            a0[(0,) * a0.dim()].add_(pert[(p * reps + i) % len(pert)])
            outs.append(fn(*args))
        if cuda:
            ev[1].record()
        fence(outs)
        times.append((time.perf_counter() - t0) / reps)
        if cuda:
            dev.append(ev[0].elapsed_time(ev[1]) / reps)
    dt = float(np.median(times))
    row = {"name": name, "ms": 1e3 * dt, "gflop": work.flops / 1e9,
           "gb": work.bytes / 1e9, "tflops": work.flops / dt / 1e12,
           "gbps": work.bytes / dt / 1e9,
           "intensity": work.flops / max(work.bytes, 1),
           "mfu_mxu_pct": None, "mfu_vpu_pct": None, "hbm_pct": None,
           "device_ms": None, "count": count}
    if cuda:
        device_ms = float(np.median(dev))
        row.update(device_ms=device_ms, **shares(name, work, dt))
        shares(name, work, device_ms / 1e3)
    return row, work, launches


def shares(name: str, work: Work, seconds: float):
    """The three shares of the card's peaks, in percent, for `work` done
    in `seconds`.  Raises where one is over 100 %: the count is wrong."""
    out = {"mfu_mxu_pct": 100 * work.bf16 / seconds / BF16_FLOP_PER_S,
           "mfu_vpu_pct": 100 * work.f32 / seconds / F32_FLOP_PER_S,
           "hbm_pct": 100 * work.bytes / seconds / HBM_BYTES_PER_S}
    over = {k: v for k, v in out.items() if v > 100.0}
    if over:
        raise RuntimeError(f"{name}: {over} of a peak in {1e3 * seconds} ms: "
                           f"the work count is wrong")
    return out


# -- the programs -------------------------------------------------------------

def make_frames(n, h, w, seed=0):
    """Synthetic UCF101-like content: band-limited moving texture (the
    reference's ``bench.make_frames``)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 64, w + 64, 3)).astype(np.float32)
    base = cv2.GaussianBlur(base, (11, 11), 0)
    frames = []
    for t in range(n):
        dx, dy = int(2 * t) % 40, int(1.3 * t) % 40
        frames.append(base[dy:dy + h, dx:dx + w].astype(np.uint8))
    return np.stack(frames)


@dataclasses.dataclass(frozen=True)
class Protocol:
    """The sizes of the nine programs: the reference's by default.  Tests
    pass smaller ones; the names stay the reference's."""

    src_hw: Tuple[int, int] = (SRC_H, SRC_W)
    n_frames: int = N_FRAMES
    flow_stack: int = FLOW_STACK
    resize_short: int = 256
    crop: int = 224
    width: int = 64
    eval_clips: int = 8
    window: int = 16
    hd_hw: Tuple[int, int] = (1080, 1920)
    hd_windows: int = 4
    hd_pairs: int = 4
    tvl1: Optional[dict] = None         # TVL1Config fields, else defaults
    farneback: Optional[dict] = None    # FarnebackConfig fields


def build_model(proto: Protocol, device):
    """The reference's model: two bfloat16 ResNet-18s, 101 classes, from
    seed 0, on `device` in eval mode."""
    import torch

    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

    model = TwoStreamModel.create(num_classes=101, flow_stack=proto.flow_stack,
                                  dtype=torch.bfloat16, width=proto.width)
    model.init(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def roofline(proto: Protocol, device, model, reps: int = 8,
             skip_1080p: bool = False, counters=None):
    """The nine programs of tools/roofline.py through the port's functions,
    each measured (``measure``).  Returns (rows, extras): extras holds by
    name each program's ``Work``, its warm call's launches (with
    `counters`), its function and arguments, and for TV-L1 the
    ``LevelRounds`` and the budget's ``Work``."""
    import numpy as np
    import torch

    from video_analytics_tpu_torch.config import (
        FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)
    from video_analytics_tpu_torch.flow.tvl1 import tvl1
    from video_analytics_tpu_torch.ingest.windows import (
        host_resize_short, slice_crop_source)
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime.evaluate import (
        _place_batch, _with_src_hw, batch_clip_metrics)
    from video_analytics_tpu_torch.runtime.pipeline import (
        classify_batch, compute_flow_sequence)

    R = max(2, reps)
    bf16 = torch.bfloat16
    short, crop, L = proto.resize_short, proto.crop, proto.flow_stack
    pre = PreprocessConfig(resize_short=short, crop=crop, flow_stack=L)
    fb = FarnebackConfig(**(proto.farneback or {}))
    tcfg = TVL1Config(**(proto.tvl1 or {}))
    cfg = PipelineConfig(preprocess=pre, farneback=fb, tvl1=tcfg,
                         flow_algo="farneback")
    wcfg = dataclasses.replace(cfg, window=proto.window)
    rows, extras = [], {"work": {}, "launches": {}, "fn": {}, "args": {},
                        "rounds": {}, "budget": {}}

    def run(name, fn, args, work, reps=R, passes=3):
        with torch.no_grad():
            row, w, launches = measure(name, fn, args, work, device, reps,
                                       passes, counters)
        rows.append(row)
        extras["work"][name] = w
        extras["launches"][name] = launches
        extras["fn"][name] = fn
        extras["args"][name] = args

    def counted(name, fn, args, B, H, W):
        """The work of a TV-L1 program from the rounds of one call."""
        def work():
            extras["rounds"][name] = rounds_of(fn, args)
            extras["budget"][name] = tvl1_budget_work(B, H, W, tcfg)
            return tvl1_work(extras["rounds"][name], tcfg)
        return work

    n, c = proto.n_frames, crop
    frames = torch.from_numpy(make_frames(n, *proto.src_hw)).to(device)

    # 1. The headline program (bench.measure_tpu's `features`).
    def features(frames_u8):
        x = pp.resize_short_center_crop(frames_u8, short, crop)
        gray = pp.rgb_to_gray(x)
        flow = compute_flow_sequence(gray, cfg)
        stacks = pp.stacked_flow_input(flow, L, dtype=bf16)
        f_feats = model.temporal(stacks, return_features=True)
        rgb = pp.normalize(x, pre.mean, pre.std)
        r_feats = model.spatial(rgb, return_features=True)
        return f_feats, r_feats
    run("headline_64f", features, (frames,),
        two_stream_work(model, cfg, 1, n, proto.src_hw, device, True))

    # 2. The stage split, each stage a program of its own.
    with torch.no_grad():
        x224 = pp.resize_short_center_crop(frames, short, crop)
        gray = pp.rgb_to_gray(x224).contiguous()

    def preproc(f):
        x = pp.resize_short_center_crop(f, short, crop)
        return pp.normalize(x, pre.mean, pre.std).to(bf16), pp.rgb_to_gray(x)
    run("preproc_resize_crop", preproc, (frames.clone(),),
        resize_crop_work(n, proto.src_hw, short, crop)
        + normalize_work(n * c * c, 2) + gray_work(n * c * c))

    run("farneback_seq_64p", lambda g: compute_flow_sequence(g, cfg),
        (gray.clone(),), farneback_work(n, n - 1, c, c, fb))

    with torch.no_grad():
        flow = compute_flow_sequence(gray, cfg).contiguous()
        rgb_in = pp.normalize(x224, pre.mean, pre.std).contiguous()
    n_stacks = n - 1 - L + 1

    def flow_stack_cnn(fl):
        stacks = pp.stacked_flow_input(fl, L, dtype=bf16)
        return model.temporal(stacks, return_features=True)
    run("flow_cnn_55x224", flow_stack_cnn, (flow,),
        stack_work(n - 1, n_stacks, c, c, L, 2)
        + cnn_work(model.temporal, torch.empty(
            (n_stacks, c, c, 2 * L), dtype=bf16, device=device), True))

    run("rgb_cnn_65x224", lambda x: model.spatial(x, return_features=True),
        (rgb_in,), cnn_work(model.spatial, rgb_in, True))

    # 3. TV-L1 at 224² (the shipped default flow).
    prev, nxt = gray[:-1].clone(), gray[1:].clone()

    def tvl1_224(a, b):
        return tvl1(a, b, tcfg)
    run("tvl1_64p_224", tvl1_224, (prev, nxt),
        counted("tvl1_64p_224", tvl1_224, (prev, nxt), n - 1, c, c),
        reps=max(2, R // 2))

    # 3b. The batched-eval program: 8 clips x 1 window x 16 frames, the
    # transport-cropped 240x320 source.
    E, T = proto.eval_clips, proto.window
    wins = np.stack([make_frames(T, *proto.src_hw, seed=10 + i)
                     for i in range(E)])
    winsc, hw = slice_crop_source(wins, short, crop)
    ecfg = _with_src_hw(wcfg, hw)
    arr, labels, valid = _place_batch(winsc[:, None], np.zeros(E, np.int64),
                                      device)

    def eval_batch(a):
        return batch_clip_metrics(a, labels, valid, model, ecfg)[0]
    run("eval_batch_8clips", eval_batch, (arr,),
        two_stream_work(model, ecfg, E, T, hw, device, False))

    # 4. Sustained 1080p classify (the transport-cropped shape).
    nw = proto.hd_windows
    stream = make_frames(T * nw, *proto.hd_hw, seed=3)
    small = np.stack([host_resize_short(stream[i * T:(i + 1) * T], short)
                      for i in range(nw)])
    small, hw = slice_crop_source(small, short, crop)
    scfg = _with_src_hw(wcfg, hw)
    sj = torch.from_numpy(small).to(device)
    run("sustained_1080p_b4x16", lambda wb: classify_batch(wb, model, scfg),
        (sj,), two_stream_work(model, scfg, nw, T, hw, device, False),
        reps=max(2, R // 2))

    # 5. Native-1080p TV-L1 (the chunked solver), 4 pairs.
    if not skip_1080p:
        import cv2

        H, W = proto.hd_hw
        rng = np.random.default_rng(1)
        big = cv2.GaussianBlur(
            rng.uniform(0, 255, (H + 64, W + 64)).astype(np.float32),
            (15, 15), 0)
        p1 = torch.from_numpy(np.stack(
            [big[16 + i:16 + i + H, 16:16 + W]
             for i in range(proto.hd_pairs)])).to(device)
        n1 = torch.from_numpy(np.stack(
            [big[14 + i:14 + i + H, 18:18 + W]
             for i in range(proto.hd_pairs)])).to(device)
        run("tvl1_1080p_b4", tvl1_224, (p1, n1),
            counted("tvl1_1080p_b4", tvl1_224, (p1, n1), proto.hd_pairs,
                    H, W), reps=2, passes=2)
    return rows, extras


def peaks():
    """The reference's three peak keys, with this card's values."""
    return {"mxu_bf16_tflops": BF16_FLOP_PER_S / 1e12,
            "vpu_f32_tflops_est": F32_FLOP_PER_S / 1e12,
            "hbm_gbps": HBM_BYTES_PER_S / 1e9}


def _cell(v, digits: int = 3) -> str:
    return "not measured" if v is None else f"{v:.{digits}g}"


def print_table(rows) -> None:
    """The reference's markdown table, with the device time and the
    H100's units in its headings."""
    print("\n| program | ms/call | device ms | GFLOP | GB | TFLOP/s | GB/s | "
          "FLOP/B | bf16 tensor-core % | f32 CUDA-core % | HBM % | count |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {_cell(r['ms'], 4)} | "
              f"{_cell(r['device_ms'], 4)} | {_cell(r['gflop'], 4)} | "
              f"{_cell(r['gb'])} | {_cell(r['tflops'])} | {_cell(r['gbps'])} "
              f"| {_cell(r['intensity'])} | {_cell(r['mfu_mxu_pct'])} | "
              f"{_cell(r['mfu_vpu_pct'])} | {_cell(r['hbm_pct'])} | "
              f"{r['count']} |")


def main(argv=None, protocol: Optional[Protocol] = None) -> int:
    """The nine rows; `protocol` replaces the reference's sizes (for
    small runs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-1080p", action="store_true",
                    help="skip the native-1080p TV-L1 program")
    ap.add_argument("--reps", type=int, default=8,
                    help="calls per timed group for the cheap programs "
                    "(slow programs use reps/2, 1080p TV-L1 2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a GPU")
    args = ap.parse_args(argv)

    from video_analytics_tpu_torch.utils.device import card_name, require_cuda

    device = require_cuda(args.device)
    proto = protocol or Protocol()
    rows, extras = roofline(proto, device, build_model(proto, device),
                            args.reps, args.skip_1080p)
    print(json.dumps({
        "rows": rows, "peaks": peaks(), "card": card_name(device),
        "tvl1_budget_gflop": {k: w.flops / 1e9
                              for k, w in extras["budget"].items()}}),
        flush=True)
    print_table(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
