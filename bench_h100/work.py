"""The work a step needs, counted from shapes and configuration, and the
peaks of one H100: the benchmark's frozen yardstick for every roofline
and MFU share.

A frozen copy of the count of ``tools/torch_roofline.py`` (its ``Work``,
``tvl1_level_work``, ``tvl1_work``, ``farneback_work``,
``resize_crop_work``, ``gray_work``, ``normalize_work``, ``stack_work``,
``cnn_work`` and peaks), self-contained: the level sizes, taps and crop
geometry it needs are worked out here from the configuration, never
read from the program, so a later change to the program or the tool
leaves the yardstick as it is.

Per stage (bytes: each input read once, each output written once):

  - resize and crop: 2 taps a multiply and an add along rows, then along
    columns; gray 5 a pixel; normalize 3 an element; flow stacking 3 a
    flow element;
  - Farneback, per level: the prologue's blur, resize and polynomial
    expansion once a frame, and per iteration 100 operations a pixel for
    the warp and normal equations, 2·2·taps·5 for the window and 12 for
    the solve;
  - TV-L1, per scale: 45 operations a pixel and warp, 70 a pixel and
    primal-dual iteration and 2·2·113 a round for the 5×5 median, for
    the rounds each image ran, and the scale-end median; the pyramid and
    the gradients are not counted;
  - the CNNs: 2 per multiply-add of every convolution and linear layer,
    every tap included, in the layer's dtype (bfloat16 on the tensor
    cores); BatchNorm, ReLU, the residual add and pooling are not counted.

A share of a peak over 100 % means the count or the time is wrong:
``share`` raises then.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# One H100 SXM, NVIDIA's data sheet, dense, at the full 700 W.
BF16_FLOP_PER_S = 989e12       # bfloat16 on the tensor cores
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3

TVL1_WARP_OPS = 45
TVL1_PD_OPS = 70
BATCHER_25 = 113
FB_NEQ_OPS = 100
FB_SOLVE_OPS = 12


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and operations: float32 ones on the CUDA cores and
    bfloat16 products on the tensor cores."""

    bytes: int = 0
    f32: int = 0
    bf16: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.f32 + other.f32,
                    self.bf16 + other.bf16)

    def __mul__(self, k: int) -> "Work":
        return Work(self.bytes * k, self.f32 * k, self.bf16 * k)

    __rmul__ = __mul__

    def compute_seconds(self) -> float:
        """Least time on the compute roofs, taken in turn (one stream):
        bfloat16 products at 989 TFLOP/s plus float32 operations at 67."""
        return self.bf16 / BF16_FLOP_PER_S + self.f32 / F32_FLOP_PER_S

    def least_seconds(self) -> float:
        """The larger of the compute and the bytes bound."""
        return max(self.compute_seconds(), self.bytes / HBM_BYTES_PER_S)


def share(name: str, least_seconds: float, seconds: float) -> float:
    """100 · least / measured; raises above 100 %."""
    pct = 100.0 * least_seconds / seconds
    if pct > 100.0:
        raise RuntimeError(f"{name}: {pct} % of a peak in {seconds} s: the "
                           f"work is counted too high or the time leaves "
                           f"out part of it")
    return pct


# -- TV-L1 ------------------------------------------------------------------

def median_ops(k: int) -> int:
    return 2 * 2 * BATCHER_25 if k > 1 else 0


def tvl1_level_work(pixel_rounds: int, images: int, h: int, w: int,
                    warps: int, inner: int, median_k: int) -> Work:
    """One scale of `images` images of h×w for `pixel_rounds` (outer
    rounds run, summed over images and warps, each weighted by the pixels
    that ran it)."""
    px = h * w
    med = median_ops(median_k)
    return Work(bytes=8 * 4 * px * images,
                f32=images * px * (TVL1_WARP_OPS * warps + med)
                + (TVL1_PD_OPS * inner + med) * pixel_rounds)


def tvl1_work(levels, cfg: dict) -> Work:
    """A TV-L1 call's work from its levels (objects with ``hw``,
    ``solver``, ``band`` and ``rounds``: int tensors (B, warps) on a
    "warp" level, (warps, B) on a "chain" one and (warps, B, bands) on a
    "chunked" one)."""
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
        total += tvl1_level_work(pixel_rounds, images, h, w, cfg["warps"],
                                 cfg["inner_iterations"],
                                 cfg["median_filtering"])
    return total


# -- Farneback ----------------------------------------------------------------

def _fb_levels(h: int, w: int, cfg: dict):
    levels, scale = cfg["levels"], 1.0
    for k in range(cfg["levels"]):
        scale *= cfg["pyr_scale"]
        if w * scale < 32 or h * scale < 32:
            levels = k
            break
    return [(int(round(h * cfg["pyr_scale"] ** k)),
             int(round(w * cfg["pyr_scale"] ** k)), cfg["pyr_scale"] ** k)
            for k in range(levels, -1, -1)]


def _blur_taps(scale: float) -> int:
    if scale >= 1.0:
        return 3
    sigma = (1.0 / scale - 1.0) * 0.5
    return 2 * (max(int(round(sigma * 5)) | 1, 3) // 2) + 1


def farneback_kernel_work(frames: int, pairs: int, H: int, W: int, lh: int,
                          lw: int, scale: float, n_blur: int, n_poly: int,
                          taps: int) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} at one level of (lh, lw)."""
    px, lpx, ppx = frames * H * W, frames * lh * lw, pairs * lh * lw
    resize = (3 * frames * lh * W + 3 * lpx) if scale < 1 else 0
    window = 2 * taps * 5
    return {
        "fb_prologue": (4 * px + 20 * lpx,
                        4 * n_blur * px + resize + (18 * n_poly + 8) * lpx),
        "fb_iteration": (14 * 4 * ppx,
                         (FB_NEQ_OPS + 2 * window + FB_SOLVE_OPS) * ppx)}


def farneback_work(frames: int, pairs: int, H: int, W: int, cfg: dict
                   ) -> Work:
    """The sequence form over `frames` distinct frames and `pairs` pairs:
    per level the prologue once a frame and ``iterations`` iterations."""
    taps = cfg["winsize"] if not cfg["gaussian_window"] \
        else 2 * (cfg["winsize"] // 2) + 1
    total = Work()
    for lh, lw, scale in _fb_levels(H, W, cfg):
        k = farneback_kernel_work(frames, pairs, H, W, lh, lw, scale,
                                  _blur_taps(scale), 2 * cfg["poly_n"] + 1,
                                  taps)
        total += Work(*k["fb_prologue"])
        total += cfg["iterations"] * Work(*k["fb_iteration"])
    return total


# -- preprocessing and the CNNs -----------------------------------------------

def crop_source_rect(h: int, w: int, short: int, crop: int
                     ) -> Tuple[int, int, int, int]:
    """The source rows and columns [r0, r1) × [c0, c1) that the resize of
    the short side and the centre crop sample."""
    if h <= w:
        rh, rw = short, max(1, int(round(w * short / h)))
    else:
        rh, rw = max(1, int(round(h * short / w))), short

    def axis(n_in, n_out, off):
        k = n_in / n_out
        lo = (off + 0.5) * k - 0.5
        hi = (off + crop - 0.5) * k - 0.5
        return max(0, math.floor(lo)), min(n_in, math.ceil(hi) + 2)

    r0, r1 = axis(h, rh, int(round((rh - crop) / 2.0)))
    c0, c1 = axis(w, rw, int(round((rw - crop) / 2.0)))
    return r0, r1, c0, c1


def resize_crop_work(n: int, src_hw: Tuple[int, int], short: int,
                     crop: int) -> Work:
    r0, r1, c0, c1 = crop_source_rect(*src_hw, short, crop)
    return Work(bytes=n * 3 * ((r1 - r0) * (c1 - c0) + 4 * crop * crop),
                f32=n * 3 * 4 * crop * ((c1 - c0) + crop))


def gray_work(pixels: int) -> Work:
    return Work(bytes=16 * pixels, f32=5 * pixels)


def normalize_work(pixels: int, out_size: int = 4) -> Work:
    return Work(bytes=3 * pixels * (4 + out_size), f32=9 * pixels)


def stack_work(flows: int, stacks: int, h: int, w: int, stack: int,
               out_size: int) -> Work:
    return Work(bytes=8 * flows * h * w + stacks * h * w * 2 * stack
                * out_size, f32=3 * 2 * flows * h * w)


def cnn_work(images: int, hw: Tuple[int, int], in_channels: int,
             num_classes: int, width: int, dtype_bytes: int,
             tensor_cores: bool) -> Work:
    """One ResNet-18 forward pass over `images` images: 2 operations per
    multiply-add of every convolution and of the head; bytes each layer's
    input, weights and output once in a `dtype_bytes` type.  The shapes
    follow the layer list (7×7/2 stem, 3×3/2 max-pool, stages of two
    BasicBlocks, 1×1/2 projections)."""
    parts = []

    def out_hw(hw_in, k, s, p):
        return tuple((x + 2 * p - k) // s + 1 for x in hw_in)

    def conv(hw_in, cin, cout, k, s, p):
        ho, wo = out_hw(hw_in, k, s, p)
        out = images * cout * ho * wo
        ops = 2 * out * cin * k * k
        parts.append((dtype_bytes * (images * cin * hw_in[0] * hw_in[1]
                                     + cout * cin * k * k + out), ops))
        return (ho, wo)

    cur = conv(hw, in_channels, width, 7, 2, 3)
    cur = out_hw(cur, 3, 2, 1)
    cin = width
    for stage in range(4):
        cout = width * 2 ** stage
        for b in range(2):
            s = 2 if stage > 0 and b == 0 else 1
            mid = conv(cur, cin, cout, 3, s, 1)
            conv(mid, cout, cout, 3, 1, 1)
            if s != 1 or cin != cout:
                conv(cur, cin, cout, 1, s, 0)
            cur, cin = mid, cout
    fc_out = images * num_classes
    parts.append((dtype_bytes * (images * cin + num_classes * cin
                                 + num_classes + fc_out),
                  2 * fc_out * cin))
    nbytes = sum(b for b, _ in parts)
    ops = sum(o for _, o in parts)
    return Work(bytes=nbytes, **{"bf16" if tensor_cores else "f32": ops})


def model_cnn_work(cfg: dict, images: int, stacks: int) -> Tuple[Work, Work]:
    """(spatial, temporal) work of the configuration's two streams over
    `images` frames and `stacks` flow stacks."""
    m, pre = cfg["model"], cfg["preprocess"]
    bf16 = m["dtype"] == "bfloat16"
    size = 2 if bf16 else 4
    c = (pre["crop"], pre["crop"])
    return (cnn_work(images, c, 3, m["num_classes"], m["width"], size, bf16),
            cnn_work(stacks, c, 2 * pre["flow_stack"], m["num_classes"],
                     m["width"], size, bf16))


def two_stream_work(cfg: dict, seqs: int, T: int, src_hw: Tuple[int, int],
                    flow: Work) -> Work:
    """``classify_batch`` over `seqs` windows of T frames of `src_hw`:
    resize and crop, normalize and the spatial CNN on every frame; gray,
    the flow call (`flow`, counted by the caller: TV-L1 needs its
    rounds), the stacks and the temporal CNN."""
    pre = cfg["preprocess"]
    c, n, L = pre["crop"], seqs * T, pre["flow_stack"]
    stacks = seqs * (T - L)
    spatial, temporal = model_cnn_work(cfg, n, stacks)
    out_size = 2 if cfg["model"]["dtype"] == "bfloat16" else 4
    return (resize_crop_work(n, src_hw, pre["resize_short"], c)
            + normalize_work(n * c * c) + spatial + gray_work(n * c * c)
            + flow + stack_work(seqs * (T - 1), stacks, c, c, L, out_size)
            + temporal)


def flow_work(cfg: dict, seqs: int, T: int, levels=None) -> Work:
    """The flow call of `seqs` windows of T cropped frames: TV-L1 from its
    recorded `levels`, Farneback from the shapes."""
    c = cfg["preprocess"]["crop"]
    f = cfg["flow"]
    if f["algo"] == "tvl1":
        if levels is None:
            raise ValueError("TV-L1's work needs the rounds it ran")
        return tvl1_work(levels, f["tvl1"])
    return farneback_work(seqs * T, seqs * (T - 1), c, c, f["farneback"])

