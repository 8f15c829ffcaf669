"""The work of the R(2+1)D cells, counted from shapes and configuration:
the frozen yardstick of ``conv2plus1d_roofline``, ``farneback_roofline``
and ``mfu_pct.r2p1d``, on ``work.py``'s peaks and rules.

Both CNNs: 2 operations per multiply-add of every convolution (the
(2+1)D factors, the stem and the 1×1×1 projections, every tap included)
and of the head, in the layer's dtype (bfloat16 on the tensor cores);
bytes each layer's input, weights and output once in that dtype;
BatchNorm, ReLU, the residual add and the pool are not counted.  The
shapes follow the paper's layer list (``reference/r2plus1d.py``):
stem 1×7×7 (stride 1, 2, 2) to 45 and 3×1×1 to the width, stages of
basic blocks whose first block of stages 2-4 has stride 2 in time and
space, each convolution's own midplane count.  ``tools/torch_roofline.py``
counts the same from the program's layers (``r2plus1d_work``).

A batch of B windows of T frames (``classify_batch`` on clip streams):
the resize and crop and the normalisation of every frame, the spatial
CNN over B clips of T − 1 frames, gray, one Farneback call over the
B·T frames and B·(T − 1) pairs (``work.farneback_work``), the volume's
clip and scale, and the temporal CNN over B clips of T − 1 fields.
"""

from __future__ import annotations

import math
from typing import Tuple

from bench_h100 import work
from bench_h100.reference.r2plus1d import STAGES, STEM_MIDPLANES, midplanes


def conv2plus1d_work(clips: int, frames: int, hw: Tuple[int, int],
                     in_channels: int, num_classes: int, width: int,
                     dtype_bytes: int, tensor_cores: bool) -> work.Work:
    """One R(2+1)D-34 forward pass over `clips` clips of `frames` frames
    of `hw` with `in_channels` channels."""
    parts = []

    def conv(shape, cin, cout, k, s, p):
        out = tuple((x + 2 * q - kk) // ss + 1
                    for x, kk, ss, q in zip(shape, k, s, p))
        n_out = clips * cout * math.prod(out)
        taps = cin * math.prod(k)
        parts.append((dtype_bytes * (clips * cin * math.prod(shape)
                                     + cout * taps + n_out),
                      2 * n_out * taps))
        return out

    def c2p1(shape, cin, mid, cout, s, t_s, k):
        mid_shape = conv(shape, cin, mid, (1, k, k), (1, s, s),
                         (0, k // 2, k // 2))
        return conv(mid_shape, mid, cout, (3, 1, 1), (t_s, 1, 1), (1, 0, 0))

    cur = c2p1((frames, *hw), in_channels, STEM_MIDPLANES, width, 2, 1, 7)
    cin = width
    for stage, n in enumerate(STAGES):
        cout = width * 2 ** stage
        for b in range(n):
            s = 2 if stage > 0 and b == 0 else 1
            mid = c2p1(cur, cin, midplanes(cin, cout), cout, s, s, 3)
            c2p1(mid, cout, midplanes(cout, cout), cout, 1, 1, 3)
            if s != 1 or cin != cout:
                conv(cur, cin, cout, (1, 1, 1), (s, s, s), (0, 0, 0))
            cur, cin = mid, cout
    fc_out = clips * num_classes
    parts.append((dtype_bytes * (clips * cin + num_classes * cin
                                 + num_classes + fc_out),
                  2 * fc_out * cin))
    ops = sum(o for _, o in parts)
    return work.Work(bytes=sum(b for b, _ in parts),
                     **{"bf16" if tensor_cores else "f32": ops})


def cnn_work(cfg: dict, clips: int, frames: int) -> work.Work:
    """Both streams of the configuration over `clips` clips of `frames`
    frames (the RGB stream's 3 channels, the flow stream's 2)."""
    m, c = cfg["model"], cfg["preprocess"]["crop"]
    bf16 = m["dtype"] == "bfloat16"
    size = 2 if bf16 else 4
    return sum((conv2plus1d_work(clips, frames, (c, c), ch,
                                 m["num_classes"], m["width"], size, bf16)
                for ch in (3, 2)), work.Work())


def flow_work(cfg: dict, seqs: int, T: int) -> work.Work:
    """One Farneback call over `seqs` windows of T cropped frames."""
    c = cfg["preprocess"]["crop"]
    return work.farneback_work(seqs * T, seqs * (T - 1), c, c,
                               cfg["flow"]["farneback"])


def batch_work(cfg: dict, seqs: int, T: int, src_hw: Tuple[int, int]
               ) -> work.Work:
    """``classify_batch`` on clip streams over `seqs` windows of T frames
    of `src_hw`, crop to fusion."""
    pre = cfg["preprocess"]
    c, n, f = pre["crop"], seqs * T, seqs * (T - 1)
    out_size = 2 if cfg["model"]["dtype"] == "bfloat16" else 4
    return (work.resize_crop_work(n, src_hw, pre["resize_short"], c)
            + work.normalize_work(n * c * c) + work.gray_work(n * c * c)
            + flow_work(cfg, seqs, T)
            + work.stack_work(f, f, c, c, 1, out_size)
            + cnn_work(cfg, seqs, T - 1))
