"""The work of the Video Swin cells, counted from shapes and
configuration: the frozen yardstick of ``swin_roofline``,
``window_attn_roofline`` and ``mfu_pct.swin``, on ``work.py``'s peaks.

Per stream, every product of the published model is one operation: the
patch embedding (a Conv3d whose kernel is its stride, as a product over
its C·2·4·4 taps); per block ``qkv``, the window attention's products
Q·Kᵀ and weights·V over each window's N tokens (the window and shift
rule of ``get_window_size`` applied to the stage's feature), ``proj``
and the MLP's ``fc1`` and ``fc2``; each patch merging's ``reduction``
(4C → 2C, no bias); the head.  An operation counts 2 per multiply-add in
its dtype (bfloat16 on the tensor cores; the head float32) and the least
bytes it has to move: its input, weights, bias and output once in that
dtype; for the window attention Q, K, V and the output once and the
relative position bias table once a call (float32), nothing of the
scores and nothing for a bias or mask laid out per window, which a
kernel can derive from the window's position.  LayerNorm, GELU, the
rolls, partitions and reverses, merging's gathers, the residual adds and
the mean over tokens are not counted, as BatchNorm and ReLU are not in
the CNN counts.  So the count reads the same whatever implements the
model.

A batch of B windows of T frames (``classify_batch`` on clip streams):
the resize and crop and the normalisation of every frame, the RGB
stream over B clips of T − 1 frames, gray, one Farneback call over the
B·T frames and B·(T − 1) pairs, the volume's clip and scale, and the
flow stream over B clips of T − 1 fields.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from bench_h100 import work, work_r2p1d
from bench_h100.work_tsf import _product, least_seconds, total

Op = Tuple[str, work.Work]

__all__ = ["attn_ops", "batch_work", "cnn_ops", "least_seconds",
           "stream_ops", "total"]


def _window_attention(windows: int, length: int, dim: int, heads: int,
                      rows: int, size: int) -> Op:
    """Q·Kᵀ and weights·V over `windows` windows of `length` tokens (all
    heads: their widths sum to `dim`): Q, K, V read and the output
    written once, the float32 table of `rows` × `heads` once."""
    tokens = windows * length
    return ("attn.attn",
            work.Work(bytes=size * 4 * tokens * dim + 4 * rows * heads,
                      bf16=2 * 2 * windows * length * length * dim))


def _window(size: Sequence[int], window: Sequence[int]) -> List[int]:
    """The published ``get_window_size``: a dimension no longer than the
    window takes the feature's size."""
    return [n if n <= w else w for n, w in zip(size, window)]


def stream_ops(clips: int, frames: int, hw: Tuple[int, int],
               in_channels: int, num_classes: int, width: int,
               depths: Sequence[int], heads: Sequence[int],
               window: Sequence[int], patch: Sequence[int], mlp_ratio: int,
               size: int = 2) -> List[Op]:
    """Every product of one stream's forward pass over `clips` clips of
    `frames` frames of `hw`, in order (names ``patch``, ``attn.qkv``,
    ``attn.attn``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``, ``merge``,
    ``head``)."""
    feat = [frames // patch[0], hw[0] // patch[1], hw[1] // patch[2]]
    rows = math.prod(2 * w - 1 for w in window)
    C = width
    ops = [_product("patch", clips * math.prod(feat),
                    in_channels * math.prod(patch), C, size)]
    for s, (depth, h) in enumerate(zip(depths, heads)):
        M = clips * math.prod(feat)
        N = math.prod(_window(feat, window))
        block = [_product("attn.qkv", M, C, 3 * C, size),
                 _window_attention(M // N, N, C, h, rows, size),
                 _product("attn.proj", M, C, C, size),
                 _product("mlp.fc1", M, C, mlp_ratio * C, size),
                 _product("mlp.fc2", M, mlp_ratio * C, C, size)]
        ops += block * depth
        if s < len(depths) - 1:
            ops.append(_product("merge", M // 4, 4 * C, 2 * C, size,
                                bias=False))
            feat = [feat[0], feat[1] // 2, feat[2] // 2]
            C *= 2
    ops.append(_product("head", clips, C, num_classes, 4, bf16=False))
    return ops


def cnn_ops(cfg: dict, clips: int, frames: int) -> List[Op]:
    """Both streams of the configuration over `clips` clips of `frames`
    frames (the RGB stream's 3 channels, the flow stream's 2)."""
    m, c = cfg["model"], cfg["preprocess"]["crop"]
    size = 2 if m["dtype"] == "bfloat16" else 4
    return [op for ch in (3, 2)
            for op in stream_ops(clips, frames, (c, c), ch, m["num_classes"],
                                 m["width"], m["depths"], m["heads"],
                                 m["window"], m["patch"], m["mlp_ratio"],
                                 size)]


def attn_ops(cfg: dict, clips: int, frames: int) -> List[Op]:
    """The window attention's own operations (``qkv``, the products,
    ``proj``), both streams."""
    return [op for op in cnn_ops(cfg, clips, frames)
            if op[0].startswith("attn.")]


def batch_work(cfg: dict, seqs: int, T: int, src_hw: Tuple[int, int]
               ) -> work.Work:
    """``classify_batch`` on Video Swin streams over `seqs` windows of T
    frames of `src_hw`, crop to fusion."""
    pre = cfg["preprocess"]
    c, n, f = pre["crop"], seqs * T, seqs * (T - 1)
    out_size = 2 if cfg["model"]["dtype"] == "bfloat16" else 4
    return (work.resize_crop_work(n, src_hw, pre["resize_short"], c)
            + work.normalize_work(n * c * c) + work.gray_work(n * c * c)
            + work_r2p1d.flow_work(cfg, seqs, T)
            + work.stack_work(f, f, c, c, 1, out_size)
            + total(cnn_ops(cfg, seqs, T - 1)))
