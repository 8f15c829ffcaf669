"""The work of the TimeSformer cells, counted from shapes and
configuration: the frozen yardstick of ``tsf_roofline``,
``divided_attn_roofline`` and ``mfu_pct.tsf``, on ``work.py``'s peaks.

Per stream, every product of the published model is one operation: the
patch embedding (a 16×16 stride-16 convolution, as a product over its
C·16² taps); per block the time half (``qkv``, the attention products
Q·Kᵀ and weights·V over each patch's T tokens, ``proj``,
``temporal_fc``), the space half (``qkv``, the attention products over
each frame's P + 1 tokens, ``proj``) and the MLP's ``fc1`` and ``fc2``
over the clip's 1 + T·P tokens; the head.  An operation counts 2 per
multiply-add in its dtype (bfloat16 on the tensor cores; the head
float32) and the least bytes it has to move: its input, weights, bias
and output once in that dtype; for the attention products Q, K, V and
the output, nothing of the scores.  LayerNorm, GELU, the embedding and
residual adds, the class token's mean and the copies between the halves
are not counted, as BatchNorm and ReLU are not in the CNN counts.  So
the count reads the same whatever implements the model.

A share of a roofline takes each operation at the larger of its compute
and its bytes bound and sums them (``least_seconds``).
``tools/torch_roofline.py`` counts the same from the port's model
(``timesformer_ops``).

A batch of B windows of T frames (``classify_batch`` on clip streams):
the resize and crop and the normalisation of every frame, the RGB
stream over B clips of T − 1 frames, gray, one Farneback call over the
B·T frames and B·(T − 1) pairs, the volume's clip and scale, and the
flow stream over B clips of T − 1 fields.
"""

from __future__ import annotations

from typing import List, Tuple

from bench_h100 import work, work_r2p1d

Op = Tuple[str, work.Work]


def _product(name: str, rows: int, n_in: int, n_out: int, size: int,
             bias: bool = True, bf16: bool = True) -> Op:
    """(rows, n_in) times an (n_in, n_out) weight, with its bias."""
    weights = n_in * n_out + (n_out if bias else 0)
    return (name, work.Work(bytes=size * (rows * n_in + weights
                                          + rows * n_out),
                            **{"bf16" if bf16 else "f32":
                               2 * rows * n_in * n_out}))


def _attention(name: str, seqs: int, length: int, dim: int,
               size: int) -> Op:
    """Q·Kᵀ and weights·V over `seqs` sequences of `length` tokens (all
    heads: their widths sum to `dim`): Q, K, V read and the output
    written once."""
    tokens = seqs * length
    return (name, work.Work(bytes=size * 4 * tokens * dim,
                            bf16=2 * 2 * seqs * length * length * dim))


def stream_ops(clips: int, frames: int, hw: Tuple[int, int],
               in_channels: int, num_classes: int, width: int, depth: int,
               mlp: int, patch: int, size: int = 2) -> List[Op]:
    """Every product of one stream's forward pass over `clips` clips of
    `frames` frames of `hw`, in order (names ``patch``, ``time.qkv``,
    ``time.attn``, ``time.proj``, ``time.fc``, ``space.qkv``,
    ``space.attn``, ``space.proj``, ``mlp.fc1``, ``mlp.fc2``, ``head``;
    the block's ops repeat `depth` times)."""
    P = (hw[0] // patch) * (hw[1] // patch)
    D = width
    patches = clips * frames * P
    space = clips * frames * (P + 1)
    tokens = clips * (1 + frames * P)
    ops = [_product("patch", patches, in_channels * patch * patch, D,
                    size)]
    block = [_product("time.qkv", patches, D, 3 * D, size),
             _attention("time.attn", clips * P, frames, D, size),
             _product("time.proj", patches, D, D, size),
             _product("time.fc", patches, D, D, size),
             _product("space.qkv", space, D, 3 * D, size),
             _attention("space.attn", clips * frames, P + 1, D, size),
             _product("space.proj", space, D, D, size),
             _product("mlp.fc1", tokens, D, mlp, size),
             _product("mlp.fc2", tokens, mlp, D, size)]
    ops += block * depth
    ops.append(_product("head", clips, D, num_classes, 4, bf16=False))
    return ops


def least_seconds(ops: List[Op]) -> float:
    """Each operation at the larger of its compute and bytes bound,
    summed."""
    return sum(w.least_seconds() for _, w in ops)


def total(ops: List[Op]) -> work.Work:
    return sum((w for _, w in ops), work.Work())


def cnn_ops(cfg: dict, clips: int, frames: int) -> List[Op]:
    """Both streams of the configuration over `clips` clips of `frames`
    frames (the RGB stream's 3 channels, the flow stream's 2)."""
    m, c = cfg["model"], cfg["preprocess"]["crop"]
    size = 2 if m["dtype"] == "bfloat16" else 4
    return [op for ch in (3, 2)
            for op in stream_ops(clips, frames, (c, c), ch, m["num_classes"],
                                 m["width"], m["depth"], m["mlp"],
                                 m["patch"], size)]


def attn_ops(cfg: dict, clips: int, frames: int) -> List[Op]:
    """The time and space halves' own operations, both streams."""
    return [op for op in cnn_ops(cfg, clips, frames)
            if op[0].startswith(("time.", "space."))]


def batch_work(cfg: dict, seqs: int, T: int, src_hw: Tuple[int, int]
               ) -> work.Work:
    """``classify_batch`` on TimeSformer streams over `seqs` windows of T
    frames of `src_hw`, crop to fusion."""
    pre = cfg["preprocess"]
    c, n, f = pre["crop"], seqs * T, seqs * (T - 1)
    out_size = 2 if cfg["model"]["dtype"] == "bfloat16" else 4
    return (work.resize_crop_work(n, src_hw, pre["resize_short"], c)
            + work.normalize_work(n * c * c) + work.gray_work(n * c * c)
            + work_r2p1d.flow_work(cfg, seqs, T)
            + work.stack_work(f, f, c, c, 1, out_size)
            + total(cnn_ops(cfg, seqs, T - 1)))
