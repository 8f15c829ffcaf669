"""Plain Video Swin Transformer (Liu, Ning, Cao, Wei, Zhang, Lin and Hu,
"Video Swin Transformer", CVPR 2022, arXiv:2106.13230) in float32, in
eval mode: the reference the port's Video Swin is held to.

Written from the paper's equations and SwinTransformer/
Video-Swin-Transformer's ``mmaction/models/backbones/
swin_transformer.py`` (``SwinTransformer3D``, ``I3DHead``), in plain
``torch`` operations, importing nothing of the port and nothing of JAX.
A clip (N, T, H, W, C) is embedded by a Conv3d whose kernel is its stride
(the patch, read from the weight) and a LayerNorm.  Each stage takes its
window and shift by the published ``get_window_size`` (where the feature
is no longer than the window, the window is the feature and the shift
0).  Each block: h = LN_1(x); on odd blocks with a shift, h rolled by
−shift over (D, H, W) with ``torch.roll``; the windows cut out by
reshapes and a permute; per head softmax(q·kᵀ·scale + B_rel + M)·v,
written out, with B_rel[i, j] = table[index[i, j]] (the index the
published code builds: coordinate differences shifted by window − 1 and
mixed by strides (2·Wh − 1)(2·Ww − 1) and 2·Ww − 1, read at [:N, :N]) and
M the published ``compute_mask`` (regions cut at −window and −shift,
−100 between regions); the projection; the windows put back and rolled
by +shift; x += that; x += fc2(GELU(fc1(LN_2(x)))).  Patch merging
concatenates x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]
over (H, W), a LayerNorm, a linear layer without bias.  The head: a
LayerNorm, the mean over every token, a linear layer.

Departures from the published code, none of which changes a number at
a shape that needs no padding: padding is left out (a shape that needs
it is not supported), and so are dropout and drop-path (0 in eval); the
mask is made from the stage's shape in each call.

Parameters are a state dict of float32 tensors under the published
names (``patch_embed.proj.weight``, ``patch_embed.norm.bias``,
``layers.<s>.blocks.<b>.attn.qkv.weight``,
``layers.<s>.blocks.<b>.attn.relative_position_bias_table``,
``layers.<s>.downsample.reduction.weight``, ``norm.weight``,
``cls_head.fc_cls.bias``, ...); the head count of each stage is read
from its tables, the window is given.  Inputs are (N, T, H, W, C) clip
volumes.  The forward pass runs `block` clips at a time; TF32 is off
while it runs.

``precision="fp8"`` is a control: every product (the patch convolution,
each linear layer, Q·Kᵀ and the weights times V) takes its operands
rounded to float8 e4m3 under a per-tensor scale (amax to 448),
accumulates in float32 and keeps the rest in float32.  `leave_out`
names faults, each a control too: ``bias`` (no B_rel), ``mask`` (no M),
``shift`` (no roll, no M) and ``merge_order`` (merging's four parts
taken W before H).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
FAULTS = ("bias", "mask", "shift", "merge_order")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def parameter_shapes(in_channels: int, num_classes: int, width: int = 128,
                     depths: Tuple[int, ...] = (2, 2, 18, 2),
                     heads: Tuple[int, ...] = (4, 8, 16, 32),
                     window: Tuple[int, int, int] = (8, 7, 7),
                     patch: Tuple[int, int, int] = (2, 4, 4),
                     mlp_ratio: int = 4) -> Dict[str, tuple]:
    """Every tensor of a stream's state dict and its shape, in the module
    order."""
    shapes: Dict[str, tuple] = {
        "patch_embed.proj.weight": (width, in_channels, *patch),
        "patch_embed.proj.bias": (width,),
        "patch_embed.norm.weight": (width,),
        "patch_embed.norm.bias": (width,)}
    rows = ((2 * window[0] - 1) * (2 * window[1] - 1)
            * (2 * window[2] - 1))

    def linear(name, n_in, n_out, bias=True):
        shapes[name + ".weight"] = (n_out, n_in)
        if bias:
            shapes[name + ".bias"] = (n_out,)

    def norm(name, dim):
        shapes[name + ".weight"] = (dim,)
        shapes[name + ".bias"] = (dim,)

    dim = width
    for s, (depth, h) in enumerate(zip(depths, heads)):
        for i in range(depth):
            b = f"layers.{s}.blocks.{i}."
            norm(b + "norm1", dim)
            shapes[b + "attn.relative_position_bias_table"] = (rows, h)
            linear(b + "attn.qkv", dim, 3 * dim)
            linear(b + "attn.proj", dim, dim)
            norm(b + "norm2", dim)
            linear(b + "mlp.fc1", dim, mlp_ratio * dim)
            linear(b + "mlp.fc2", mlp_ratio * dim, dim)
        if s < len(depths) - 1:
            norm(f"layers.{s}.downsample.norm", 4 * dim)
            linear(f"layers.{s}.downsample.reduction", 4 * dim, 2 * dim,
                   bias=False)
            dim *= 2
    norm("norm", dim)
    linear("cls_head.fc_cls", dim, num_classes)
    return shapes


def get_window_size(size, window, shift):
    w, s = list(window), list(shift)
    for i in range(3):
        if size[i] <= window[i]:
            w[i], s[i] = size[i], 0
    return tuple(w), tuple(s)


def relative_position_index(window) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(
        torch.arange(window[0]), torch.arange(window[1]),
        torch.arange(window[2]), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).clone()
    rel[:, :, 0] += window[0] - 1
    rel[:, :, 1] += window[1] - 1
    rel[:, :, 2] += window[2] - 1
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // window[0], window[0], H // window[1], window[1],
                  W // window[2], window[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, window[0] * window[1] * window[2], C)


def window_reverse(windows: torch.Tensor, window, B, D, H, W
                   ) -> torch.Tensor:
    x = windows.reshape(B, D // window[0], H // window[1], W // window[2],
                        window[0], window[1], window[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def compute_mask(D, H, W, window, shift, device) -> torch.Tensor:
    img = torch.zeros((1, D, H, W, 1), device=device)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0]),
              slice(-shift[0], None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1]),
                  slice(-shift[1], None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2]),
                      slice(-shift[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    regions = window_partition(img, window).squeeze(-1)
    mask = regions.unsqueeze(1) - regions.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


class VideoSwin:
    """Eval-mode Video Swin over a state dict (see the module's names);
    the widths, depths, heads and patch are read from the tensors'
    shapes, the window is given."""

    def __init__(self, state: Dict[str, torch.Tensor],
                 window: Tuple[int, int, int] = (8, 7, 7),
                 precision: str = "float32", eps: float = 1e-5,
                 block: int = 2, leave_out: Iterable[str] = ()):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.leave_out: FrozenSet[str] = frozenset(leave_out)
        if not self.leave_out <= set(FAULTS):
            raise ValueError(f"unknown faults {sorted(self.leave_out)}")
        self.p, self.window, self.precision = state, tuple(window), precision
        self.eps, self.block = eps, block
        self.patch = tuple(state["patch_embed.proj.weight"].shape[2:])
        self.depths = []
        s = 0
        while f"layers.{s}.blocks.0.norm1.weight" in state:
            n = 0
            while f"layers.{s}.blocks.{n}.norm1.weight" in state:
                n += 1
            self.depths.append(n)
            s += 1

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def _linear(self, x, name):
        return F.linear(self._q(x), self._q(self.p[name + ".weight"]),
                        self.p.get(name + ".bias"))

    def _norm(self, x, name):
        w = self.p[name + ".weight"]
        return F.layer_norm(x, w.shape, w, self.p[name + ".bias"], self.eps)

    def _attention(self, x, b, mask):
        """The windows (B_, N, C) through W-MSA, mask (nW, N, N) or None."""
        B_, N, C = x.shape
        table = self.p[b + "attn.relative_position_bias_table"]
        heads = table.shape[1]
        qkv = self._linear(x, b + "attn.qkv").reshape(
            B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (C // heads) ** -0.5
        attn = self._q(q) @ self._q(k).transpose(-2, -1)
        if "bias" not in self.leave_out:
            index = relative_position_index(self.window).to(table.device)
            rel = table[index[:N, :N].reshape(-1)].reshape(N, N, -1)
            attn = attn + rel.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.view(B_ // nW, nW, heads, N, N)
                    + mask.unsqueeze(1).unsqueeze(0)).view(-1, heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = (self._q(attn) @ self._q(v)).transpose(1, 2).reshape(B_, N, C)
        return self._linear(out, b + "attn.proj")

    def _block(self, x, b, window, shift, mask):
        B, D, H, W, C = x.shape
        h = self._norm(x, b + "norm1")
        if any(shift):
            h = torch.roll(h, shifts=(-shift[0], -shift[1], -shift[2]),
                           dims=(1, 2, 3))
        else:
            mask = None
        if "mask" in self.leave_out:
            mask = None
        a = self._attention(window_partition(h, window), b, mask)
        h = window_reverse(a, window, B, D, H, W)
        if any(shift):
            h = torch.roll(h, shifts=shift, dims=(1, 2, 3))
        x = x + h
        y = F.gelu(self._linear(self._norm(x, b + "norm2"), b + "mlp.fc1"))
        return x + self._linear(y, b + "mlp.fc2")

    def _merge(self, x, s):
        parts = [x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                 x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]]
        if "merge_order" in self.leave_out:
            parts = [parts[0], parts[2], parts[1], parts[3]]
        x = torch.cat(parts, -1)
        name = f"layers.{s}.downsample."
        return self._linear(self._norm(x, name + "norm"), name + "reduction")

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x = F.conv3d(self._q(x.float().permute(0, 4, 1, 2, 3)),
                     self._q(p["patch_embed.proj.weight"]),
                     p["patch_embed.proj.bias"], stride=self.patch)
        x = self._norm(x.permute(0, 2, 3, 4, 1), "patch_embed.norm")
        layer_shift = tuple(n // 2 for n in self.window)
        if "shift" in self.leave_out:
            layer_shift = (0, 0, 0)
        for s, depth in enumerate(self.depths):
            B, D, H, W, C = x.shape
            window, shift = get_window_size((D, H, W), self.window,
                                            layer_shift)
            mask = (compute_mask(D, H, W, window, shift, x.device)
                    if any(shift) else None)
            for i in range(depth):
                x = self._block(x, f"layers.{s}.blocks.{i}.", window,
                                shift if i % 2 else (0, 0, 0), mask)
            if s < len(self.depths) - 1:
                x = self._merge(x, s)
        x = self._norm(x, "norm").mean(dim=(1, 2, 3))
        return self._linear(x, "cls_head.fc_cls")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, C) → (N, classes) float32 logits."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return torch.cat([self._forward(x[i:i + self.block])
                              for i in range(0, x.shape[0], self.block)])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
