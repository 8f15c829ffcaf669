"""Video Swin Transformer: Liu, Ning, Cao, Wei, Zhang, Lin and Hu,
"Video Swin Transformer" (CVPR 2022, arXiv:2106.13230), as an
``nn.Module``.  Reference code: SwinTransformer/Video-Swin-Transformer
``mmaction/models/backbones/swin_transformer.py`` (``SwinTransformer3D``)
with its ``I3DHead``, whose parameter names this module keeps
(``patch_embed.proj``, ``layers.<s>.blocks.<b>.attn.qkv``,
``layers.<s>.blocks.<b>.attn.relative_position_bias_table``,
``layers.<s>.downsample.reduction``, ``norm``, ``cls_head.fc_cls``, ...).

A clip of T frames of H×W, channels last (N, T, H, W, C), is cut into
2×4×4 patches, embedded by a Conv3d of that kernel and stride (with a
bias) and a LayerNorm: tokens (N, D, H', W', C) with D = T/2, H' = H/4,
W' = W/4.  Four stages follow; stages 1-3 end in a patch merging.

  1. Window and shift of a stage (``window_size_and_shift``, the
     published ``get_window_size``): in each dimension where the feature
     is no longer than the window, the window becomes the feature and
     that dimension's shift 0.
  2. Block i of a stage (shifted on odd i): h = norm1(x); where shifted,
     h is rolled by −shift over (D, H, W); cut into windows of N tokens
     in (d, h, w) order; per head softmax(q·kᵀ/√d + B_rel + M)·v, where
     B_rel[i, j] is the block's table row ``relative_position_index[i,
     j]`` and M the stage's shift mask (0 inside a region of the rolled
     feature, −100 across regions; no M unshifted); ``proj``; the
     windows merged back and rolled by +shift; x += that; then x +=
     fc2(GELU(fc1(norm2(x)))).
  3. Patch merging: [x(0::2, 0::2), x(1::2, 0::2), x(0::2, 1::2),
     x(1::2, 1::2)] over (H, W), H before W, to 4C; LayerNorm; a linear
     4C → 2C without bias.  Time is not merged.
  4. Head: a LayerNorm, the mean over every token, a linear layer.

Video Swin-B (``video_swin_b``): width 128, depths [2, 2, 18, 2], heads
[4, 8, 16, 32] (heads of 32), window 8×7×7 (N = 392), shift 4×3×3, MLP
ratio 4, qkv with bias, scale 1/√32, LayerNorm ε = 1e-5, exact (erf)
GELU; 32 frames at 224² give stages of 16×56², 16×28², 16×14² and 16×7²,
every one a whole number of windows.  Dropout and drop-path are 0 in
eval and are not built.

Departures from the published code.  A shape that the published code
pads (a frame count or size not a multiple of the patch, a feature not a
multiple of its window, an odd size before a merge) is refused with a
message that names it; the published shapes need no padding.  As
published, a window cut down to a smaller feature reads the first N
rows and columns of the full window's ``relative_position_index``.
``relative_position_index`` is a non-persistent buffer, so a state dict
holds the parameters alone.

Rounding.  The parameters are float32; with ``dtype`` bfloat16 the input
is cast at entry and the patch convolution and every projection
(``ops/layers.Conv3d`` and ``Linear``: two roundings with a bias), GELU,
the attention products and each residual add run in bfloat16.  The
LayerNorms take their statistics and normalise in float32 and round
their output once (``ops/layers.LayerNorm``).  Each block gathers its
B_rel from the table in float32, adds the shift mask in float32, and
rounds the sum once to the compute dtype; attention is
``F.scaled_dot_product_attention`` with that sum as ``attn_mask``
(``timesformer.Attention`` with a bias, accumulated as the backend
does).  The final LayerNorm, the mean over tokens and the head run in
float32 and return float32 logits.

Spans: ``va/swin.embed``; ``va/swin.attn`` (norm1, the rolls, the
partition and its reverse, ``qkv``, the bias and mask, attention,
``proj``, the residual add) and ``va/swin.mlp``, once a block;
``va/swin.merge``, once after each of stages 1-3; ``va/swin.head``.
``VideoSwin.calls`` counts the blocks by kind (``window``, ``shifted``)
and the merges (``merge``): a Swin-B stream's forward adds 12, 12 and 3.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from video_analytics_tpu_torch.models.timesformer import Attention, Mlp
from video_analytics_tpu_torch.ops.layers import Conv3d, LayerNorm, Linear
from video_analytics_tpu_torch.utils.spans import span

LN_EPS = 1e-5
MASK_VALUE = -100.0
TABLE_SD = 0.02

Size3 = Tuple[int, int, int]


def window_size_and_shift(size: Sequence[int], window: Size3, shift: Size3
                          ) -> Tuple[Size3, Size3]:
    """The published ``get_window_size``: where a feature dimension is no
    longer than the window, the window takes its size and its shift is
    0."""
    w, s = list(window), list(shift)
    for i, n in enumerate(size):
        if n <= window[i]:
            w[i], s[i] = n, 0
    return tuple(w), tuple(s)


def relative_position_index(window: Size3) -> torch.Tensor:
    """(N, N) int64, N = the window's tokens in (d, h, w) order: the row
    of the (2·Wd − 1)(2·Wh − 1)(2·Ww − 1)-row table for each pair, the
    coordinate differences shifted by window − 1 and mixed by strides
    (2·Wh − 1)(2·Ww − 1) and 2·Ww − 1."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(n) for n in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([n - 1 for n in window])
    strides = torch.tensor([(2 * window[1] - 1) * (2 * window[2] - 1),
                            2 * window[2] - 1, 1])
    return (rel * strides).sum(-1)


def window_partition(x: torch.Tensor, window: Size3) -> torch.Tensor:
    """(B, D, H, W, C) → (B·nW, N, C): windows in (d, h, w) order of
    their position, tokens in (d, h, w) order inside each."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.view(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window: Size3,
                   size: Tuple[int, int, int, int]) -> torch.Tensor:
    """``window_partition``'s inverse: (B·nW, N, C) → (B, D, H, W, C)."""
    B, D, H, W = size
    wd, wh, ww = window
    x = windows.view(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


@functools.lru_cache(maxsize=16)
def shift_mask(size: Size3, window: Size3, shift: Size3,
               device: torch.device) -> torch.Tensor:
    """The published ``compute_mask``: (nW, N, N) float32, 0 between two
    tokens of a window that lie in the same region of the rolled feature
    and ``MASK_VALUE`` between tokens of different regions.  Each
    dimension is cut at −window and −shift into three slices (a shift of
    0 leaves the dimension one region).  Made once for each shape and
    device."""
    img = torch.zeros((1, *size, 1))
    cnt = 0
    for d in _regions(window[0], shift[0]):
        for h in _regions(window[1], shift[1]):
            for w in _regions(window[2], shift[2]):
                img[:, d, h, w, :] = cnt
                cnt += 1
    regions = window_partition(img, window).squeeze(-1)      # (nW, N)
    diff = regions[:, None, :] - regions[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0).to(device)


def _regions(window: int, shift: int):
    return (slice(-window), slice(-window, -shift), slice(-shift, None))


class WindowAttention(Attention):
    """``timesformer.Attention`` over the windows of a block, with the
    block's relative position bias table ((2·Wd − 1)(2·Wh − 1)(2·Ww − 1)
    rows × heads)."""

    def __init__(self, dim: int, heads: int, window: Size3,
                 dtype: torch.dtype):
        super().__init__(dim, heads, dtype)
        rows = math.prod(2 * n - 1 for n in window)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)

    def window_bias(self, n: int, mask: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """(G, heads, n, n) in the compute dtype: B_rel gathered in
        float32 for windows of n tokens, plus the (G, n, n) `mask` where
        given (G = 1 without), rounded once."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].view(n, n, -1)
        bias = bias.permute(2, 0, 1)[None]
        if mask is not None:
            bias = bias + mask[:, None]
        return bias.to(self.qkv.dtype).contiguous()


class SwinBlock(nn.Module):
    """One (shifted) window block over (B, D, H, W, C) tokens."""

    def __init__(self, dim: int, heads: int, window: Size3, shift: Size3,
                 mlp_ratio: int, dtype: torch.dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.mlp = Mlp(dim, mlp_ratio * dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        B, D, H, W, _ = x.shape
        window, shift = window_size_and_shift((D, H, W), self.window,
                                              self.shift)
        shifted = any(shift)
        with span("va/swin.attn"):
            VideoSwin.calls["shifted" if shifted else "window"] += 1
            h = self.norm1(x)
            if shifted:
                h = torch.roll(h, tuple(-s for s in shift), dims=(1, 2, 3))
            bias = self.attn.window_bias(math.prod(window),
                                         mask if shifted else None)
            a = self.attn(window_partition(h, window), bias)
            h = window_reverse(a, window, (B, D, H, W))
            if shifted:
                h = torch.roll(h, shift, dims=(1, 2, 3))
            x = x + h
        with span("va/swin.mlp"):
            return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """(B, D, H, W, C) → (B, D, H/2, W/2, 2C)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    """The published ``BasicLayer``: blocks shifted on odd indices, the
    stage's shift mask made once, then the merge where there is one."""

    def __init__(self, dim: int, depth: int, heads: int, window: Size3,
                 mlp_ratio: int, merge: bool, dtype: torch.dtype):
        super().__init__()
        self.window = window
        self.shift = tuple(n // 2 for n in window)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window,
                      self.shift if i % 2 else (0, 0, 0), mlp_ratio, dtype)
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[1:4])
        window, shift = window_size_and_shift(size, self.window, self.shift)
        mask = (shift_mask(size, window, shift, x.device) if any(shift)
                else None)
        for block in self.blocks:
            x = block(x, mask)
        if self.downsample is not None:
            with span("va/swin.merge"):
                VideoSwin.calls["merge"] += 1
                x = self.downsample(x)
        return x


class PatchEmbed(nn.Module):
    """The patch Conv3d and ``patch_norm``: (N, T, H, W, C) → (N, D, H',
    W', width)."""

    def __init__(self, in_channels: int, dim: int, patch: Size3,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = Conv3d(in_channels, dim, patch, patch, dtype=dtype)
        self.norm = LayerNorm(dim, eps=LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.to(self.proj.dtype).permute(0, 4, 1, 2, 3))
        return self.norm(y.permute(0, 2, 3, 4, 1))


class I3DHead(nn.Module):
    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.fc_cls = Linear(dim, num_classes)


class VideoSwin(nn.Module):
    """Video Swin Transformer over clip volumes (N, T, H, W, C)."""

    clip_input = True
    arch = "swin3d_b"
    calls: Dict[str, int] = {"window": 0, "shifted": 0, "merge": 0}

    def __init__(self, num_classes: int = 400, in_channels: int = 3,
                 width: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (4, 8, 16, 32),
                 window: Size3 = (8, 7, 7), patch: Size3 = (2, 4, 4),
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(depths) != len(heads):
            raise ValueError(f"{len(depths)} stage depths and "
                             f"{len(heads)} head counts")
        self.num_classes, self.in_channels = num_classes, in_channels
        self.width, self.depths, self.heads = width, tuple(depths), \
            tuple(heads)
        self.window, self.patch = tuple(window), tuple(patch)
        self.mlp_ratio, self.dtype = mlp_ratio, dtype
        self.patch_embed = PatchEmbed(in_channels, width, self.patch, dtype)
        last = len(depths) - 1
        self.layers = nn.ModuleList(
            Stage(width * 2 ** i, d, h, self.window, mlp_ratio, i < last,
                  dtype)
            for i, (d, h) in enumerate(zip(depths, heads)))
        self.norm = LayerNorm(self.feature_dim, eps=LN_EPS)
        self.cls_head = I3DHead(self.feature_dim, num_classes)

    @property
    def feature_dim(self) -> int:
        return self.width * 2 ** (len(self.depths) - 1)

    def init(self, generator: torch.Generator) -> "VideoSwin":
        """Seeded initialisation in place, as ``TimeSformer.init`` draws:
        convolution and linear weights N(0, 1/fan_in) (LeCun normal),
        biases 0, LayerNorm scale 1 and shift 0, then every block's
        relative position bias table N(0, 0.02²), the published spread.
        Draws on the CPU, so a seed gives the same weights on every
        device."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.Linear)):
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * m.weight[0].numel() ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
            for m in self.modules():
                if isinstance(m, WindowAttention):
                    t = m.relative_position_bias_table
                    t.copy_(TABLE_SD * torch.randn(t.shape,
                                                   generator=generator))
        return self

    def padding_error(self, T: int, H: int, W: int) -> Optional[str]:
        """Why a clip of T×H×W would need the published code's padding,
        or None."""
        p = self.patch
        if T % p[0] or H % p[1] or W % p[2]:
            return f"not a multiple of the {'x'.join(map(str, p))} patch"
        size = [T // p[0], H // p[1], W // p[2]]
        for i in range(len(self.depths)):
            window, _ = window_size_and_shift(size, self.window,
                                              (0, 0, 0))
            if any(n % w for n, w in zip(size, window)):
                return (f"stage {i + 1}'s {'x'.join(map(str, size))} "
                        f"tokens are not a whole number of "
                        f"{'x'.join(map(str, window))} windows")
            if i < len(self.depths) - 1:
                if size[1] % 2 or size[2] % 2:
                    return (f"stage {i + 1}'s {size[1]}x{size[2]} tokens "
                            f"do not halve")
                size[1:] = size[1] // 2, size[2] // 2
        return None

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        """(N, T, H, W, in_channels) → float32 logits (N, num_classes), or
        the float32 mean of the final LayerNorm's tokens when
        return_features=True."""
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(f"{self.arch}: expected (N, T, H, W, "
                             f"{self.in_channels}) clips, got "
                             f"{tuple(x.shape)}")
        err = self.padding_error(*x.shape[1:4])
        if err is not None:
            raise ValueError(f"{self.arch}: a clip of "
                             f"{'x'.join(map(str, x.shape[1:4]))} needs "
                             f"padding, which this port does not do: {err}")
        with span("va/swin.embed"):
            x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        with span("va/swin.head"):
            features = self.norm(x).mean(dim=(1, 2, 3))
            return (features if return_features
                    else self.cls_head.fc_cls(features))


def video_swin_b(num_classes: int = 400, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 width: int = 128) -> VideoSwin:
    """Video Swin-B, window 8×7×7, patch 2×4×4 (the published
    ``swin_base_patch244_window877``); `width` scales the embedding width
    alone, with heads [4, 8, 16, 32] and an MLP of 4·width a stage."""
    return VideoSwin(num_classes=num_classes, in_channels=in_channels,
                     width=width, dtype=dtype)
