"""TimeSformer with divided space-time attention: Bertasius, Wang and
Torresani, "Is Space-Time Attention All You Need for Video
Understanding?" (ICML 2021, arXiv:2102.05095), as an ``nn.Module``.
Reference code: facebookresearch/TimeSformer ``vit.py`` with
``attention_type='divided_space_time'``, whose parameter names this
module keeps (``blocks.<i>.temporal_attn.qkv.weight``, ...).

A clip of T frames of H×W is cut into P = (H/16)·(W/16) patches a
frame, each embedded by a 16×16 stride-16 convolution to D channels.
The class token c gets the first row of the spatial position embedding
(P + 1 rows), each frame's patches the other rows, and patch tokens of
frame t the time embedding's row t: z(p, t).  Each block then runs

  1. the time half: for each patch, multi-head self-attention over its T
     tokens after ``temporal_norm1``; the result passes ``temporal_fc``
     and is added to z;
  2. the space half: for each frame, attention over [c; z(·, t)] (P + 1
     tokens) after ``norm1``; c adds the mean over frames of its T
     outputs, each patch token its own output;
  3. the MLP: x + fc2(GELU(fc1(norm2(x)))) over c and every z.

The head is a LayerNorm on c and a linear layer.  TimeSformer-Base
(``timesformer_base``): D = 768, 12 blocks, 12 heads of 64, MLP 3072,
8 frames at 224², LayerNorm ε = 1e-6, exact (erf) GELU.  Dropout and
drop-path are 0 in eval and are not built.

Token layout.  c is held as (N, D), the patch tokens as (N, P, T, D),
the published order (patches, then frames; (h w t)).  The time half
reads them as (N·P, T, D), a view; the space half concatenates
c expanded over frames with z transposed to (N, T, P, D), one copy into
(N·T, P + 1, D), and adds its patch outputs back through the transposed
view, so z stays (N, P, T, D).  The MLP runs on z and on c apart.

Rounding.  The parameters are float32; with ``dtype`` bfloat16 the input
is cast at entry and every projection (``ops/layers.Linear``, two
roundings with a bias), the patch convolution, GELU, the attention
products and each residual or embedding add run in bfloat16.  The
LayerNorms take their statistics and normalise in float32 and round
their output once (``ops/layers.LayerNorm``).  Attention runs at scale
1/√(D/heads) on one of two paths (``Attention``).  On the card in
bfloat16 with autograd off, the time half (heads of 64, T ≤ 32 tokens)
is one launch of ``ops/cuda/short_attn``: the ``qkv`` bias added to the
product with ``Linear``'s two roundings, scores, softmax and weights in
float32 (the weights not rounded), the weighted sum of v accumulated in
float32 and rounded once.  The space half, the CPU, float32 and training
take ``F.scaled_dot_product_attention``, accumulated as its backend does
(float32 in the fused kernels, which round the weights to bfloat16
before their product with v).
The class token's mean over frames is taken in float32 and rounded
once; the final LayerNorm and the head run in float32 and return float32
logits.

Spans: ``va/tsf.embed``, ``va/tsf.time``, ``va/tsf.space``,
``va/tsf.mlp`` (the last three once a block) and ``va/tsf.head``.
``TimeSformer.attn_calls`` counts the attention calls of each half:
a forward adds ``depth`` to ``"time"`` and to ``"space"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_analytics_tpu_torch.ops.cuda.short_attn import (
    layout_error, short_attn)
from video_analytics_tpu_torch.ops.layers import (
    Conv2d, LayerNorm, Linear, linear)
from video_analytics_tpu_torch.utils.spans import span

LN_EPS = 1e-6
EMBED_SD = 0.02


class Attention(nn.Module):
    """Multi-head self-attention over (B, L, D): ``qkv``, attention,
    ``proj``.

    On the card outside float32 the ``qkv`` product is taken without its
    bias.  Where ``short_attn.layout_error`` finds nothing against it
    (bfloat16, heads of 64, at most 32 tokens, D ≤ 1024, autograd off:
    the time half in eval) one launch of ``short_attn`` adds the bias and
    attends.  Elsewhere the bias is added as ``Linear`` adds it and SDPA
    attends, as on the CPU, in float32, in training and wherever scores
    take an additive bias (``forward``'s `bias`, Video Swin's windows)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} is not a multiple of {heads} "
                             f"heads")
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """`bias`, where given, is added to the scaled scores: (G, heads,
        L, L) in the compute dtype with B a multiple of G, sequence b
        taking ``bias[b % G]``.  q, k and v are laid out as (B / G,
        G·heads, L, d) (one copy where G > 1; views where G = 1, as
        without a bias), so that SDPA reads the bias as one (1, G·heads,
        L, L) ``attn_mask`` broadcast over B / G, never copied per
        sequence."""
        B, L, D = x.shape
        qkv = self.qkv
        if x.is_cuda and qkv.dtype != torch.float32:
            y = linear(x, qkv.weight, None, qkv.dtype)
            if bias is None and layout_error(y, qkv.bias, self.heads) is None:
                return self.proj(short_attn(y, qkv.bias, self.heads))
            y = y + qkv.bias.to(qkv.dtype)
        else:
            y = qkv(x)
        G = 1 if bias is None else bias.shape[0]
        mask = None if bias is None else bias.reshape(1, G * self.heads, L, L)
        q, k, v = y.view(B // G, G, L, 3, self.heads, D // self.heads
                         ).permute(3, 0, 1, 4, 2, 5).reshape(
            3, B // G, G * self.heads, L, D // self.heads).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o = o.unflatten(1, (G, self.heads)).permute(0, 1, 3, 2, 4)
        return self.proj(o.reshape(B, L, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """One divided space-time block over (c, z) = ((N, D), (N, P, T, D))."""

    def __init__(self, dim: int, heads: int, mlp: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.attn = Attention(dim, heads, dtype)
        self.temporal_norm1 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.temporal_attn = Attention(dim, heads, dtype)
        self.temporal_fc = Linear(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.mlp = Mlp(dim, mlp, dtype)

    def forward(self, c: torch.Tensor, z: torch.Tensor):
        N, P, T, D = z.shape
        with span("va/tsf.time"):
            TimeSformer.attn_calls["time"] += 1
            a = self.temporal_attn(self.temporal_norm1(z).view(N * P, T, D))
            z = z + self.temporal_fc(a).view(N, P, T, D)
        with span("va/tsf.space"):
            TimeSformer.attn_calls["space"] += 1
            xs = torch.cat([c.view(N, 1, 1, D).expand(N, T, 1, D),
                            z.transpose(1, 2)], dim=2)
            s = self.attn(self.norm1(xs.view(N * T, P + 1, D))
                          ).view(N, T, P + 1, D)
            c = c + s[:, :, 0].mean(1, dtype=torch.float32).to(c.dtype)
            z = z + s[:, :, 1:].transpose(1, 2)
        with span("va/tsf.mlp"):
            c = c + self.mlp(self.norm2(c))
            z = z + self.mlp(self.norm2(z))
        return c, z


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, patch, dtype=dtype)


class TimeSformer(nn.Module):
    """Divided space-time TimeSformer over clip volumes (N, T, H, W, C)."""

    clip_input = True
    arch = "timesformer_base"
    attn_calls: Dict[str, int] = {"time": 0, "space": 0}

    def __init__(self, num_classes: int = 400, in_channels: int = 3,
                 width: int = 768, depth: int = 12, heads: int = 12,
                 mlp: int = 3072, patch: int = 16, frames: int = 8,
                 image_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image size {image_size} is not a multiple "
                             f"of the patch {patch}")
        self.num_classes, self.in_channels = num_classes, in_channels
        self.width, self.depth, self.heads, self.mlp_dim = (width, depth,
                                                            heads, mlp)
        self.patch, self.frames, self.image_size = patch, frames, image_size
        self.dtype = dtype
        self.num_patches = (image_size // patch) ** 2
        self.patch_embed = PatchEmbed(in_channels, width, patch, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1,
                                                  width))
        self.time_embed = nn.Parameter(torch.zeros(1, frames, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(width, eps=LN_EPS)
        self.head = Linear(width, num_classes)

    @property
    def feature_dim(self) -> int:
        return self.width

    def init(self, generator: torch.Generator) -> "TimeSformer":
        """Seeded initialisation in place, as ``ResNet.init`` draws:
        convolution and linear weights N(0, 1/fan_in) (LeCun normal),
        biases 0, LayerNorm scale 1 and shift 0, then the class, position
        and time embeddings N(0, 0.02²).  Draws on the CPU, so a seed
        gives the same weights on every device."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * m.weight[0].numel() ** -0.5)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
            for p in (self.cls_token, self.pos_embed, self.time_embed):
                p.copy_(EMBED_SD * torch.randn(p.shape, generator=generator))
        return self

    def _embed(self, x: torch.Tensor):
        """(N, T, H, W, C) → c (N, D), z (N, P, T, D) in ``dtype``."""
        N, T, H, W, C = x.shape
        x = x.to(self.dtype).reshape(N * T, H, W, C).permute(0, 3, 1, 2)
        x = self.patch_embed.proj(x)               # (N·T, D, h, w)
        x = x.permute(0, 2, 3, 1).reshape(N, T, -1, self.width)
        pos = self.pos_embed[0].to(self.dtype)
        z = x.transpose(1, 2) + pos[1:, None]
        z = (z + self.time_embed[0].to(self.dtype)).contiguous()
        c = self.cls_token[0, 0].to(self.dtype) + pos[0]
        return c.expand(N, self.width).contiguous(), z

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        """(N, T, H, W, in_channels) → float32 logits (N, num_classes), or
        the float32 class token after the final LayerNorm when
        return_features=True."""
        want = (self.frames, self.image_size, self.image_size,
                self.in_channels)
        if x.dim() != 5 or tuple(x.shape[1:]) != want:
            raise ValueError(f"{self.arch}: expected (N, "
                             f"{', '.join(map(str, want))}) clips, got "
                             f"{tuple(x.shape)}")
        with span("va/tsf.embed"):
            c, z = self._embed(x)
        for block in self.blocks:
            c, z = block(c, z)
        with span("va/tsf.head"):
            features = self.norm(c)
            return features if return_features else self.head(features)


def timesformer_base(num_classes: int = 400, in_channels: int = 3,
                     dtype: torch.dtype = torch.float32,
                     width: int = 768) -> TimeSformer:
    """TimeSformer-Base, divided space-time, 8 frames at 224² (the
    published ``TimeSformer_divST_8x32_224``); `width` scales the token
    width alone, with 12 heads and an MLP of 4·width."""
    return TimeSformer(num_classes=num_classes, in_channels=in_channels,
                       width=width, mlp=4 * width, dtype=dtype)
