"""R(2+1)D: the video ResNet of Tran et al., "A Closer Look at
Spatiotemporal Convolutions for Action Recognition" (CVPR 2018,
arXiv:1711.11248), as an ``nn.Module``.

Every 3×3×3 convolution of a 3D ResNet is factorised into a 1×3×3
spatial convolution to M channels, BatchNorm and ReLU, and a 3×1×1
temporal convolution to N_out channels (``Conv2Plus1d``), with the
paper's per-convolution midplane count M = ⌊27·N_in·N_out / (9·N_in +
3·N_out)⌋ (``midplanes``), which keeps the parameters of the full 3D
convolution.  torchvision's ``r2plus1d_18`` (and facebookresearch/VMZ's
blocks) reuse the count of a block's first convolution for its second;
here each convolution takes its own: in the first block of stages 2-4
the second convolution has 288, 576 and 1152 midplanes, not 230, 460
and 921.

The stem is a (2+1)D convolution 1×7×7 (stride 1, 2, 2) to 45 channels,
BatchNorm, ReLU, 3×1×1 to ``width``, then BatchNorm and ReLU; no
max-pool.  The stages are ``resnet.ResNet``'s loop over basic blocks
(``VideoBasicBlock``); the first block of stages 2-4 halves time and
space (stride 2 in both factors), with a 1×1×1 stride-2 projection and
BatchNorm on the shortcut.  A global 3D average pool and ``fc`` end it.
At 32×112² a stream runs 32×56² → 16×28² → 8×14² → 4×7².

The rules of ``models/resnet`` hold: float32 parameters, the compute
``dtype`` applied in each layer's ``forward`` (``ops/layers.Conv3d``, two
roundings with a bias), BatchNorm's statistics and normalization in
float32 (``resnet.BatchNorm3d``), the global mean accumulated in float32;
``fold_bn=True`` is the folded inference form, its weights from
``models/convert.fold_batchnorm``; eval on the card takes the fused norm
pass (``resnet.norm_act``) at every BatchNorm.

Input (N, T, H, W, C) at ``forward``: a clip volume, each of T frames
(RGB) or flow fields (u, v); inside, (N, C, T, H, W) in PyTorch's
channels-last-3d memory format.  Spans: ``va/r2p1d.stem``,
``va/r2p1d.stage<k>`` (k = 1…4) and ``va/r2p1d.head``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from video_analytics_tpu_torch.models.resnet import (
    BasicBlock, BatchNorm3d, ResNet, _conv, _downsample, _norm, norm_act)
from video_analytics_tpu_torch.ops.layers import Conv3d
from video_analytics_tpu_torch.utils.spans import span

STEM_MIDPLANES = 45


def midplanes(n_in: int, n_out: int, t: int = 3, d: int = 3) -> int:
    """The paper's M for a t×d×d convolution from n_in to n_out channels:
    ⌊t·d²·n_in·n_out / (d²·n_in + t·n_out)⌋."""
    return (t * d * d * n_in * n_out) // (d * d * n_in + t * n_out)


class Conv2Plus1d(nn.Module):
    """A 1×k×k convolution (stride 1, s, s) to `mid` channels, BatchNorm,
    ReLU, then a t×1×1 convolution (stride t_stride, 1, 1) to `out_ch`."""

    def __init__(self, in_ch: int, mid: int, out_ch: int, strides: int = 1,
                 k: int = 3, t: int = 3, t_strides: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        t_strides = strides if t_strides is None else t_strides
        self.spatial = _conv(in_ch, mid, (1, k, k), (1, strides, strides),
                             (0, k // 2, k // 2), dtype, fold_bn, Conv3d)
        self.bn = _norm(mid, fold_bn, BatchNorm3d)
        self.temporal = _conv(mid, out_ch, (t, 1, 1), (t_strides, 1, 1),
                              (t // 2, 0, 0), dtype, fold_bn, Conv3d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal(norm_act(self.bn, self.spatial(x)))


class VideoBasicBlock(nn.Module):
    """``resnet.BasicBlock`` with (2+1)D convolutions."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2Plus1d(in_ch, midplanes(in_ch, filters), filters,
                                 strides, dtype=dtype, fold_bn=fold_bn)
        self.bn1 = _norm(filters, fold_bn, BatchNorm3d)
        self.conv2 = Conv2Plus1d(filters, midplanes(filters, filters),
                                 filters, dtype=dtype, fold_bn=fold_bn)
        self.bn2 = _norm(filters, fold_bn, BatchNorm3d)
        self.downsample = _downsample(in_ch, filters, strides, dtype,
                                      fold_bn, Conv3d, BatchNorm3d)

    forward = BasicBlock.forward


class VideoResNet(ResNet):
    """R(2+1)D over clip volumes; ``ResNet``'s stage loop, ``init``,
    ``clone`` and head."""

    clip_input = True

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 400, in_channels: int = 3,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 bottleneck: bool = False, fold_bn: bool = False):
        if bottleneck:
            raise ValueError("R(2+1)D is built of basic blocks")
        super().__init__(stage_sizes, num_classes, in_channels, width, dtype,
                         False, fold_bn)

    def _stem(self) -> None:
        self.conv1 = Conv2Plus1d(self.in_channels, STEM_MIDPLANES,
                                 self.width, strides=2, k=7, t_strides=1,
                                 dtype=self.dtype, fold_bn=self.fold_bn)
        self.bn1 = _norm(self.width, self.fold_bn, BatchNorm3d)

    def _block(self) -> type:
        return VideoBasicBlock

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        """(N, T, H, W, in_channels) → float32 logits (N, num_classes), or
        the float32 penultimate features when return_features=True."""
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected (N, T, H, W, {self.in_channels}) "
                             f"clips, got {tuple(x.shape)}")
        with span("va/r2p1d.stem"):
            x = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
                memory_format=torch.channels_last_3d)
            x = norm_act(self.bn1, self.conv1(x))
        for stage in range(self.num_stages):
            with span("va/r2p1d.stage%d", stage + 1):
                x = getattr(self, f"layer{stage + 1}")(x)
        with span("va/r2p1d.head"):
            return self._head(x, return_features)


def r2plus1d_34(num_classes: int = 400, in_channels: int = 3,
                dtype: torch.dtype = torch.float32,
                width: int = 64) -> VideoResNet:
    """R(2+1)D-34: stages [3, 4, 6, 3] of basic blocks."""
    return VideoResNet((3, 4, 6, 3), num_classes=num_classes,
                       in_channels=in_channels, dtype=dtype, width=width)
