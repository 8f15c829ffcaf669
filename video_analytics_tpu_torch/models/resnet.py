"""ResNet-18 family as ``nn.Module``s.

Port of ``video_analytics_tpu/models/resnet.py``: the torchvision
``resnet18`` structure (7x7/2 stem, 3x3/2 max-pool, four stages of
BasicBlocks, global average pool, fc), with torchvision's parameter
names, so ``models/convert.flax_to_torch`` maps the JAX package's
variables onto it one for one.  The flow-stream variant differs only in
its stem's input channels (2·L stacked flow components).

Inputs are NHWC at ``ResNet.forward``, as in the reference; inside, the
network runs NCHW in PyTorch's channels-last memory format.  Convolutions
and the fc layer are cuDNN/cuBLAS, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 3, strides, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters)
        self.downsample: Optional[nn.Sequential] = None
        if in_ch != filters or strides != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, filters, 1, strides, bias=False),
                nn.BatchNorm2d(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """torchvision-compatible BasicBlock ResNet (18/34 family)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, in_channels: int = 3,
                 width: int = 64):
        super().__init__()
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.width = width
        self.conv1 = nn.Conv2d(in_channels, width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        ch = width
        for stage, num_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(ch, filters, strides))
                ch = filters
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(ch, num_classes)

    @property
    def feature_dim(self) -> int:
        return self.width * 8

    def init(self, generator: torch.Generator) -> "ResNet":
        """Seeded initialisation in place, following the reference's flax
        defaults: conv and fc weights N(0, 1/fan_in) (LeCun normal), fc
        bias 0, BatchNorm scale 1, bias 0, running mean 0 and var 1.
        Draws on the CPU, so a seed gives the same weights on every
        device."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * fan_in ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        """(N, H, W, in_channels) → logits (N, num_classes), or the
        feature_dim penultimate features when return_features=True."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {tuple(x.shape)}")
        x = x.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        features = x.mean(dim=(2, 3))       # global average pool
        if return_features:
            return features
        return self.fc(features)


def resnet18(num_classes: int = 1000, in_channels: int = 3,
             width: int = 64) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes=num_classes,
                  in_channels=in_channels, width=width)


def flow_stream_resnet18(stack: int = 10, num_classes: int = 101,
                         width: int = 64) -> ResNet:
    """Temporal-stream net: stem consumes 2*stack flow channels."""
    return resnet18(num_classes=num_classes, in_channels=2 * stack,
                    width=width)
