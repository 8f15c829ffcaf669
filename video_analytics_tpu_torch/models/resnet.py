"""ResNet family as ``nn.Module``s.

Port of ``video_analytics_tpu/models/resnet.py``: the torchvision
structure (7x7/2 stem, 3x3/2 max-pool, four stages of BasicBlocks for
ResNet-18/34 or Bottleneck blocks for ResNet-50, global average pool,
fc), with torchvision's parameter names, so
``models/convert.flax_to_torch`` maps the JAX package's variables onto
it one for one.  The flow-stream variant differs only in its stem's
input channels (2·L stacked flow components).

In training mode the BatchNorms keep the reference's (flax's) running
statistics, the biased batch variance (``BatchNorm2d``).

``fold_bn=True`` is the inference-only folded form of the reference
(``_conv_norm``): every convolution carries a bias, the folded
BatchNorm's shift, and the norm slots are identities;
``models/convert.fold_batchnorm`` makes its weights.

In eval mode on the card, under ``no_grad``, every "BatchNorm, then maybe
a residual add, then maybe ReLU" runs as one pass in place over the
convolution's output (``norm_act``, the kernel ``ops/cuda/bn_act``), with
the roundings of the three ATen ops it replaces.

``dtype`` is the reference's compute dtype: with ``torch.bfloat16`` the
input is cast at entry and every convolution, ReLU, max-pool and residual
add runs in bfloat16, while the parameters and BatchNorm's statistics stay
float32 (``ops/layers``: the casts happen in ``forward``).  BatchNorm
computes its statistics and its normalization in float32 and rounds its
output once to bfloat16, as flax does.  The global mean is accumulated in
float32 and rounded to bfloat16; ``fc`` takes that bfloat16 value, and the
features and logits come back as float32.  A folded convolution adds its
bias after the bfloat16 product is rounded, as flax's ``y += bias`` does
(two roundings, not cuDNN's fused one), so that the folded bfloat16 model
answers as the reference's.  The default, float32, runs as before.

Inputs are NHWC at ``ResNet.forward``, as in the reference; inside, the
network runs NCHW in PyTorch's channels-last memory format.  Convolutions
and the fc layer are cuDNN/cuBLAS, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_analytics_tpu_torch.models.convert import torch_to_flax
from video_analytics_tpu_torch.ops.cuda.bn_act import bn_act, layout_error
from video_analytics_tpu_torch.ops.layers import Conv2d, Linear
from video_analytics_tpu_torch.parallel.mesh import (
    all_reduce_sum, process_count)


def _conv(in_ch: int, out_ch: int, kernel, strides, padding,
          dtype: torch.dtype, fold_bn: bool, layer=Conv2d) -> nn.Module:
    return layer(in_ch, out_ch, kernel, strides, padding, bias=fold_bn,
                 dtype=dtype)


def _reduced_dims(x: torch.Tensor):
    """Every axis of an (N, C, ...) batch but the channels'."""
    return (0, *range(2, x.dim()))


class _FlaxStatistics:
    """The training forward of ``BatchNorm2d`` and ``BatchNorm3d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if process_count() > 1:
            return self._forward_global(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=_reduced_dims(x),
                                       correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        keep = 1.0 - self.momentum
        self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
        self.running_var.mul_(keep).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        dtype, x = x.dtype, x.float()
        c = x.shape[1]
        dims = _reduced_dims(x)
        per_channel = (1, c) + (1,) * (x.dim() - 2)
        sums = all_reduce_sum(torch.cat([x.sum(dims),
                                         x.new_full((1,), x.numel() // c)]))
        count = sums[c]
        mean = sums[:c] / count
        centred = x - mean.view(per_channel)
        var = all_reduce_sum(centred.square().sum(dims)) / count
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = centred * scale.view(per_channel) + self.bias.view(per_channel)
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(dtype)


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode keeps flax's statistics.

    The reference's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` normalizes
    a training batch with its mean and biased variance and updates
    ``var ← 0.9·var + 0.1·biased_var``.  ``nn.BatchNorm2d`` normalizes the
    same way but stores the unbiased variance, n/(n-1) times larger (4/3 at
    the last stage of a batch of 4 at 1×1).  Here the normalization is
    ``F.batch_norm`` with no running buffers (differentiable, cuDNN on the
    card) and the buffers take the biased variance under ``no_grad``.  Eval
    mode is ``nn.BatchNorm2d``'s.

    In a group of processes (``parallel/mesh``), each holding its own rows
    of a training batch, the statistics are those of the global batch, as
    the reference's BatchNorm computes them over a batch sharded across
    devices: the mean from summed sums and counts, then the variance as
    the summed E[(x − E[x])²], both through differentiable all-reduces
    (the gradient flows back through the sums to every process's rows).
    Every process then stores the same running statistics.
    ``nn.SyncBatchNorm`` would store the unbiased variance.

    A bfloat16 input (the model's ``dtype``) is normalized as flax's
    ``BatchNorm(dtype=bfloat16)`` does it: statistics and normalization in
    float32 with the float32 weights and running buffers, the output
    rounded once to bfloat16."""


class BatchNorm3d(_FlaxStatistics, nn.BatchNorm3d):
    """``BatchNorm2d``'s statistics and dtype rules over (N, C, T, H, W)."""


def fusable(norm: nn.Module, y: torch.Tensor,
            residual: Optional[torch.Tensor] = None,
            relu: bool = True) -> bool:
    """Whether ``norm_act`` may take the fused norm pass for `y`, the
    device aside: `norm` an eval ``BatchNorm2d`` / ``BatchNorm3d`` with
    running statistics and affine parameters, all float32 on `y`'s
    device; `y` of its rank in the layout ``bn_act`` takes; the ReLU
    after any residual add; and autograd recording none of them."""
    if (not isinstance(norm, (nn.BatchNorm2d, nn.BatchNorm3d))
            or norm.training or norm.running_mean is None or not norm.affine
            or y.dim() != (4 if isinstance(norm, nn.BatchNorm2d) else 5)
            or (residual is not None and not relu)):
        return False
    if any(t.dtype != torch.float32 or t.device != y.device
           for t in (norm.running_mean, norm.running_var, norm.weight,
                     norm.bias)):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (y, residual, norm.weight, norm.bias)):
        return False
    return layout_error(y, residual) is None


def norm_act(norm: nn.Module, y: torch.Tensor,
             residual: Optional[torch.Tensor] = None,
             relu: bool = True) -> torch.Tensor:
    """``relu(norm(y) + residual)``, the add and the ReLU each optional.

    On the card, where ``fusable`` holds, one launch of the fused norm
    pass overwrites `y` (a convolution's output, which nothing else
    holds) with the result; the BatchNorm module is then not called, so
    its hooks do not fire.  Elsewhere (the CPU, training, the folded
    form's ``nn.Identity``, another layout) the module and ATen's add and
    ReLU."""
    if y.is_cuda and fusable(norm, y, residual, relu):
        return bn_act(y, norm.running_mean, norm.running_var, norm.weight,
                      norm.bias, norm.eps, residual, relu)
    y = norm(y)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _norm(ch: int, fold_bn: bool, norm=BatchNorm2d) -> nn.Module:
    return nn.Identity() if fold_bn else norm(ch)


def _downsample(in_ch: int, out_ch: int, strides: int, dtype: torch.dtype,
                fold_bn: bool, layer=Conv2d, norm=BatchNorm2d
                ) -> Optional[nn.Sequential]:
    if in_ch == out_ch and strides == 1:
        return None
    return nn.Sequential(
        _conv(in_ch, out_ch, 1, strides, 0, dtype, fold_bn, layer),
        _norm(out_ch, fold_bn, norm))


def _shortcut(downsample: Optional[nn.Sequential], x: torch.Tensor
              ) -> torch.Tensor:
    """A block's residual: `x`, or its projection (convolution, norm)."""
    if downsample is None:
        return x
    conv, norm = downsample
    return norm_act(norm, conv(x), relu=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        self.conv1 = _conv(in_ch, filters, 3, strides, 1, dtype, fold_bn)
        self.bn1 = _norm(filters, fold_bn)
        self.conv2 = _conv(filters, filters, 3, 1, 1, dtype, fold_bn)
        self.bn2 = _norm(filters, fold_bn)
        self.downsample = _downsample(in_ch, filters, strides, dtype,
                                      fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = _shortcut(self.downsample, x)
        y = norm_act(self.bn1, self.conv1(x))
        return norm_act(self.bn2, self.conv2(y), residual)


class BottleneckBlock(nn.Module):
    """torchvision Bottleneck (ResNet-50 family, v1.5: the stride sits on
    the 3x3 conv2).  Output channels = filters * 4."""
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = _conv(in_ch, filters, 1, 1, 0, dtype, fold_bn)
        self.bn1 = _norm(filters, fold_bn)
        self.conv2 = _conv(filters, filters, 3, strides, 1, dtype, fold_bn)
        self.bn2 = _norm(filters, fold_bn)
        self.conv3 = _conv(filters, out_ch, 1, 1, 0, dtype, fold_bn)
        self.bn3 = _norm(out_ch, fold_bn)
        self.downsample = _downsample(in_ch, out_ch, strides, dtype, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = _shortcut(self.downsample, x)
        y = norm_act(self.bn1, self.conv1(x))
        y = norm_act(self.bn2, self.conv2(y))
        return norm_act(self.bn3, self.conv3(y), residual)


class ResNet(nn.Module):
    """torchvision-compatible ResNet (18/34 BasicBlock, 50 Bottleneck).
    ``clip_input``: whether ``forward`` takes clip volumes (N, T, H, W, C)
    (``models/video_resnet``) instead of images."""

    clip_input = False

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, in_channels: int = 3,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 bottleneck: bool = False, fold_bn: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.width = width
        self.dtype = dtype
        self.bottleneck = bottleneck
        self.fold_bn = fold_bn
        self._stem()
        ch = self._stages(self._block())
        self.num_stages = len(stage_sizes)
        self.fc = Linear(ch, num_classes, dtype=dtype)

    def _stem(self) -> None:
        self.conv1 = _conv(self.in_channels, self.width, 7, 2, 3, self.dtype,
                           self.fold_bn)
        self.bn1 = _norm(self.width, self.fold_bn)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

    def _block(self) -> type:
        return BottleneckBlock if self.bottleneck else BasicBlock

    def _stages(self, block_cls) -> int:
        """``layer1`` … of `block_cls`, the first block of every stage but
        the first at stride 2; returns the last stage's channels."""
        ch = self.width
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = self.width * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(block_cls(ch, filters, strides, dtype=self.dtype,
                                        fold_bn=self.fold_bn))
                ch = filters * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        return ch

    def clone(self, fold_bn: bool) -> "ResNet":
        """The same architecture and dtype with freshly made weights, in
        the folded or the unfolded form."""
        return type(self)(self.stage_sizes, self.num_classes,
                          self.in_channels, self.width, self.dtype,
                          self.bottleneck, fold_bn)

    @property
    def feature_dim(self) -> int:
        return self.width * 8 * (4 if self.bottleneck else 1)

    def init(self, generator: torch.Generator) -> "ResNet":
        """Seeded initialisation in place, following the reference's flax
        defaults: conv and fc weights N(0, 1/fan_in) (LeCun normal), fc
        bias 0, BatchNorm scale 1, bias 0, running mean 0 and var 1.
        Draws on the CPU, so a seed gives the same weights on every
        device."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    w = torch.randn(m.weight.shape, generator=generator)
                    m.weight.copy_(w * fan_in ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                    m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        """(N, H, W, in_channels) → float32 logits (N, num_classes), or
        the float32 feature_dim penultimate features when
        return_features=True."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {tuple(x.shape)}")
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.maxpool(norm_act(self.bn1, self.conv1(x)))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self._head(x, return_features)

    def _head(self, x: torch.Tensor, return_features: bool) -> torch.Tensor:
        # Global average pool, accumulated in float32 (as jnp.mean does).
        pooled = x.mean(dim=tuple(range(2, x.dim())),
                        dtype=torch.float32).to(self.dtype)
        if return_features:
            return pooled.float()
        return self.fc(pooled).float()


def init_resnet(model: ResNet, generator: torch.Generator,
                input_hw: Tuple[int, int] = (224, 224)) -> Dict[str, Any]:
    """Initialise `model` in place from `generator` (``ResNet.init``) and
    return its variables in the reference's layout (``{"params",
    "batch_stats"}``, numpy leaves), the tree the reference's
    ``init_resnet`` returns.  `input_hw`, the size of the reference's
    dummy batch, is kept for its signature: a torch module's weights are
    made without a forward pass, and no shape depends on it."""
    return torch_to_flax(model.init(generator).state_dict())


def resnet18(num_classes: int = 1000, in_channels: int = 3,
             dtype: torch.dtype = torch.float32, width: int = 64) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes=num_classes,
                  in_channels=in_channels, dtype=dtype, width=width)


def resnet34(num_classes: int = 1000, in_channels: int = 3,
             dtype: torch.dtype = torch.float32, width: int = 64) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes,
                  in_channels=in_channels, dtype=dtype, width=width)


def resnet50(num_classes: int = 1000, in_channels: int = 3,
             dtype: torch.dtype = torch.float32, width: int = 64) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes,
                  in_channels=in_channels, dtype=dtype, width=width,
                  bottleneck=True)


def flow_stream_resnet18(stack: int = 10, num_classes: int = 101,
                         dtype: torch.dtype = torch.float32,
                         width: int = 64) -> ResNet:
    """Temporal-stream net: stem consumes 2*stack flow channels."""
    return resnet18(num_classes=num_classes, in_channels=2 * stack,
                    dtype=dtype, width=width)
