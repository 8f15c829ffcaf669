"""Convolution, dense and LayerNorm layers that compute in a chosen dtype
while their parameters stay float32.

The reference's CNNs take a compute ``dtype`` (flax's ``dtype=``, with
``param_dtype=float32``): with ``bfloat16`` the input, the kernel and the
bias are cast to bfloat16 where the layer runs, and the product is
bfloat16.  These layers do the same with explicit casts in ``forward``
(no ``torch.autocast``, which would also reach the flow path's float32
matrix products, and no ``module.to(bfloat16)``, which would change the
stored weights): the ``state_dict``, the checkpoint and the optimizer see
float32, and gradients reach the float32 parameters through the casts.

With a bias, the reduced-precision product is rounded to ``dtype`` and the
cast bias is added after it, a second rounding, as flax's ``y += bias``
does.  A fused bias (cuDNN's, cuBLAS's epilogue) would round once; the
two roundings are kept so that the port's bfloat16 agrees with the
reference's.  In float32 the layers are ``nn.Conv2d`` / ``nn.Linear``
unchanged, fused bias included.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` computed in `dtype`: flax ``nn.Dense(dtype=...)``."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class _RoundedConv:
    """The forward of a convolution computing in ``self.dtype``: the
    product rounded to it, then the cast bias added (two roundings)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                               None)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype).view(-1, *[1] * (y.dim() - 2))


class Conv2d(_RoundedConv, nn.Conv2d):
    """``nn.Conv2d`` computing in ``self.dtype`` (float32 parameters):
    flax ``nn.Conv(dtype=..., param_dtype=float32)``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype


class Conv3d(_RoundedConv, nn.Conv3d):
    """``nn.Conv3d`` computing in ``self.dtype`` (float32 parameters), with
    ``Conv2d``'s roundings.

    A t×1×1 kernel (spatial stride 1, no spatial padding, no dilation, one
    group) over a plane of at least ``MIN_PLANE`` positions runs as a 2-D
    convolution: (N, C, T, H, W) is viewed as (N, C, T, H·W) and the
    weight as (C_out, C_in, t, 1).  In channels-last-3d memory both views
    are channels-last 2-D tensors over the same storage, and the output
    unflattens back to channels-last-3d without a copy.  The taps, the
    operands and the accumulation are those of the 3-D call.  Every other
    kernel and plane keeps the 3-D call.  ``Conv3d.as_conv2d`` counts the
    calls that take the 2-D route."""

    # R(2+1)D-34's 3×1×1 convolutions in bfloat16 on an H100: at 56²
    # cuDNN runs the 3-D call on a float32 NCHW fallback with layout
    # conversions, 4.5-18x slower than the 2-D form; at 28² both launch
    # the same bfloat16 kernel; at 14² and 7² the 2-D form's kernel is the
    # slower one.
    MIN_PLANE = 32 * 32
    as_conv2d = 0

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def takes_conv2d(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through the 2-D route."""
        return (self.kernel_size[1:] == (1, 1) and self.stride[1:] == (1, 1)
                and self.padding_mode == "zeros"
                and self.padding[1:] == (0, 0)
                and self.dilation == (1, 1, 1) and self.groups == 1
                and x.shape[-2] * x.shape[-1] >= self.MIN_PLANE)

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.takes_conv2d(x):
            return super()._conv_forward(x, weight, bias)
        Conv3d.as_conv2d += 1
        n, _, t, h, w = x.shape
        # Through (N, T, H·W, C): ``flatten(3)`` would give a batch of one
        # clip strides that PyTorch no longer reads as channels-last.
        x2 = x.permute(0, 2, 3, 4, 1).reshape(n, t, h * w, -1)
        y = F.conv2d(x2.permute(0, 3, 1, 2), weight.flatten(3), bias,
                     (self.stride[0], 1), (self.padding[0], 0))
        return y.permute(0, 2, 3, 1).reshape(n, -1, h, w, y.shape[1]
                                             ).permute(0, 4, 1, 2, 3)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``self.dtype`` (float32 parameters)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axes computing in ``self.dtype``
    (float32 parameters).  The input is cast to ``dtype``, and so are the
    scale and shift, as the other layers cast their weights; ATen's kernel
    then takes the mean and variance and normalises in float32 and rounds
    the output once to ``dtype``.  In float32 it is ``nn.LayerNorm``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x.float())
        return F.layer_norm(x.to(self.dtype), self.normalized_shape,
                            self.weight.to(self.dtype),
                            self.bias.to(self.dtype), self.eps)
