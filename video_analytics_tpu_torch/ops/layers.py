"""Convolution and dense layers that compute in a chosen dtype while their
parameters stay float32.

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
    ``Conv2d``'s roundings."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``self.dtype`` (float32 parameters)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.dtype)
