"""The fused norm pass: eval BatchNorm, an optional residual add and an
optional ReLU in one pass over channels-last memory.

Replaces no kernel of ``video_analytics_tpu`` (the reference leaves
BatchNorm to XLA, which fuses it into its neighbours); the kernel is
``csrc/bn_act.cu``, whose source note says what bounds it and how it
walks odd channel counts.  ``models/resnet.norm_act`` decides where it
runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_analytics_tpu_torch.ops.cuda import _build

# csrc/bn_act.cu's BN_MAX_C (a float4 a channel in 48 KB of shared
# memory), which the kernel checks again; a test holds the two equal.
MAX_CHANNELS = 3072
DTYPES = (torch.bfloat16, torch.float32)
_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}


def layout_error(x: torch.Tensor, residual: Optional[torch.Tensor] = None
                 ) -> Optional[str]:
    """Why the kernel cannot take `x` (and `residual`), or None: it takes a
    4-D ``channels_last`` or 5-D ``channels_last_3d`` tensor, dense in that
    format, bfloat16 or float32, 16-byte aligned, with at most
    ``MAX_CHANNELS`` channels; a residual of the same shape, dtype,
    device, strides and alignment.  The device is not checked here."""
    if x.dtype not in DTYPES:
        return f"dtype {x.dtype}, expected one of {DTYPES}"
    if x.dim() not in _FORMATS:
        return f"{x.dim()}-D tensor, expected 4-D or 5-D"
    if not x.is_contiguous(memory_format=_FORMATS[x.dim()]):
        return "not dense in channels-last memory"
    if not 1 <= x.shape[1] <= MAX_CHANNELS:
        return f"{x.shape[1]} channels, expected 1 to {MAX_CHANNELS}"
    if x.data_ptr() % 16:
        return "not 16-byte aligned"
    if residual is None:
        return None
    if (residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or residual.stride() != x.stride()):
        return (f"residual {tuple(residual.shape)} {residual.dtype} on "
                f"{residual.device} with strides {residual.stride()} does "
                f"not match the input's")
    if residual.data_ptr() % 16:
        return "residual not 16-byte aligned"
    return None


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``bn_act``: the kernel's float32
    operations as separate torch ops, in its order, with its roundings to
    ``x.dtype`` (after the norm, after the add)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    invstd = torch.sqrt(var + eps).reciprocal()
    t = ((x.float() - mean.view(shape)) * invstd.view(shape)
         ) * weight.view(shape) + bias.view(shape)
    y = t.to(x.dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(x.dtype)
    return torch.relu(y) if relu else y


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor, eps: float,
           residual: Optional[torch.Tensor] = None,
           relu: bool = True) -> torch.Tensor:
    """``relu(batch_norm(x) + residual)`` with eval statistics, the add and
    the ReLU each optional.

    Args:
      x: (N, C, H, W) ``channels_last`` or (N, C, T, H, W)
        ``channels_last_3d`` activation, bfloat16 or float32 (see
        ``layout_error``).  On the card it is overwritten with the result.
      mean, var, weight, bias: (C,) float32 running statistics and affine
        parameters.
      eps: added to ``var``.
      residual: a tensor like `x` added after the norm, or None.
      relu: whether the ReLU follows.  On the card it must where a
        residual is added (every residual site of the models ends with
        it, so the kernel has no form without it).

    Returns:
      On the card `x`, holding the result; on the CPU ``bn_act_plain``'s
      new tensor.
    """
    if not x.is_cuda:
        return bn_act_plain(x, mean, var, weight, bias, eps, residual, relu)
    err = layout_error(x, residual)
    if err is None and residual is not None and not relu:
        err = "a residual add without the ReLU (the kernel has no such form)"
    if err is not None:
        raise ValueError(f"bn_act: {err}")
    C = x.shape[1]
    for t, name in ((mean, "mean"), (var, "var"), (weight, "weight"),
                    (bias, "bias")):
        _build.expect(t, name, (C,), x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.va_bn_act(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        eps, x.numel(), C, int(x.dtype == torch.bfloat16), int(relu),
        stream), "bn_act")
    bn_act.launches += 1
    if residual is not None:
        bn_act.launches_residual += 1
    return x


bn_act.launches = 0
bn_act.launches_residual = 0
