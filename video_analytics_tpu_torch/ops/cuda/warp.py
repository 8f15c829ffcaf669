"""K-A: the TV-L1 warp of (I1, I1x, I1y) fused with the solver's prep.

Replaces ``video_analytics_tpu/ops/pallas/warp.py`` ``_axis_warp`` /
``_axis_warp_inpad`` (through ``pallas_warp_cf``) and the warp + prep half
of ``ops/pallas/tvl1_solve.py`` ``tvl1_scale_pallas``.  The kernel is
``csrc/warp_prep.cu``; its source note says what bounds it and why it
gathers in 2-D where the TPU kernel swept a band.
"""

from __future__ import annotations

import torch

from video_analytics_tpu_torch.ops.cuda import _build
from video_analytics_tpu_torch.ops.kernels import bilinear_sample


def warp_prep_plain(i13: torch.Tensor, i0: torch.Tensor, uv: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version of ``warp_prep``: the reference's
    ``_warp_step`` (exact gather) and the prep of ``_solve_warp``
    (``flow/tvl1.py:121,127``)."""
    B, _, H, W = i13.shape
    u0, v0 = uv[:, 0], uv[:, 1]
    yy = torch.arange(H, dtype=torch.float32, device=uv.device)
    xx = torch.arange(W, dtype=torch.float32, device=uv.device)
    w = bilinear_sample(i13.permute(0, 2, 3, 1), yy[:, None] + v0,
                        xx[None, :] + u0)
    I1w, I1wx, I1wy = w[..., 0], w[..., 1], w[..., 2]
    grad = I1wx * I1wx + I1wy * I1wy
    rho_c = I1w - I1wx * u0 - I1wy * v0 - i0
    return torch.stack([I1wx, I1wy, grad, rho_c], dim=1)


def warp_prep(i13: torch.Tensor, i0: torch.Tensor, uv: torch.Tensor
              ) -> torch.Tensor:
    """Warp I1 and its gradients by the flow and form the solver inputs.

    Args:
      i13: (B, 3, H, W) float32 planes I1, ∂I1/∂x, ∂I1/∂y.
      i0: (B, H, W) float32 first frame.
      uv: (B, 2, H, W) float32 flow (u = dx, v = dy) at the warp's start.

    Returns:
      (B, 4, H, W) float32 planes I1wx, I1wy, grad = |∇I1w|² and
      rho_c = I1w − I1wx·u − I1wy·v − I0.
    """
    if not uv.is_cuda:
        return warp_prep_plain(i13, i0, uv)
    B, _, H, W = uv.shape
    if H < 2 or W < 2:
        raise ValueError(f"warp_prep needs H, W >= 2, got {(H, W)}")
    _build.expect(uv, "uv", (B, 2, H, W), uv.device)
    _build.expect(i13, "i13", (B, 3, H, W), uv.device)
    _build.expect(i0, "i0", (B, H, W), uv.device)
    _build.expect_grid_batch(B, "warp_prep")
    prep = torch.empty((B, 4, H, W), dtype=torch.float32, device=uv.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(uv.device).cuda_stream
    _build.check(lib.va_warp_prep(i13.data_ptr(), i0.data_ptr(),
                                  uv.data_ptr(), prep.data_ptr(),
                                  B, H, W, stream), "warp_prep")
    warp_prep.launches += 1
    return prep


warp_prep.launches = 0
