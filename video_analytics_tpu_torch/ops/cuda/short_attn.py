"""Multi-head self-attention over short sequences, read straight from the
qkv projection's product before its bias.

Replaces no kernel of ``video_analytics_tpu`` (the reference has no video
transformer); the kernel is ``csrc/short_attn.cu``, whose source note says
what bounds it and how it is laid out.  ``models/timesformer.Attention``
decides where it runs: TimeSformer's time half, 8 tokens a sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_analytics_tpu_torch.ops.cuda import _build

# csrc/short_attn.cu's SA_HD, SA_MAX_L and SA_MAX_H · SA_HD, which the
# kernel checks again; a test holds them equal.
HEAD_WIDTH = 64
MAX_LEN = 32
MAX_WIDTH = 1024


def layout_error(y: torch.Tensor, bias: torch.Tensor, heads: int
                 ) -> Optional[str]:
    """Why the kernel cannot take the product `y` (and `bias`) at `heads`
    heads, or None: it takes a (B, L, 3·D) bfloat16 tensor, contiguous and
    16-byte aligned, with 1 ≤ L ≤ ``MAX_LEN``, D ≤ ``MAX_WIDTH`` and heads
    of ``HEAD_WIDTH``, while autograd records neither `y` nor `bias`.  The
    device is not checked here."""
    if y.dtype != torch.bfloat16:
        return f"dtype {y.dtype}, expected torch.bfloat16"
    if y.dim() != 3 or y.shape[2] % 3:
        return f"shape {tuple(y.shape)}, expected (B, L, 3·D)"
    L, D = y.shape[1], y.shape[2] // 3
    if D != heads * HEAD_WIDTH:
        return (f"width {D} over {heads} heads, expected heads of "
                f"{HEAD_WIDTH}")
    if D > MAX_WIDTH:
        return f"width {D}, expected at most {MAX_WIDTH}"
    if not 1 <= L <= MAX_LEN:
        return f"{L} tokens a sequence, expected 1 to {MAX_LEN}"
    if not y.is_contiguous():
        return "not contiguous"
    if y.data_ptr() % 16:
        return "not 16-byte aligned"
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return "autograd records it (the kernel has no backward)"
    return None


def short_attn_plain(y: torch.Tensor, bias: torch.Tensor, heads: int
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``short_attn``: the kernel's operations in
    float32 torch ops, in its order, with its roundings to ``y.dtype``
    (the bias, then the biased product; the output once)."""
    B, L, W = y.shape
    D = W // 3
    qkv = (y.float() + bias.to(y.dtype).float()).to(y.dtype).float()
    q, k, v = qkv.view(B, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * (D // heads) ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e / e.sum(-1, keepdim=True)) @ v
    return o.transpose(1, 2).reshape(B, L, D).to(y.dtype)


def short_attn(y: torch.Tensor, bias: torch.Tensor, heads: int
               ) -> torch.Tensor:
    """``softmax(q·kᵀ / √64)·v`` for each sequence and head, q, k and v
    the thirds of ``y + bias`` rounded as ``ops/layers.linear`` rounds.

    Args:
      y: (B, L, 3·D) qkv product without its bias (q, k, v, then heads
        of 64 within each), bfloat16 (see ``layout_error``).
      bias: (3·D,) float32, the projection's bias; rounded to y's dtype
        (one cast launch) before the kernel adds it.
      heads: D / 64.

    Returns:
      (B, L, D) in y's dtype, contiguous, the heads side by side: on the
      card the kernel's new tensor, on the CPU ``short_attn_plain``'s.
    """
    if not y.is_cuda:
        return short_attn_plain(y, bias, heads)
    err = layout_error(y, bias, heads)
    if err is not None:
        raise ValueError(f"short_attn: {err}")
    B, L, W = y.shape
    _build.expect(bias, "bias", (W,), y.device)
    if B > 2 ** 31 - 1:
        raise ValueError(f"short_attn: {B} sequences, one block each, pass "
                         f"the grid's 2^31 - 1")
    rounded = bias.to(y.dtype)     # a new tensor, so 16-byte aligned
    out = torch.empty((B, L, W // 3), dtype=y.dtype, device=y.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _build.check(lib.va_short_attn(y.data_ptr(), rounded.data_ptr(),
                                   out.data_ptr(), B, L, heads, stream),
                 "short_attn")
    short_attn.launches += 1
    return out


short_attn.launches = 0
