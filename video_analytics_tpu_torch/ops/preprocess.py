"""Preprocessing on the device: resize → crop → normalize → stack.

Port of ``video_analytics_tpu/ops/preprocess.py``: the eval branch, which
serving and the stage commands run, and the training branch's random crop
and flip.  Arrays stay NHWC at these public boundaries, as in the
reference.  Numerics follow the same oracles:

- resize: bilinear with half-pixel centers and no antialiasing —
  cv2.resize(INTER_LINEAR) semantics;
- center crop: torchvision's rounding, top = round((H - c)/2);
- random crop + flip: one offset and one flip per window, shared by its
  frames; the draws come from an explicit ``torch.Generator`` on the host
  (``sample_crop_flip``) and are applied on the device in one gather
  (``crop_flip``), so a caller can also hand in another generator's draws;
- normalize: x/255 → (x - mean)/std with ImageNet statistics.

The fused resize + center crop is the reference's
``jax.image.scale_and_translate`` (linear, no antialias), which has no
one-op PyTorch equal: the per-axis weight matrices are built on the host
with the reference's formula (``ops.kernels.linear_weight_matrix``) and
applied with ``torch.einsum``.  This is plain tensor code in the
reference too (XLA, not a Pallas kernel).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from video_analytics_tpu_torch.config import PreprocessConfig
from video_analytics_tpu_torch.ops.kernels import (
    linear_weight_matrix, resize_weights)


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, device: torch.device
                    ) -> torch.Tensor:
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., h, w, C) float32:
    cv2.INTER_LINEAR parity, half-pixel centers, no antialias (the
    reference's ``jax.image.resize(linear, antialias=False)``, with its
    per-axis weight matrices)."""
    wh = _resize_weights(x.shape[-3], out_hw[0], x.device)
    ww = _resize_weights(x.shape[-2], out_hw[1], x.device)
    return torch.einsum("...hwc,ho,wp->...opc", x.float(), wh, ww)


def short_side_hw(h: int, w: int, short: int) -> Tuple[int, int]:
    """(h, w) scaled so that the short side equals `short`, keeping aspect
    (torchvision Resize(int) semantics)."""
    if h <= w:
        return short, max(1, int(round(w * short / h)))
    return max(1, int(round(h * short / w))), short


def resize_short_side(x: torch.Tensor, short: int) -> torch.Tensor:
    """Resize (..., H, W, C) so the short side equals `short`, keeping
    aspect."""
    return resize_bilinear(x, short_side_hw(x.shape[-3], x.shape[-2],
                                             short))


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    if h < crop or w < crop:
        raise ValueError(f"cannot center-crop {crop} from {(h, w)}")
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return x[..., top:top + crop, left:left + crop, :]


def crop_source_geometry(h: int, w: int, short: int, crop: int):
    """Geometry of the fused ``center_crop(resize_short(x), crop)``:
    the (row, col) source window the cropped output actually samples,
    plus the scale/translate that aligns the fractional offset on the
    sliced window.

    Returns ``((r0, r1, c0, c1), (sh, th), (sw, tw))`` — slice bounds
    into the ORIGINAL (h, w) image and the per-axis scale and translation
    valid for the slice.  Shared by the device path
    (resize_short_center_crop) and the host transport crop
    (ingest.windows.slice_crop_source).
    """
    rh, rw = short_side_hw(h, w, short)
    if rh < crop or rw < crop:
        raise ValueError(f"cannot center-crop {crop} from {(rh, rw)}")
    top = int(round((rh - crop) / 2.0))
    left = int(round((rw - crop) / 2.0))

    def axis_window(n_in: int, n_out: int, off: int):
        k = n_in / n_out
        lo = (off + 0.5) * k - 0.5
        hi = (off + crop - 0.5) * k - 0.5
        s0 = max(0, math.floor(lo))
        s1 = min(n_in, math.ceil(hi) + 2)
        # translation per jax's convention: in = (o+0.5)/s - t/s - 0.5
        t = -(1.0 / k) * (off * k - s0)
        return s0, s1, 1.0 / k, t

    r0, r1, sh, th = axis_window(h, rh, top)
    c0, c1, sw, tw = axis_window(w, rw, left)
    return (r0, r1, c0, c1), (sh, th), (sw, tw)


@functools.lru_cache(maxsize=32)
def _crop_weights(n_in: int, n_out: int, scale: float, translation: float,
                  device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of ``scale_and_translate`` along one axis.
    There scale and translation are float32 arrays, so ``1 / scale`` and
    ``translation / scale`` round in float32."""
    s = np.float32(scale)
    inv = np.float32(1.0) / s
    shift = np.float32(translation) * inv
    w = linear_weight_matrix(n_in, n_out, inv, shift)
    return torch.from_numpy(w).to(device)


def resize_short_center_crop(x: torch.Tensor, short: int, crop: int,
                             src_hw: Optional[Tuple[int, int]] = None
                             ) -> torch.Tensor:
    """Fused ``center_crop(resize_short_side(x), crop)`` of
    (..., H, W, C) → (..., crop, crop, C) float32.

    Only the source window the cropped output samples is read.
    ``src_hw=(H, W)``: `x` is ALREADY the host-sliced source window of
    an (H, W) image (ingest.windows.slice_crop_source) — skip the slice
    and use the same fractional offsets.
    """
    if src_hw is not None:
        h, w = src_hw
    else:
        h, w = x.shape[-3], x.shape[-2]
    (r0, r1, c0, c1), (sh, th), (sw, tw) = crop_source_geometry(
        h, w, short, crop)
    if src_hw is not None:
        if x.shape[-3] != r1 - r0 or x.shape[-2] != c1 - c0:
            raise ValueError(
                f"src_hw={src_hw} expects a pre-sliced "
                f"{(r1 - r0, c1 - c0)} window, got {tuple(x.shape[-3:-1])}")
        sl = x.float()
    else:
        sl = x[..., r0:r1, c0:c1, :].float()
    wh = _crop_weights(sl.shape[-3], crop, sh, th, x.device)
    ww = _crop_weights(sl.shape[-2], crop, sw, tw, x.device)
    return torch.einsum("...hwc,ho,wp->...opc", sl, wh, ww)


@functools.lru_cache(maxsize=32)
def _constant(values: Tuple[float, ...], device: torch.device
              ) -> torch.Tensor:
    """A float32 vector of `values` on `device`, made once.  A tensor made
    from a host list is copied from pageable memory, which synchronises
    the device's stream: made on every call, the constants of
    ``normalize`` and ``rgb_to_gray`` drained the launch queue twice a
    ``classify_batch``."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8/float [0,255] (..., C) → ImageNet-normalized float32."""
    mean = _constant(tuple(float(m) for m in mean), x.device)
    std = _constant(tuple(float(s) for s in std), x.device)
    return (x.float() / 255.0 - mean) / std


def sample_crop_flip(generator: torch.Generator, batch: int, h: int, w: int,
                     crop: int, flip: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw a random crop (and, with `flip`, a horizontal flip) for each of
    `batch` windows of (h, w) frames: ``(tops, lefts, flips)``, int64,
    int64 and bool tensors of shape (batch,) on the CPU, from `generator`.
    Offsets are uniform over every crop that fits, as the reference's
    ``random_crop_flip`` draws them; flips are fair coins, or all False."""
    if h < crop or w < crop:
        raise ValueError(f"cannot crop {crop} from {(h, w)}")
    tops = torch.randint(0, h - crop + 1, (batch,), generator=generator)
    lefts = torch.randint(0, w - crop + 1, (batch,), generator=generator)
    if flip:
        flips = torch.rand(batch, generator=generator) < 0.5
    else:
        flips = torch.zeros(batch, dtype=torch.bool)
    return tops, lefts, flips


def crop_flip(x: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
              flips: torch.Tensor, crop: int) -> torch.Tensor:
    """(B, T, H, W, C) windows → (B, T, crop, crop, C): window b cropped at
    (tops[b], lefts[b]), the same offset for all its frames, and mirrored
    along W where flips[b] — the reference's vmapped ``random_crop_flip``
    given the same draws.  The draws are host tensors (checked there);
    they cross to x's device in one copy, and one batched gather applies
    them, with nothing waiting for the device."""
    B, _, H, W, _ = x.shape
    draws = torch.stack([tops.long(), lefts.long(), flips.long()])
    if draws.shape != (3, B):
        raise ValueError(f"expected {B} draws each, got {tuple(draws.shape)}")
    if not (0 <= int(draws[:2].min()) and int(tops.max()) + crop <= H
            and int(lefts.max()) + crop <= W):
        raise ValueError(f"crop offsets outside {(H, W)} for crop {crop}")
    draws = draws.to(x.device, non_blocking=True)
    r = torch.arange(crop, device=x.device)
    rows = draws[0, :, None] + r                              # (B, crop)
    cols = draws[1, :, None] + torch.where(draws[2, :, None] != 0,
                                           crop - 1 - r, r)
    b = torch.arange(B, device=x.device)[:, None, None]
    # Advanced indices on either side of the T slice: the broadcast
    # (B, crop, crop) dimensions come first.
    out = x[b, :, rows[:, :, None], cols[:, None, :]]       # (B, c, c, T, C)
    return out.permute(0, 3, 1, 2, 4)


def random_crop_flip(x: torch.Tensor, crop: int, generator: torch.Generator,
                     flip: bool = True) -> torch.Tensor:
    """Random spatial crop of (..., H, W, C) frames, one offset per call
    shared across the clip so that it stays coherent in time, and with
    `flip` a horizontal flip on a fair coin: ``sample_crop_flip`` draws
    once from `generator`, ``crop_flip`` applies the draw."""
    h, w = x.shape[-3], x.shape[-2]
    tops, lefts, flips = sample_crop_flip(generator, 1, h, w, crop, flip)
    out = crop_flip(x.reshape(1, -1, h, w, x.shape[-1]), tops, lefts,
                    flips, crop)
    return out.reshape(*x.shape[:-3], crop, crop, x.shape[-1])


def preprocess_clip(frames: torch.Tensor, cfg: PreprocessConfig,
                    crops: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None
                    ) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB → (T, crop, crop, 3) normalized float32.

    With ``cfg.random_crop`` (training) the clip is resized and then
    cropped and flipped by `crops`, the ``sample_crop_flip`` draws of a
    batch of one (the reference's PRNG key); otherwise the eval transform,
    resize + center crop."""
    if cfg.random_crop:
        if crops is None:
            raise ValueError("random_crop requires the drawn crops "
                             "(sample_crop_flip)")
        x = resize_short_side(frames, cfg.resize_short)
        x = crop_flip(x[None], *crops, cfg.crop)[0]
    else:
        x = resize_short_center_crop(frames, cfg.resize_short, cfg.crop,
                                     src_hw=cfg.src_hw)
    return normalize(x, cfg.mean, cfg.std)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB → (...,) gray float32 with cv2's BT.601 weights."""
    w = _constant((0.299, 0.587, 0.114), frames.device)
    return torch.tensordot(frames.float(), w, dims=([-1], [0]))


def stack_flow_windows(flow: torch.Tensor, stack: int,
                       stride: int = 1) -> torch.Tensor:
    """(T-1, H, W, 2) flow fields → (N, H, W, 2*stack) stacked windows:
    `stack` consecutive (u, v) fields as 2*stack channels, windows
    starting at multiples of `stride`."""
    t = flow.shape[0]
    if t < stack:
        raise ValueError(f"need >= {stack} flow fields, got {t}")
    starts = range(0, t - stack + 1, stride)
    wins = torch.stack([flow[s:s + stack] for s in starts])  # (N, L, H, W, 2)
    n, _, h, w, _ = wins.shape
    return wins.permute(0, 2, 3, 1, 4).reshape(n, h, w, 2 * stack)


def normalize_flow_stack(x: torch.Tensor, bound: float = 20.0
                         ) -> torch.Tensor:
    """Clip flow to ±bound and scale to [-1, 1] — the dequantized-uint8
    convention the flow stream is trained on."""
    return x.clamp(-bound, bound) / bound


def stacked_flow_input(flow: torch.Tensor, stack: int, bound: float = 20.0,
                       dtype: Optional[torch.dtype] = None,
                       stride: int = 1) -> torch.Tensor:
    """``normalize_flow_stack(stack_flow_windows(flow, stack), bound)``
    with the elementwise clip/scale, and the cast to the CNN's `dtype`
    when it is given, done before the stacking, which copies each field
    up to `stack` times.  Equal at the CNN input to casting the stacks:
    the CNN's own cast to its dtype is then a no-op."""
    f = normalize_flow_stack(flow, bound)
    if dtype is not None:
        f = f.to(dtype)
    return stack_flow_windows(f, stack, stride)
