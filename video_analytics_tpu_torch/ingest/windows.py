"""Host-side clip shaping before frames go to the device.

Port of ``video_analytics_tpu/ingest/windows.py`` (numpy only; cv2 is
imported lazily, where a resize is needed).  ``sliding_windows`` cuts a
long clip into fixed-shape (window, H, W, C) chunks (BASELINE.json config
#5, the sustained 1080p stream); temporal pooling is a mean, so the
per-window results average to the clip's.  The other helpers shape
frames for serving and eval before the host→device copy.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from video_analytics_tpu_torch.ops.preprocess import crop_source_geometry


def window_starts(num_frames: int, window: int, stride: int) -> List[int]:
    """Start indices covering the clip: always at least one window, and
    the tail covered by a final (possibly overlapping) window."""
    if num_frames <= window:
        return [0]
    starts = list(range(0, num_frames - window + 1, stride))
    last = num_frames - window
    if starts[-1] != last:
        starts.append(last)
    return starts


def sliding_windows(frames: np.ndarray, window: int,
                    stride: int) -> Iterator[np.ndarray]:
    """(T, H, W, C) → fixed-shape (window, H, W, C) views at
    ``window_starts``; a clip shorter than `window` is padded by repeating
    its last frame."""
    t = frames.shape[0]
    if t < window:
        pad = np.repeat(frames[-1:], window - t, axis=0)
        yield np.concatenate([frames, pad], axis=0)
        return
    for s in window_starts(t, window, stride):
        yield frames[s:s + window]


def host_normalize_square(frames: np.ndarray, short: int,
                          crop: Optional[int] = None) -> np.ndarray:
    """(T, H, W, 3) uint8 → (T, short, short, 3): resize the short side
    to `short` (up OR down, cv2 INTER_LINEAR) and centre-crop the long
    side to `short`, so every input resolution maps to one shape.

    `crop` is the crop size the device pipeline takes next
    (ops.preprocess.resize_short_center_crop): with it, this function's
    offset is (device offset on the raw resize) − (device offset on the
    short×short result), so the two centre crops compose exactly for
    every geometry under banker's rounding.  Without `crop` the naive
    centred offset is used (≤1px shift).  Frames already at a short side
    of `short` need no cv2."""
    h, w = frames.shape[1:3]
    if h <= w:
        nh, nw = short, max(short, int(round(w * short / h)))
    else:
        nh, nw = max(short, int(round(h * short / w))), short
    if (nh, nw) != (h, w):
        import cv2
        frames = np.stack([
            cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
            for f in frames])

    def offset(long_side: int) -> int:
        if crop is not None:
            o = (int(round((long_side - crop) / 2.0))
                 - int(round((short - crop) / 2.0)))
        else:
            o = int(round((long_side - short) / 2.0))
        return min(max(o, 0), long_side - short)

    top, left = offset(nh), offset(nw)
    return frames[:, top:top + short, left:left + short]


def slice_crop_source(frames: np.ndarray, short: int, crop: int):
    """Transport crop: slice (..., H, W, 3) frames to the exact source
    window the fused device resize + center crop samples, before the
    host→device copy.  Bit-identical downstream, because the device is
    handed the same window with the same fractional offsets (pass the
    returned (H, W) as PreprocessConfig.src_hw).

    Returns ``(sliced, (H, W))``.
    """
    h, w = frames.shape[-3], frames.shape[-2]
    (r0, r1, c0, c1), _, _ = crop_source_geometry(h, w, short, crop)
    return np.ascontiguousarray(frames[..., r0:r1, c0:c1, :]), (h, w)


def apply_transport_crop(frames: np.ndarray, cfg):
    """Slice `frames` (..., H, W, 3) to the source window of the fused
    device resize + crop and return ``(frames, cfg')`` with
    ``cfg'.preprocess.src_hw`` recording the pre-slice geometry.  No-op
    when the pipeline random-crops or a src_hw is already recorded."""
    pp = cfg.preprocess
    if pp.random_crop or pp.src_hw is not None:
        return frames, cfg
    frames, hw = slice_crop_source(frames, pp.resize_short, pp.crop)
    return frames, dataclasses.replace(
        cfg, preprocess=dataclasses.replace(pp, src_hw=hw))


def host_resize_short(frames: np.ndarray, short: int) -> np.ndarray:
    """(T, H, W, 3) uint8 → short side == `short`, by cv2 INTER_LINEAR on
    the host; frames whose short side is already at most `short` pass
    through.  The pipeline only consumes pixels at resize_short
    resolution, so resizing before the host→device copy cuts the bytes
    copied by ~(H/short)² for high-resolution clips, at the cost of host
    CPU the decode thread already owns.  ``eval-ucf101 --batched`` does
    this in its decode workers, then ``slice_crop_source`` on the result
    (with the resized (H, W) as src_hw)."""
    h, w = frames.shape[1:3]
    if min(h, w) <= short:
        return frames
    import cv2
    if h <= w:
        nh, nw = short, max(1, int(round(w * short / h)))
    else:
        nh, nw = max(1, int(round(h * short / w))), short
    return np.stack([
        cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
        for f in frames])
