"""Host-side video I/O: container demux and frame decode.

The port's own copy of what it uses from ``video_analytics_tpu/io/video.py``
(OpenCV and numpy only; ``cv2`` is imported where it is used, so the
package imports without it).  This is the only host-CPU hot path:
everything downstream of the decoded frames runs on the device.

Frames-on-disk convention: ``<out_dir>/frame_%06d.jpg``, 1-indexed,
written as BGR through cv2, so a round trip through ``extract-frames`` is
bit-faithful to a plain OpenCV pipeline.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

FRAME_PATTERN = "frame_{:06d}.jpg"
_FRAME_RE = re.compile(r"frame_(\d{6})\.(jpg|jpeg|png)$")


class VideoReader:
    """Thin iterator over decoded RGB frames of one container."""

    def __init__(self, path: str):
        import cv2
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"could not open video: {path}")

    @property
    def fps(self) -> float:
        import cv2
        return float(self._cap.get(cv2.CAP_PROP_FPS))

    @property
    def frame_count(self) -> int:
        """May be approximate for some containers; 0 when unknown."""
        import cv2
        return int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    @property
    def size(self) -> Tuple[int, int]:
        """(height, width)."""
        import cv2
        return (int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)))

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2
        while True:
            ok, frame_bgr = self._cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)

    def read_all(self, max_frames: Optional[int] = None) -> np.ndarray:
        """Decode the whole clip → (T, H, W, 3) uint8 RGB."""
        frames: List[np.ndarray] = []
        for i, f in enumerate(self):
            if max_frames is not None and i >= max_frames:
                break
            frames.append(f)
        if not frames:
            raise IOError(f"no frames decoded from {self.path}")
        return np.stack(frames)

    def read_window(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start+count) → (count, H, W, 3) RGB.

        Bit-identical to ``read_all()[start:start+count]`` without the
        full-clip decode: a container seek positions the demuxer, with a
        ``grab()`` skip from frame 0 where the backend's seek cannot be
        verified for this container.
        """
        import cv2
        if start < 0 or count <= 0:
            raise ValueError(f"bad window [{start}, {start}+{count})")
        # Seek always, start == 0 included: an earlier probe
        # (_frame_count_exact) may have moved the demuxer.
        seek_ok = self._cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        pos = int(self._cap.get(cv2.CAP_PROP_POS_FRAMES))
        if not seek_ok or pos != start:
            # Rewind and grab-skip; the seek was just shown unreliable, so
            # verify the rewind landed on frame 0 (reopen if not).
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            if int(self._cap.get(cv2.CAP_PROP_POS_FRAMES)) != 0:
                self._cap.release()
                self._cap = cv2.VideoCapture(self.path)
                if not self._cap.isOpened():
                    raise IOError(f"could not reopen video: {self.path}")
            for _ in range(start):
                if not self._cap.grab():
                    raise IOError(f"could not skip to frame {start} "
                                  f"of {self.path}")
        frames: List[np.ndarray] = []
        for _ in range(count):
            ok, bgr = self._cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        if len(frames) != count:
            raise IOError(f"short window [{start}, {start}+{count}) in "
                          f"{self.path}: got {len(frames)} frames")
        return np.stack(frames)

    def close(self):
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(path: str) -> VideoReader:
    """A ``VideoReader`` on `path` (close it, or use it in a ``with``)."""
    return VideoReader(path)


def iter_frames(path: str, max_frames: Optional[int] = None
                ) -> Iterator[np.ndarray]:
    """Stream the decoded RGB frames of `path`, at most `max_frames`, one
    at a time (no whole-clip array); the container closes when the
    iteration ends or the generator is closed."""
    with VideoReader(path) as r:
        for i, f in enumerate(r):
            if max_frames is not None and i >= max_frames:
                return
            yield f


def _frame_count_exact(r: VideoReader, t: int, exact_end: bool) -> bool:
    """Probe a metadata-derived frame count before window starts are
    derived from it: frame t-1 must exist and, when ``exact_end`` (t is
    the unclamped container count), frame t must not.  A backend whose
    seek cannot be verified fails the probe, and the caller decodes the
    whole clip."""
    import cv2
    cap = r._cap
    if not cap.set(cv2.CAP_PROP_POS_FRAMES, t - 1):
        return False
    if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != t - 1:
        return False
    if not cap.grab():          # frame t-1 missing: count over-reported
        return False
    if exact_end and cap.grab():  # frame t exists: count under-reported
        return False
    return True


def decode_snippet_windows(path: str, window: int, num_windows: int = 1,
                           max_frames: Optional[int] = None,
                           repeat_short: bool = True) -> np.ndarray:
    """Decode a clip's snippet windows → (N, window, H, W, 3) uint8 RGB.

    The serve protocol consumes `num_windows` evenly spaced (centre, for
    N = 1) windows of `window` frames.  When those cover well under the
    clip's length, only they are decoded (``read_window`` seeks);
    otherwise, or when the frame-count metadata fails its probe or proves
    unreliable mid-read, the whole clip is decoded and windowed in
    memory: bit-identical either way.

    Short clips (fewer frames than `window`) clamp-repeat the last frame;
    with `repeat_short` the single distinct window is tiled to
    (num_windows, ...), else it is returned once (shape (1, ...)).
    """
    with VideoReader(path) as r:
        meta_t = r.frame_count
        t = meta_t
        if max_frames is not None and 0 < max_frames < t:
            t = max_frames
        if (t >= window and num_windows * window <= int(0.6 * t)
                and _frame_count_exact(r, t, exact_end=(t == meta_t))):
            if num_windows <= 1:
                starts = [(t - window) // 2]
            else:
                starts = np.linspace(0, t - window,
                                     num_windows).astype(int)
            try:
                return np.stack([r.read_window(int(s), window)
                                 for s in starts])
            except (IOError, ValueError):
                pass      # metadata lied: fall through to full decode
    # Reopen: the seek attempt above may have moved the demuxer.
    with VideoReader(path) as r:
        frames = r.read_all(max_frames=max_frames)
    t = len(frames)
    if num_windows <= 1 or t <= window:
        idx = np.clip(np.arange((t - window) // 2,
                                (t - window) // 2 + window)
                      if t >= window else np.arange(window),
                      0, t - 1)
        wins = frames[idx][None]
        if num_windows > 1 and repeat_short:
            wins = np.repeat(wins, num_windows, axis=0)
        return wins
    starts = np.linspace(0, t - window, num_windows).astype(int)
    return np.stack([frames[s:s + window] for s in starts])


def write_frames(frames: Sequence[np.ndarray], out_dir: str,
                 quality: int = 95) -> List[str]:
    """Write RGB frames as JPEGs in the frames-directory convention."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(out_dir, FRAME_PATTERN.format(i + 1))
        cv2.imwrite(p, cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        paths.append(p)
    return paths


def list_frames_dir(frames_dir: str) -> List[str]:
    entries = []
    for name in os.listdir(frames_dir):
        m = _FRAME_RE.search(name)
        if m:
            entries.append((int(m.group(1)), os.path.join(frames_dir, name)))
    entries.sort()
    return [p for _, p in entries]


def read_frames_dir(frames_dir: str,
                    max_frames: Optional[int] = None) -> np.ndarray:
    """Load a frames directory → (T, H, W, 3) uint8 RGB."""
    import cv2
    paths = list_frames_dir(frames_dir)
    if max_frames is not None:
        paths = paths[:max_frames]
    if not paths:
        raise IOError(f"no frames found in {frames_dir}")
    frames = []
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"unreadable frame {p}")
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(frames)


def synthesize_video(path: str, frames: Sequence[np.ndarray],
                     fps: float = 25.0) -> str:
    """Encode RGB frames to an mp4 (test fixtures and demos)."""
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise IOError(f"could not open VideoWriter for {path}")
    for f in frames:
        vw.write(cv2.cvtColor(np.asarray(f, np.uint8), cv2.COLOR_RGB2BGR))
    vw.release()
    return path
