"""Flow-field persistence: Middlebury .flo files and the two-stream uint8
quantisation convention (clip to ±bound, rescale to [0, 255]).

The port's own copy of what it uses from
``video_analytics_tpu/io/flowio.py`` (numpy, and cv2 for the colour
wheel, imported where it is used).
"""

from __future__ import annotations

import os
import re
import struct
from typing import Optional, Tuple

import numpy as np

_FLO_MAGIC = 202021.25  # Middlebury sanity-check constant


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float32 flow field as a Middlebury .flo file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.tobytes())


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise IOError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def quantize_flow(flow: np.ndarray, bound: float = 20.0) -> np.ndarray:
    """(…, 2) float flow → uint8 via the standard two-stream convention:
    clip to [-bound, bound] then linearly map to [0, 255]."""
    f = np.clip(np.asarray(flow, np.float32), -bound, bound)
    return np.round((f + bound) * (255.0 / (2.0 * bound))).astype(np.uint8)


def dequantize_flow(q: np.ndarray, bound: float = 20.0) -> np.ndarray:
    return q.astype(np.float32) * (2.0 * bound / 255.0) - bound


def read_flow_dir(flow_dir: str, bound: float = 20.0,
                  max_flows: Optional[int] = None) -> np.ndarray:
    """Load a stored flow directory → (T, H, W, 2) float32.

    Accepts either Middlebury .flo files (flow_%06d.flo) or the
    two-stream quantized-uint8 convention (flow_x/flow_y JPEG pairs):
    what ``compute-flow`` writes."""
    names = os.listdir(flow_dir)
    flos = sorted(n for n in names if re.match(r"flow_\d{6}\.flo$", n))
    if flos:
        if max_flows is not None:
            flos = flos[:max_flows]
        return np.stack([read_flo(os.path.join(flow_dir, n)) for n in flos])
    xs = sorted(n for n in names if n.startswith("flow_x_"))
    if not xs:
        raise IOError(f"no .flo or flow_x_*/flow_y_* files in {flow_dir}")
    if max_flows is not None:
        xs = xs[:max_flows]
    import cv2
    flows = []
    for nx in xs:
        ny = nx.replace("flow_x_", "flow_y_")
        fx = cv2.imread(os.path.join(flow_dir, nx), cv2.IMREAD_GRAYSCALE)
        fy = cv2.imread(os.path.join(flow_dir, ny), cv2.IMREAD_GRAYSCALE)
        if fx is None or fy is None:
            raise IOError(f"unreadable flow pair {nx}/{ny}")
        flows.append(dequantize_flow(np.stack([fx, fy], -1), bound))
    return np.stack(flows)


def flow_pair_paths(out_dir: str, index: int) -> Tuple[str, str]:
    """Storage convention for quantized flow: flow_x/flow_y JPEG pairs."""
    return (os.path.join(out_dir, f"flow_x_{index:06d}.jpg"),
            os.path.join(out_dir, f"flow_y_{index:06d}.jpg"))


def flow_to_color(flow: np.ndarray, max_mag: float = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 RGB via the standard HSV wheel
    (hue = direction, value = magnitude), for inspection."""
    import cv2
    fx, fy = flow[..., 0], flow[..., 1]
    mag, ang = cv2.cartToPolar(fx.astype(np.float32), fy.astype(np.float32))
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    hsv = np.zeros((*flow.shape[:2], 3), np.uint8)
    hsv[..., 0] = (ang * 180 / np.pi / 2).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = np.clip(mag / max_mag * 255, 0, 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
