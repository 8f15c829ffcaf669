"""Frozen, hashable configuration dataclasses of the PyTorch/CUDA port.

The port's own copy of the five dataclasses and the two ImageNet
constants of ``video_analytics_tpu/config.py``: same names, fields,
defaults and ``__post_init__`` checks, so a config of one package
converts to the other's field by field
(``Other(**dataclasses.asdict(cfg))``, nested for ``PipelineConfig``).
Parameter names and defaults mirror OpenCV's
``cv2.calcOpticalFlowFarneback`` / ``cv2.optflow.DualTVL1OpticalFlow``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FarnebackConfig:
    """Parameters of Farnebäck 2003 dense flow, cv2-compatible.

    Defaults follow the canonical two-stream usage of
    ``cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15, 3, 5,
    1.2, 0)``.
    """

    pyr_scale: float = 0.5      # pyramid downscale per level, in (0, 1)
    levels: int = 3             # number of pyramid levels (incl. base)
    winsize: int = 15           # averaging window for the 2x2 solve
    iterations: int = 3         # displacement iterations per level
    poly_n: int = 5             # pixel neighborhood for poly expansion (5 or 7)
    poly_sigma: float = 1.2     # Gaussian sigma of the applicability
    gaussian_window: bool = False  # cv2.OPTFLOW_FARNEBACK_GAUSSIAN
    use_initial_flow: bool = False  # cv2.OPTFLOW_USE_INITIAL_FLOW

    def __post_init__(self):
        if not (0.0 < self.pyr_scale < 1.0):
            raise ValueError(f"pyr_scale must be in (0,1), got {self.pyr_scale}")
        if self.poly_n not in (5, 7):
            raise ValueError(f"poly_n must be 5 or 7, got {self.poly_n}")


@dataclasses.dataclass(frozen=True)
class TVL1Config:
    """Parameters of Zach–Pock–Bischof 2007 TV-L1 dense flow.

    Names and defaults mirror ``cv2.optflow.DualTVL1OpticalFlow_create``
    (tau=0.25, lambda=0.15, theta=0.3, nscales=5, warps=5, epsilon=0.01,
    innerIterations=30, outerIterations=10, scaleStep=0.8,
    medianFiltering=5).
    """

    tau: float = 0.25           # dual ascent time step
    lambda_: float = 0.15       # data-term weight
    theta: float = 0.3          # coupling (tightness) parameter
    nscales: int = 5            # pyramid scales
    warps: int = 5              # warpings per scale
    epsilon: float = 0.01       # convergence threshold (per-warp stop)
    inner_iterations: int = 30  # primal-dual iterations per outer iter
    outer_iterations: int = 10  # outer (v-update) iterations per warp
    scale_step: float = 0.8     # pyramid downscale factor per level
    median_filtering: int = 5   # median kernel on flow between warps (0/3/5)
    use_initial_flow: bool = False

    def __post_init__(self):
        if self.median_filtering not in (0, 1, 3, 5):
            raise ValueError(
                f"median_filtering must be 0/1/3/5, got {self.median_filtering}")
        if not (0.0 < self.scale_step < 1.0):
            raise ValueError(f"scale_step must be in (0,1), got {self.scale_step}")


# ImageNet statistics used by the reference's torchvision transforms.
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Fused preprocessing: resize → crop → normalize → stack.

    Matches the reference's torchvision-style eval transform: resize the
    short side to ``resize_short``, center-crop ``crop`` (or random crop
    + horizontal flip when training), scale to [0,1] and normalize with
    ImageNet statistics.
    """

    resize_short: int = 256
    crop: int = 224
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    random_crop: bool = False   # True during training
    random_flip: bool = False   # True during training
    # Flow-stream stacking: L consecutive (u, v) fields → 2L channels.
    flow_stack: int = 10
    # Flow fields are clipped to [-flow_bound, flow_bound] and rescaled
    # (the standard two-stream uint8 storage convention).
    flow_bound: float = 20.0
    # Transport crop: when set to the ORIGINAL (H, W), pipeline inputs
    # are expected to be pre-sliced on the host to the exact source
    # window the fused resize+center-crop samples
    # (ops.preprocess.crop_source_geometry) — the host sends only the
    # bytes the device would read anyway (bit-identical results).  Only
    # valid for the center-crop (eval) path; incompatible with
    # random_crop.
    src_hw: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if self.src_hw is not None and self.random_crop:
            raise ValueError(
                "src_hw (transport crop) requires the full frame on "
                "device; incompatible with random_crop")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration."""

    preprocess: PreprocessConfig = PreprocessConfig()
    farneback: FarnebackConfig = FarnebackConfig()
    tvl1: TVL1Config = TVL1Config()
    # "tvl1" | "farneback" | "spynet" (learned flow; not ported yet, the
    # pipeline refuses it).
    flow_algo: str = "tvl1"
    batch_size: int = 32
    num_classes: int = 101      # UCF101
    # Late-fusion weights (spatial, temporal); 1:1.5 is the classic choice.
    fusion_weights: Tuple[float, float] = (1.0, 1.5)
    # Sliding-window clip sampling.
    window: int = 16            # frames per window
    window_stride: int = 8
    # Kept for field parity with the reference; the port's CNNs run in
    # float32 and do not read it.
    compute_dtype: str = "bfloat16"
    # Kept for field parity with the reference.  The port's warp is
    # always the exact 2-D gather, so this changes nothing.
    exact_warp: bool = False

    def __post_init__(self):
        if self.flow_algo not in ("tvl1", "farneback", "spynet"):
            raise ValueError(f"unknown flow_algo {self.flow_algo}")
