"""The configuration dataclasses, shared with the JAX package.

``video_analytics_tpu/config.py`` imports only ``dataclasses`` and
``typing``, and that package's ``__init__`` imports only it, so both
packages use one set of classes: a ``TVL1Config`` built for one is valid
for the other.
"""

from video_analytics_tpu.config import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    FarnebackConfig,
    PipelineConfig,
    PreprocessConfig,
    TVL1Config,
)
