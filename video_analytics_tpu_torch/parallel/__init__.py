from video_analytics_tpu_torch.parallel.mesh import (  # noqa: F401
    pad_to_multiple,
)
