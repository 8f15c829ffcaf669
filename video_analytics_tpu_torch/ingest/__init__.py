from video_analytics_tpu_torch.ingest.windows import (  # noqa: F401
    apply_transport_crop,
    host_normalize_square,
    host_resize_short,
    slice_crop_source,
    sliding_windows,
    window_starts,
)
from video_analytics_tpu_torch.ingest.prefetch import (  # noqa: F401
    DevicePrefetcher,
    decode_worker,
    prefetch_clips,
)
