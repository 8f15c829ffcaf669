from video_analytics_tpu_torch.io.video import (  # noqa: F401
    VideoReader,
    open_video,
    iter_frames,
    write_frames,
    read_frames_dir,
)
from video_analytics_tpu_torch.io.flowio import (  # noqa: F401
    read_flo,
    write_flo,
    quantize_flow,
    dequantize_flow,
)
