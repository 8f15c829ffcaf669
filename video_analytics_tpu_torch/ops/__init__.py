from video_analytics_tpu_torch.ops.preprocess import (  # noqa: F401
    resize_bilinear,
    resize_short_side,
    resize_short_center_crop,
    crop_source_geometry,
    center_crop,
    random_crop_flip,
    normalize,
    preprocess_clip,
    rgb_to_gray,
    stack_flow_windows,
    normalize_flow_stack,
    stacked_flow_input,
)
