from video_analytics_tpu_torch.runtime.pipeline import (  # noqa: F401
    flow_from_frames,
    rgb_features,
    flow_features,
    classify_window,
    classify_batch,
    sample_window,
)
from video_analytics_tpu_torch.runtime.checkpoint import (  # noqa: F401
    save_variables,
    load_variables,
)
# ``evaluate`` stays the submodule (``runtime.evaluate.evaluate`` is the
# function), not the reference's function shadowing it: the port's code and
# tests import it as a module.
from video_analytics_tpu_torch.runtime.evaluate import (  # noqa: F401
    classify_clip_file,
    EvalResult,
)
