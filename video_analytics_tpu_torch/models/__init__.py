from video_analytics_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    BasicBlock,
    resnet18,
    resnet34,
    flow_stream_resnet18,
    init_resnet,
)
from video_analytics_tpu_torch.models.convert import (  # noqa: F401
    torch_resnet_to_flax,
    inflate_stem_for_flow,
)
from video_analytics_tpu_torch.models.two_stream import (  # noqa: F401
    TwoStreamModel,
    top1,
)
