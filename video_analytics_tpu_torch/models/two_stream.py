"""Two-stream action recognition: RGB stream + flow stream, temporal
mean pooling, late fusion (Simonyan & Zisserman 2014).  With
``arch="r2plus1d_34"`` each stream is a video ResNet
(``models/video_resnet``), with ``arch="timesformer_base"`` a
divided space-time TimeSformer (``models/timesformer``), with
``arch="swin3d_b"`` a Video Swin-B (``models/video_swin``); each takes
one clip volume: the RGB frames, or the clip's flow fields (2 channels a
frame), and the model says so (``clip_input``).

Port of ``video_analytics_tpu/models/two_stream.py``.  The reference keeps
flax modules and variables apart; here ``TwoStreamModel`` is an
``nn.Module`` that owns both streams' weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from video_analytics_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from video_analytics_tpu_torch.models import convert
from video_analytics_tpu_torch.models.resnet import (
    ResNet, resnet18, resnet34, resnet50)
from video_analytics_tpu_torch.models.timesformer import timesformer_base
from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34
from video_analytics_tpu_torch.models.video_swin import video_swin_b
from video_analytics_tpu_torch.parallel.mesh import ColumnParallelLinear

_ARCHS = {"resnet18": resnet18, "resnet34": resnet34,
          "resnet50": resnet50, "r2plus1d_34": r2plus1d_34,
          "timesformer_base": timesformer_base, "swin3d_b": video_swin_b}


@dataclasses.dataclass(frozen=True)
class ArchInput:
    """What an arch's published setup feeds it: the short side, crop and
    window of frames, the normalisation statistics and the late fusion's
    (spatial, temporal) weights, whether each stream takes the window as
    one clip volume (``clip``: no flow stacks), and the streams' base
    width.  The defaults are the image ResNets' (the ``PipelineConfig``
    defaults)."""

    resize_short: int = 256
    crop: int = 224
    window: int = 16
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    fusion_weights: Tuple[float, float] = (1.0, 1.5)
    clip: bool = False
    width: int = 64


# R(2+1)D (arXiv:1711.11248): clips of 32 frames resized to 128×171 and
# centre-cropped to 112² (33 frames make the 32 flow fields), the
# Kinetics statistics of torchvision's video weights, streams averaged.
# TimeSformer (arXiv:2102.05095): 8 frames whose short side is 224, the
# centre 224² (9 frames make the 8 flow fields), its 0.45 / 0.225
# statistics, streams averaged.  Video Swin (arXiv:2106.13230): 32
# frames whose short side is 224, the centre 224² (33 frames make the 32
# flow fields), ImageNet's statistics, streams averaged.
_ARCH_INPUTS = {
    "r2plus1d_34": ArchInput(
        resize_short=128, crop=112, window=33,
        mean=(0.43216, 0.394666, 0.37645),
        std=(0.22803, 0.22145, 0.216989), fusion_weights=(1.0, 1.0),
        clip=True),
    "timesformer_base": ArchInput(
        resize_short=224, crop=224, window=9, mean=(0.45, 0.45, 0.45),
        std=(0.225, 0.225, 0.225), fusion_weights=(1.0, 1.0), clip=True,
        width=768),
    "swin3d_b": ArchInput(
        resize_short=224, crop=224, window=33, fusion_weights=(1.0, 1.0),
        clip=True, width=128)}


def arch_input(arch: str) -> ArchInput:
    """The preprocessing and fusion that `arch` comes with."""
    if arch not in _ARCHS:
        raise ValueError(f"unknown arch {arch!r}; "
                         f"choose from {sorted(_ARCHS)}")
    return _ARCH_INPUTS.get(arch, ArchInput())


def arch_names(images_only: bool = False) -> List[str]:
    """The registered archs in their order; with `images_only`, those whose
    streams take frames and flow stacks, not clip volumes."""
    return [a for a in _ARCHS if not (images_only and arch_input(a).clip)]


class TwoStreamModel(nn.Module):
    """The two stream networks + fusion weights."""

    def __init__(self, spatial: nn.Module, temporal: nn.Module,
                 fusion_weights: Tuple[float, float] = (1.0, 1.5)):
        super().__init__()
        self.spatial = spatial
        self.temporal = temporal
        self.fusion_weights = tuple(fusion_weights)

    @classmethod
    def create(cls, num_classes: int = 101, flow_stack: int = 10,
               fusion_weights: Tuple[float, float] = (1.0, 1.5),
               dtype: torch.dtype = torch.float32,
               width: Optional[int] = None,
               arch: str = "resnet18") -> "TwoStreamModel":
        """Both streams of `arch`; `dtype` is their compute dtype (the
        parameters are float32 either way, ``models/resnet``); `width`
        the arch's base width, None for its own (``arch_input``: 64 for
        the ResNets and R(2+1)D, 768 for TimeSformer, 128 for Video
        Swin).  The flow stream of an image arch
        takes 2·`flow_stack` channels; that of a clip arch one field (u,
        v) a frame, and `flow_stack` is unused."""
        if arch not in _ARCHS:
            raise ValueError(f"unknown arch {arch!r}; "
                             f"choose from {sorted(_ARCHS)}")
        build = _ARCHS[arch]
        kw = {"num_classes": num_classes, "dtype": dtype,
              "width": arch_input(arch).width if width is None else width}
        spatial = build(**kw)
        flow_channels = 2 if spatial.clip_input else 2 * flow_stack
        return cls(spatial, build(in_channels=flow_channels, **kw),
                   fusion_weights=fusion_weights)

    @property
    def clip_input(self) -> bool:
        """Whether each stream takes one clip volume (N, T, H, W, C), as
        R(2+1)D does, instead of frames or flow stacks."""
        return self.spatial.clip_input

    # -- variables in the reference's layout ----------------------------------

    def _resnet_streams(self, what: str) -> None:
        """Raise where the streams are not ResNets: the JAX package has
        no variable tree, and no BatchNorm folding, for another arch."""
        if not isinstance(self.spatial, ResNet):
            raise ValueError(f"{what}: arch {self.spatial.arch!r} has no "
                             f"layout in the JAX package's variable tree "
                             f"and no BatchNorm to fold")

    def flax_variables(self) -> Dict[str, Any]:
        """Both streams' weights as the reference's variable tree
        (``{"spatial": {"params", "batch_stats"}, "temporal": ...}``, numpy
        leaves): what ``runtime/checkpoint.save_variables`` writes.  A
        model whose ``fc`` is split over the model axis
        (``parallel/mesh.shard_dense_over_model``) holds a block of it on
        each rank and is refused."""
        if any(isinstance(m, ColumnParallelLinear) for m in self.modules()):
            raise ValueError("this model's fc is split over the model axis "
                             "(shard_dense_over_model): each process holds "
                             "only its block, so it has no whole variable "
                             "tree to save; save the unsharded model")
        self._resnet_streams("flax_variables")
        return convert.two_stream_torch_to_flax(self.state_dict())

    def load_flax_variables(self, variables: Mapping[str, Any]
                            ) -> "TwoStreamModel":
        """Take both streams' weights from the reference's variable tree,
        e.g. one read by ``runtime/checkpoint.load_variables``."""
        self._resnet_streams("load_flax_variables")
        self.load_state_dict(convert.two_stream_flax_to_torch(variables))
        return self

    def folded(self) -> "TwoStreamModel":
        """Inference-only form with every BatchNorm folded into its
        preceding convolution (``models/convert.fold_batchnorm``): the
        reference's ``folded()`` and ``fold_variables`` in one step, since
        the module owns its weights.  The streams keep their dtype."""
        self._resnet_streams("folded (--fold-bn)")
        out = TwoStreamModel(self.spatial.clone(fold_bn=True),
                             self.temporal.clone(fold_bn=True),
                             self.fusion_weights)
        out.load_flax_variables(self.fold_variables(self.flax_variables()))
        device = next(self.parameters()).device
        return out.to(device).train(self.training)

    @staticmethod
    def fold_variables(variables: Mapping[str, Any]) -> Dict[str, Any]:
        """Fold both streams' variables for a folded() model; other
        entries pass through."""
        return {k: (convert.fold_batchnorm(v)
                    if k in ("spatial", "temporal") else v)
                for k, v in variables.items()}

    def init(self, generator: torch.Generator) -> "TwoStreamModel":
        """Seeded initialisation of both streams (``ResNet.init``,
        ``TimeSformer.init``, ``VideoSwin.init``):
        the spatial stream draws first, then the temporal one."""
        self.spatial.init(generator)
        self.temporal.init(generator)
        return self

    # -- per-stream heads ---------------------------------------------------

    def spatial_logits(self, frames: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3) preprocessed frames → clip logits (C,) via
        temporal mean pooling of per-frame logits."""
        return self.spatial(frames).mean(dim=0)

    def temporal_logits(self, flow_stacks: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 2L) stacked flow windows → clip logits (C,)."""
        return self.temporal(flow_stacks).mean(dim=0)

    # -- fusion -------------------------------------------------------------

    def fuse(self, spatial_logits: torch.Tensor,
             temporal_logits: torch.Tensor) -> torch.Tensor:
        """Late fusion: weighted average of per-stream softmax scores."""
        ws, wt = self.fusion_weights
        probs = (ws * torch.softmax(spatial_logits, dim=-1)
                 + wt * torch.softmax(temporal_logits, dim=-1))
        return probs / (ws + wt)

    def classify(self, frames: torch.Tensor,
                 flow_stacks: torch.Tensor) -> torch.Tensor:
        """Fused class probabilities for one clip."""
        return self.fuse(self.spatial_logits(frames),
                         self.temporal_logits(flow_stacks))


def top1(probs: torch.Tensor) -> torch.Tensor:
    """The index of the largest probability along the last axis."""
    return torch.argmax(probs, dim=-1)
