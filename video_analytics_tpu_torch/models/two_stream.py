"""Two-stream action recognition: RGB stream + flow stream, temporal
mean pooling, late fusion (Simonyan & Zisserman 2014).

Port of ``video_analytics_tpu/models/two_stream.py``.  The reference keeps
flax modules and variables apart; here ``TwoStreamModel`` is an
``nn.Module`` that owns both streams' weights.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from video_analytics_tpu_torch.models.resnet import (
    ResNet, flow_stream_resnet18, resnet18)


class TwoStreamModel(nn.Module):
    """The two stream networks + fusion weights."""

    def __init__(self, spatial: ResNet, temporal: ResNet,
                 fusion_weights: Tuple[float, float] = (1.0, 1.5)):
        super().__init__()
        self.spatial = spatial
        self.temporal = temporal
        self.fusion_weights = tuple(fusion_weights)

    @classmethod
    def create(cls, num_classes: int = 101, flow_stack: int = 10,
               fusion_weights: Tuple[float, float] = (1.0, 1.5),
               width: int = 64, arch: str = "resnet18") -> "TwoStreamModel":
        if arch != "resnet18":
            raise NotImplementedError(
                f"arch {arch!r} is not ported yet (resnet18 only); "
                "see ROADMAP.md")
        return cls(resnet18(num_classes=num_classes, width=width),
                   flow_stream_resnet18(stack=flow_stack,
                                        num_classes=num_classes,
                                        width=width),
                   fusion_weights=fusion_weights)

    def init(self, generator: torch.Generator) -> "TwoStreamModel":
        """Seeded initialisation of both streams (see ``ResNet.init``):
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
