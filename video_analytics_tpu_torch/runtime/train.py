"""Training: fine-tune a stream network.

Port of ``video_analytics_tpu/runtime/train.py``.  The reference keeps
parameters, BatchNorm statistics and the optax state in a ``TrainState``
pytree and jits a pure step; here the module owns its weights and
statistics and ``torch.optim.SGD`` its momentum buffers, and the step
updates them in place.  ``SGD(lr, momentum=0.9)`` is ``optax.sgd(lr,
momentum=0.9)``: ``buf = 0.9·buf + g; p -= lr·buf`` from a zero buffer, no
dampening, no Nesterov, every parameter trained (BatchNorm scales and
shifts too).

Data parallelism, the reference's batch sharded over a mesh's data axis,
is one process per device (``parallel/mesh``): each process holds its own
rows of the global batch and a copy of the weights, broadcast from process
0 when the state is made.  The BatchNorms take the global batch's
statistics, the gradients are averaged over the group after each backward
pass, and the reported loss and accuracy are the global batch's, so every
process takes the reference's step on the global batch.  Without a group
the step is the one-device step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from video_analytics_tpu_torch.models.resnet import ResNet
from video_analytics_tpu_torch.parallel.mesh import (
    average_gradients, broadcast_from_first, global_mean)

MOMENTUM = 0.9      # cmd_train's optax.sgd(lr, momentum=0.9)


@dataclasses.dataclass
class TrainState:
    model: ResNet
    optimizer: torch.optim.SGD


def create_train_state(model: ResNet, lr: float) -> TrainState:
    """The model in training mode and its SGD optimizer; in a group of
    processes, with process 0's weights and statistics."""
    if model.fold_bn:
        raise ValueError("fold_bn models are inference-only (BatchNorm "
                         "statistics are folded away)")
    broadcast_from_first(model.state_dict().values())
    return TrainState(model.train(),
                      torch.optim.SGD(model.parameters(), lr=lr,
                                      momentum=MOMENTUM))


def make_train_step(model: ResNet, optimizer: torch.optim.Optimizer
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """Returns ``step(x, y) → {"loss", "accuracy"}``: one SGD step on a
    batch, x (B, H, W, C) preprocessed, y (B,) integer labels.  The metrics
    are 0-d tensors on the model's device, read by nobody here: the host
    does not wait for the step.  In a group of processes x and y are this
    process's rows (the same number on every process) and the metrics are
    the global batch's."""

    def step(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        logits = model(x)
        y = y.long()
        loss = F.cross_entropy(logits, y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(model.parameters())
        optimizer.step()
        acc = (logits.detach().argmax(-1) == y).float().mean()
        loss, acc = global_mean(torch.stack([loss.detach(), acc]))
        return {"loss": loss, "accuracy": acc}

    return step
