"""Seeded weights of both R(2+1)D streams, made on the device: the draws
of ``weights.py`` (one generator seeded from ``--seed``, LeCun-normal
convolution and head weights in one call, BatchNorm and head-bias
entries uniform in a second) over the reference's parameter list
(``reference/r2plus1d.parameter_shapes``), in float32.  The same state
dicts go to the program and to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.r2plus1d import parameter_shapes
from bench_h100.weights import derived_seed


def make_stream(gen: torch.Generator, device, in_channels: int,
                num_classes: int, width: int) -> Dict[str, torch.Tensor]:
    shapes = parameter_shapes(in_channels, num_classes, width)
    dense = [k for k, s in shapes.items() if len(s) > 1]
    flat = [k for k, s in shapes.items() if len(s) == 1]
    normal = torch.randn(sum(math.prod(shapes[k]) for k in dense),
                         generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in flat),
                         generator=gen, device=device)
    state, at = {}, 0
    for k in dense:
        n = math.prod(shapes[k])
        fan_in = math.prod(shapes[k][1:])
        state[k] = normal[at:at + n].view(shapes[k]) * fan_in ** -0.5
        at += n
    at = 0
    for k in flat:
        n = math.prod(shapes[k])
        u = uniform[at:at + n]
        at += n
        if k.endswith((".weight", ".running_var")):
            state[k] = 0.75 + 0.5 * u
        else:                               # bias, running_mean, fc.bias
            state[k] = 0.2 * (u - 0.5)
    return state


def make_weights(seed: int, device, model_cfg: dict
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"spatial": state dict, "temporal": state dict}: the RGB stream
    and the flow stream (2 channels, one field a frame), from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights"))
    classes, width = model_cfg["num_classes"], model_cfg["width"]
    return {"spatial": make_stream(gen, device, 3, classes, width),
            "temporal": make_stream(gen, device, 2, classes, width)}
