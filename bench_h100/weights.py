"""Seeded weights of both two-stream CNNs, made on the device.

One ``torch.Generator`` on the run's device, seeded with ``--seed``,
draws every convolution and head weight in one call (normal, scaled by
fan_in^-1/2: flax's LeCun-normal default, which the reference's
``init_resnet`` uses) and every BatchNorm and head-bias entry in a
second (uniform, so the normalisation is not the identity: scale 0.75 to
1.25, shift and running mean ±0.1, running variance 0.75 to 1.25), in
float32, the type the parameters are served in.  The same state dicts go
to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from bench_h100.reference.resnet import parameter_shapes


def derived_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed of its own for each use of a run's seed,
    so weights and clips draw independent numbers."""
    tag = int.from_bytes(purpose.encode(), "little")
    return int(np.random.SeedSequence([seed, tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


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
        state[k] = (normal[at:at + n].view(shapes[k])
                    * _fan_in(shapes[k]) ** -0.5)
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
    """{"spatial": state dict, "temporal": state dict} for the
    configuration's two streams, from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights"))
    classes, width = model_cfg["num_classes"], model_cfg["width"]
    spatial = make_stream(gen, device, 3, classes, width)
    temporal = make_stream(gen, device, 2 * model_cfg["flow_stack"],
                           classes, width)
    return {"spatial": spatial, "temporal": temporal}
