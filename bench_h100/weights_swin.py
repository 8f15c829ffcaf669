"""Seeded weights of both Video Swin streams, made on the device: one
generator seeded from ``--seed`` (``weights.derived_seed(seed,
"weights")``) draws, over the reference's parameter list
(``reference/video_swin.parameter_shapes``), every matrix and the patch
embedding's kernel (normal, scaled by fan_in^-1/2: LeCun normal) and
every relative position bias table (normal, sd ``TABLE_SD``) in one
call, and every LayerNorm scale (uniform 0.75 to 1.25) and bias (uniform
±0.1) in a second, in float32.  The same state dicts go to the program
and to the reference.

``TABLE_SD`` is 4, not the published initial 0.02: the scaled scores
q·kᵀ/√32 spread with sd about 1 at these weights, so a table of sd 0.02
or even 1 moves the answers less than bfloat16 does (on the CPU, at
width 16 on 33-frame windows, the float32 reference without the bias
reads a log-probability gap of 0.038 at sd 1, 0.13 at 2 and 0.47 at 4,
the bfloat16 program 0.021-0.023), and the comparison could not tell the
bias from its absence.  At sd 4 the bias sets where each token looks, as
a trained table's entries, spread over several units, do."""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.video_swin import parameter_shapes
from bench_h100.weights import derived_seed

TABLE_SD = 4.0


def make_stream(gen: torch.Generator, device, in_channels: int,
                model_cfg: dict) -> Dict[str, torch.Tensor]:
    m = model_cfg
    shapes = parameter_shapes(in_channels, m["num_classes"], m["width"],
                              tuple(m["depths"]), tuple(m["heads"]),
                              tuple(m["window"]), tuple(m["patch"]),
                              m["mlp_ratio"])
    normal = [k for k, s in shapes.items() if len(s) > 1]
    flat = [k for k, s in shapes.items() if len(s) == 1]
    drawn = torch.randn(sum(math.prod(shapes[k]) for k in normal),
                        generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in flat),
                         generator=gen, device=device)
    state, at = {}, 0
    for k in normal:
        n = math.prod(shapes[k])
        scale = (TABLE_SD if k.endswith("relative_position_bias_table")
                 else math.prod(shapes[k][1:]) ** -0.5)
        state[k] = drawn[at:at + n].view(shapes[k]) * scale
        at += n
    at = 0
    for k in flat:
        n = math.prod(shapes[k])
        u = uniform[at:at + n]
        at += n
        if k.endswith(".bias"):
            state[k] = 0.2 * (u - 0.5)
        else:                                   # a LayerNorm's scale
            state[k] = 0.75 + 0.5 * u
    return state


def make_weights(seed: int, device, model_cfg: dict
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"spatial": state dict, "temporal": state dict}: the RGB stream
    and the flow stream (2 channels, one field a frame), from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights"))
    return {"spatial": make_stream(gen, device, 3, model_cfg),
            "temporal": make_stream(gen, device, 2, model_cfg)}
