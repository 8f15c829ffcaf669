"""Seeded weights of both TimeSformer streams, made on the device: one
generator seeded from ``--seed`` (``weights.derived_seed(seed,
"weights")``) draws, over the reference's parameter list
(``reference/timesformer.parameter_shapes``), every matrix and the patch
embedding's kernel (normal, scaled by fan_in^-1/2: LeCun normal) and
the class, position and time embeddings (normal, sd 0.02) in one call,
and every LayerNorm scale (uniform 0.75 to 1.25) and bias (uniform
±0.1) in a second, in float32.  The same state dicts go to the program
and to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_h100.reference.timesformer import parameter_shapes
from bench_h100.weights import derived_seed

EMBEDDINGS = ("cls_token", "pos_embed", "time_embed")
EMBED_SD = 0.02


def make_stream(gen: torch.Generator, device, in_channels: int,
                model_cfg: dict) -> Dict[str, torch.Tensor]:
    m = model_cfg
    shapes = parameter_shapes(in_channels, m["num_classes"], m["width"],
                              m["depth"], m["mlp"], m["patch"], m["clip"],
                              m["image_size"])
    normal = [k for k, s in shapes.items() if len(s) > 1]
    flat = [k for k, s in shapes.items() if len(s) == 1]
    drawn = torch.randn(sum(math.prod(shapes[k]) for k in normal),
                        generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in flat),
                         generator=gen, device=device)
    state, at = {}, 0
    for k in normal:
        n = math.prod(shapes[k])
        scale = (EMBED_SD if k in EMBEDDINGS
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
