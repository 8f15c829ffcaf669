"""Broken stand-ins for the program, and the control, that a run can be
handed in the program's place: the benchmark's comparison has to find
each of them not correct.

  - ``half_batch``: a batch call computes only the first half of its
    clips and gives the rest the mean of those answers;
  - ``altered``: every answer leaves the program with its classes shifted
    by one (the probability of class c reported for class c + 1);
  - ``control``: the plain reference in the program's place, its CNNs in
    float8 (e4m3, per-tensor scales), one step below the bfloat16 the
    configuration states.  (The flow's control, the reference with its
    flow in bfloat16, is read on the windows a run checks by
    ``calibrate.control_numbers``.)
"""

from __future__ import annotations

import types

import torch

from bench_h100 import program
from bench_h100.reference import pipeline as ref


def _copy() -> types.ModuleType:
    mod = types.ModuleType("bench_h100_program_fault")
    mod.__dict__.update({k: v for k, v in vars(program).items()
                         if not k.startswith("__")})
    return mod


def half_batch() -> types.ModuleType:
    mod = _copy()

    def classify_batch(x, model, pcfg):
        half = max(1, x.shape[0] // 2)
        probs = program.classify_batch(x[:half], model, pcfg)
        rest = probs.mean(0, keepdim=True).expand(x.shape[0] - half, -1)
        return torch.cat([probs, rest])

    mod.classify_batch = classify_batch
    return mod


def altered() -> types.ModuleType:
    mod = _copy()

    def classify_batch(x, model, pcfg):
        return program.classify_batch(x, model, pcfg).roll(1, dims=-1)

    mod.classify_batch = classify_batch
    return mod


def control() -> types.ModuleType:
    mod = _copy()
    mod.build_model = lambda cfg, weights, device: (cfg, weights)
    mod.pipeline_config = lambda cfg: cfg
    mod.with_transport_crop = lambda windows, cfg: (windows, cfg)

    def classify_batch(x, model, cfg):
        cfg, weights = model
        return ref.classify(x, cfg, weights, precision="fp8")

    mod.classify_batch = classify_batch
    return mod


FAULTS = {"half_batch": half_batch, "altered": altered, "control": control}
