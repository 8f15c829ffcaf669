"""On the card: each control fails one of the R(2+1)D cell's limits at
the cell's own size (16 windows of 33 frames at 128×171, published
widths), on three seeds: the float8 CNNs the log-probability gap, the
bfloat16 flow the flow's mean endpoint error.  Run there with

    python -m pytest bench_h100/tests/test_bench_r2p1d_cuda.py -m cuda -q

Each test decides inside itself whether a card is present."""

import pytest
import torch

from bench_h100 import harness

CELL = "r2p1d34_fb_batch16"
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
FAILS = {"cnn": "logp_gap", "flow": "flow_epe_px"}


@pytest.mark.cuda
@pytest.mark.parametrize("lower", sorted(FAILS))
def test_control_fails_the_limit_at_the_cells_size(lower):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_h100 import calibrate_clips

    spec = harness.Spec()
    number = FAILS[lower]
    limit = spec.limits(CELL)[number]
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        got = calibrate_clips.control_numbers(spec, CELL, seed, dev, lower)
        assert got[number] > limit, (seed, got, limit)
