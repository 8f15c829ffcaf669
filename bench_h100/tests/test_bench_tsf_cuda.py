"""On the card: each control fails one of the TimeSformer cell's limits
at the cell's own size (16 windows of 9 frames at 240×320, published
widths), on three seeds: the float8 products the log-probability gap,
the bfloat16 flow the flow's mean endpoint error.  Run there with

    python -m pytest bench_h100/tests/test_bench_tsf_cuda.py -m cuda -q

Each test decides inside itself whether a card is present."""

import pytest
import torch

from bench_h100 import harness

CELL = "tsf8_fb_batch16"
SEEDS = (2**31 + 261, 2**31 + 262, 2**31 + 263)
FAILS = {"cnn": "logp_gap", "flow": "flow_epe_px"}


@pytest.mark.cuda
@pytest.mark.parametrize("lower", sorted(FAILS))
def test_control_fails_the_limit_at_the_cells_size(lower):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_h100 import calibrate_tsf

    spec = harness.Spec()
    number = FAILS[lower]
    limit = spec.limits(CELL)[number]
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        got = calibrate_tsf.control_numbers(spec, CELL, seed, dev, lower)
        assert got[number] > limit, (seed, got, limit)
