"""On the card: each control fails one of each cell's limits at the
cell's own size, on three seeds, for every cell of BENCHMARK.json: the
float8 CNNs the log-probability gap, the bfloat16 flow the flow's mean
endpoint error.  Run there with

    python -m pytest bench_h100/tests/test_bench_cuda.py -m cuda -q

Each test decides inside itself whether a card is present."""

import pytest
import torch

from bench_h100 import harness

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
FAILS = {"cnn": "logp_gap", "flow": "flow_epe_px"}


@pytest.mark.cuda
@pytest.mark.parametrize("lower", sorted(FAILS))
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.Spec().data["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(cell, lower):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_h100 import calibrate

    spec = harness.Spec()
    number = FAILS[lower]
    limit = spec.limits(cell)[number]
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        got = calibrate.control_numbers(spec, cell, seed, dev, lower)
        assert got[number] > limit, (cell, seed, got, limit)
