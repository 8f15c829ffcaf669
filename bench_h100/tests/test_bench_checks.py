"""The comparison behind ``correct``: a run with the program passes, a
run with the timed path broken underneath does not, and each control
(float8 CNNs, a bfloat16 flow) sits far above the program in one of the
numbers compared (the controls at the cells' own size are
``test_bench_cuda.py``).  On the CPU, with the harness's look for a card
skipped, at small frames, full widths and the cells' limits."""

import json
import os
import time

import pytest
import torch

from bench_h100 import faults, harness, program
from bench_h100 import run as runner
from bench_h100.tests import tiny

CPU = torch.device("cpu")
CELLS = ("tvl1_batch", "farneback_batch")


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("checks"))
    s = tiny.make_spec(tmp)
    real = harness.Spec()
    for c in s.data["configs"]:
        with open(c["file"]) as f:
            cfg = json.load(f)
        cfg["model"].update(width=64, num_classes=101)
        with open(c["file"], "w") as f:
            json.dump(cfg, f)
    for cell in CELLS:
        with open(os.path.join(s.bench, "limits", cell + ".json"), "w") as f:
            json.dump(real.limits(cell), f)
    return s


def _run(spec, cell, prog, seed=2**31 + 21, seconds=1.5):
    return runner.execute(runner.Run(spec, cell, seed, seconds, False, CPU,
                                     prog, time.perf_counter()))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(spec, cell):
    res = _run(spec, cell, program)
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_compared"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(spec, cell, fault):
    res = _run(spec, cell, faults.FAULTS[fault]())
    assert not res["correct"], res["checks"]
    assert res["checks"]["answers_compared"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_far_from_the_program(spec, cell):
    ctl = _run(spec, cell, faults.control(), seconds=3.0)
    prog = _run(spec, cell, program)
    gap_c = ctl["checks"]["logp_gap"]["value"]
    gap_p = prog["checks"]["logp_gap"]["value"]
    assert ctl["checks"]["answers_compared"]["value"] >= 1
    assert gap_c > 4 * gap_p, (gap_c, gap_p)


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_flow_control_is_far_from_the_program(spec, cell):
    """The flow control barely moves the probabilities; the flow's
    endpoint error in the temporal stream's input is what separates it."""
    from bench_h100 import calibrate

    seed = 2**31 + 21
    ctl = calibrate.control_numbers(spec, cell, seed, CPU, "flow")
    prog = _run(spec, cell, program, seed=seed)["checks"]
    assert prog["flow_epe_px"]["value"] is not None
    assert ctl["flow_epe_px"] > 10 * prog["flow_epe_px"]["value"], (
        ctl, prog)


def test_no_answer_compared_is_not_correct():
    correct, checks = runner.judge({"answers": []}, {"logp_gap": 1.0})
    assert not correct and checks["answers_compared"]["value"] == 0
    correct, _ = runner.judge({"answers": [([0.5, 0.0], [0.5, 0.5])]},
                              {"logp_gap": 1.0})
    assert not correct
