"""On the card, at lorenz.b100's own size: the program's checked and late
sweeps come out within the cell's limits and the control (the reference in
float32 with TF32 matrix products, in the program's place) does not; one
short traced run of the cell prints a correct result.  Skips without a
card."""
import json
import subprocess
import sys

import pytest
import torch

from cardbench import check, run
from cardbench.tests.conftest import ROOT

pytestmark = pytest.mark.gpu
CELL = "lorenz.b100"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_and_program_passes(seed):
    """A short run of the cell, its checked sweeps and its late sweep, with
    the control's numbers beside the program's."""
    need_card()
    _, _, _, own, _, _ = run.load_cell(CELL)
    result, lines = run.run_cell(CELL, seed, 2, 0, control=True)
    assert result["correct"], lines
    assert not check.verdict(result["control_checks"], own["limits"], 0), result["control_checks"]


def test_short_traced_run_of_the_cell_is_correct():
    need_card()
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", CELL, "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"launches_per_sweep", "device_idle_pct"} <= set(result["metrics"])
