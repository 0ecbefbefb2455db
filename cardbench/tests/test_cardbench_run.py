"""Runs of the harness on the CPU: it refuses to run without a card and
prints no result; with the look for a card skipped, a sound small run comes
out correct and each planted fault comes out not correct."""
import subprocess
import sys

import pytest

from cardbench import faults, run
from cardbench.tests.conftest import ROOT

SEED = 2**31 + 977


def test_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "lorenz.b100", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_sound_small_run_is_correct(tiny_root):
    result, lines = run.run_cell("tiny", SEED, 0.2, 0, device="cpu", root=tiny_root)
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"sweeps_per_s", "sweep_ms_p95", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(tiny_root, fault):
    drv = run.driver({"family": "dmbd"})
    with faults.planted(fault, drv) as build:
        result, lines = run.run_cell("tiny", SEED, 0.2, 0, device="cpu", root=tiny_root,
                                     build=build)
    assert not result["correct"], lines
