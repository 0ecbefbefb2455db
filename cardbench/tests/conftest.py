"""Shared fixtures of the benchmark's tests: a checkout root holding one
small cell, for runs of the harness on the CPU."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def tiny_root(tmp_path):
    """A root with BENCHMARK.json and one cell, ``tiny``: the Lorenz
    configuration at T=40, batch 4, held to lorenz.b100's limits."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name="tiny", config="dmbd-lorenz", traffic="tiny", chips=1,
                              why="a small Lorenz cell for the CPU tests")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = tmp_path / "cardbench"
    for d in ("configs", "traffic", "workloads"):
        (bench / d).mkdir(parents=True)
    shutil.copy(ROOT / "cardbench" / "configs" / "dmbd-lorenz.json", bench / "configs")
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        dict(T=40, batch=4, lr=0.5, checked_sweeps=3, traced_sweeps=2)))
    own = json.loads((ROOT / "cardbench" / "workloads" / "lorenz.b100.json").read_text())
    (bench / "workloads" / "tiny.json").write_text(json.dumps(own))
    return tmp_path
