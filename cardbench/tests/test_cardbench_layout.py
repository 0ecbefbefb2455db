"""The benchmark's files hang together: every cell names a configuration,
a family module, a traffic mix and a cell file that exist, every per-layer metric
has its reader, the names and lengths are within the benchmark's contract,
and nothing under cardbench/ imports JAX or the JAX package (top-level
module names compared whole), nor does the reference import the port."""
import ast
import json
import re

import pytest

from cardbench import check, faults
from cardbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "pyvbmp_tpu"}


def imports(path):
    """Top-level names of the modules a Python file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_names_existing_files(cell):
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert cell["config"] in configs
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    assert (ROOT / "cardbench" / "drivers" / f"{cfg['family']}.py").exists()
    assert (ROOT / "cardbench" / "traffic" / f"{cell['traffic']}.json").exists()
    own = json.loads((ROOT / "cardbench" / "workloads" / f"{cell['name']}.json").read_text())
    assert set(check.REQUIRED) <= set(own["limits"]) <= set(check.NAMES)
    traffic = json.loads((ROOT / "cardbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["checked_sweeps"] == faults.CHECKED_SWEEPS
    assert own["flops_per_sweep"] > 0
    assert cell["chips"] == 1 and len(cell["why"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_reports_setup_and_another_end_to_end_metric(cell):
    mine = {m["name"] for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in mine and len(mine) >= 2


def test_every_metric_has_a_reader_and_a_valid_name():
    for m in SPEC["per_layer"]:
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("path", sorted((ROOT / "cardbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = imports(path)
    assert not found & FORBIDDEN
    if "reference" in path.parts:
        assert found <= {"__future__", "math", "numpy", "torch"}


def test_top_level_names_are_compared_whole():
    from cardbench import run

    assert "pyvbmp_tpu_torch" not in run.FORBIDDEN
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in __import__("sys").modules} & FORBIDDEN)
