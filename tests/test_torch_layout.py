"""The port's layout: no module of ``pyvbmp_tpu_torch`` reaches the repo's
tooling (``chip_smoke.py``, the benchmark, the JAX package's bench scripts)
or edits ``sys.path``, and ``ops/_cuda.py:_bind`` refuses a library that
lacks an entry point of ``SIGNATURES``."""
import ast
import ctypes
import inspect
from pathlib import Path
from types import SimpleNamespace

import pytest

from pyvbmp_tpu_torch.ops import _cuda

PACKAGE_DIR = Path(_cuda.__file__).resolve().parents[1]
TOOLING = {"chip_smoke", "cardbench", "bench", "benchmarks"}


def _reaches_out(tree):
    """(line, what) for each import of the tooling and each use of
    ``sys.path`` in a module's syntax tree."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
            if node.module == "sys" and any(a.name == "path" for a in node.names):
                found.append((node.lineno, "from sys import path"))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ast.unparse(node.func) in ("importlib.import_module", "import_module",
                                             "__import__")):
            names = [node.args[0].value]
        elif (isinstance(node, ast.Attribute) and node.attr == "path"
              and isinstance(node.value, ast.Name) and node.value.id == "sys"):
            found.append((node.lineno, "sys.path"))
            continue
        else:
            continue
        found += [(node.lineno, f"import {n}") for n in names
                  if n.split(".")[0] in TOOLING]
    return found


def test_no_module_of_the_package_reaches_the_tooling():
    modules = sorted(PACKAGE_DIR.rglob("*.py"))
    assert len(modules) > 50, PACKAGE_DIR
    offenders = [f"{path.relative_to(PACKAGE_DIR)}:{line}: {what}"
                 for path in modules
                 for line, what in _reaches_out(ast.parse(path.read_text(), str(path)))]
    assert not offenders, offenders


@pytest.mark.parametrize("missing", [None, *_cuda.SIGNATURES])
def test_bind_declares_every_entry_point_or_raises(missing):
    assert list(inspect.signature(_cuda._bind).parameters) == ["lib"]
    assert list(inspect.signature(_cuda.build).parameters) == ["csrc_dir", "build_dir"]
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in _cuda.SIGNATURES
                             if name != missing})
    if missing is not None:
        with pytest.raises(AttributeError, match=missing):
            _cuda._bind(lib)
        return
    _cuda._bind(lib)
    for name, argtypes in _cuda.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int, name
