"""Helpers shared by the examples."""
from __future__ import annotations

import importlib.util
import os
import tempfile

import numpy as np
import torch


def smoke_mode(smoke):
    """``smoke`` when given, else the environment's PYVBMP_EXAMPLE_SMOKE."""
    if smoke is None:
        return bool(int(os.environ.get("PYVBMP_EXAMPLE_SMOKE", "0")))
    return bool(smoke)


def out_path(name, smoke):
    """Where an example writes the file ``name``: the temporary directory in
    smoke mode, else the working directory."""
    return os.path.join(tempfile.gettempdir() if smoke else ".", name)


def can_plot():
    """True where matplotlib is installed; else says that the plots are
    skipped."""
    if importlib.util.find_spec("matplotlib") is None:
        print("plots skipped: matplotlib is not installed")
        return False
    return True


def numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
