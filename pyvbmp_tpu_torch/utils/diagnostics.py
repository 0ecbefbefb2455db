"""Numerical-health utilities over a model's state (counterpart of
pyvbmp_tpu/utils/diagnostics.py):

* ``assert_finite(model)`` walks the parameter nodes of
  ``checkpoint.model_state`` and names every floating field holding a NaN or
  an infinity by the node's dotted key and the field (``pi.alpha``,
  ``A.invU.gamma.beta``, ``layers.0.A.mu``).  The JAX package's walk also
  takes the model's bare arrays; here they are left out, because a shell
  starts its ``logZ`` at -inf until it has computed one (a DMBD's role
  model never does), which is not a fault;
* ``elbo_report(model)`` summarizes the ``ELBO_save`` trace of a fit.

The JAX package's ``enable_nan_debugging`` turns on a JAX runtime flag that
re-runs a traced function eagerly at the first NaN; torch has no such
switch outside autograd, which this package does not use, so it is not
ported: call ``assert_finite`` between sweeps instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .checkpoint import model_state


def _leaves(v, path):
    """(path, tensor) for every tensor under ``v``."""
    if isinstance(v, torch.Tensor):
        yield path, v
    elif isinstance(v, list):
        for i, x in enumerate(v):
            yield from _leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(v):
        for f in dataclasses.fields(v):
            yield from _leaves(getattr(v, f.name), f"{path}.{f.name}")


def assert_finite(model, where=""):
    bad = [path for name, v in model_state(model).items() if not isinstance(v, torch.Tensor)
           for path, t in _leaves(v, name)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(
            f"non-finite parameters{' in ' + where if where else ''}: {bad}"
        )
    return True


def elbo_report(model):
    e = np.asarray(model.ELBO_save, np.float64)
    if e.size == 0:
        return {"iters": 0}
    diffs = np.diff(e)
    return {
        "iters": int(e.size),
        "first": float(e[0]),
        "last": float(e[-1]),
        "monotone_after_2": bool((diffs[2:] >= -np.abs(e[-1]) * 1e-6).all())
        if diffs.size > 2
        else True,
        "max_decrease": float(diffs.min()) if diffs.size else 0.0,
    }
