"""The comparison that decides ``correct``: the program's sweeps against the
plain reference's from the same state.

Five numbers, each against its limit in the cell's file (a cell's file may
leave out ``late_elbo_gap``, which is then not compared there):

- ``elbo_gap``: the largest relative gap between the program's ELBO and
  the reference's over the checked sweeps, run in set-up from the drawn
  starting state;
- ``sweep1_leaf_gap`` and ``sweep3_leaf_gap``: after the first and after
  the last checked sweep, the worst leaf's gap between the norm of the
  program's change from the starting state and the norm of the
  reference's, over the larger of the reference's norm for that leaf and
  for the median leaf;
- ``late_elbo_gap`` and ``late_leaf_gap``: one sweep after the window, which
  the reference runs from a copy of the program's whole state before it
  (the sweeps of the window leave a state no reference follows, so the
  reference takes it up there): the ELBO gap in nats per observable, and
  the worst leaf's norm of the difference between the program's and the
  reference's values over the norm of the reference's.  By then the fit
  has all but converged and a sweep changes a leaf by less than float32
  resolves, so the change, and the ELBO that large terms cancel into, would
  measure rounding over a vanishing size; the values and the ELBO per
  observable do not.

In the checked sweeps the role marginals and the latent means, which a
sweep makes anew, are compared as they are rather than by their change.
"""
from __future__ import annotations

import math
import statistics

import torch

NAMES = ("elbo_gap", "sweep1_leaf_gap", "sweep3_leaf_gap", "late_elbo_gap", "late_leaf_gap")
# compared in every cell; a cell's file may add the others
REQUIRED = ("elbo_gap", "sweep1_leaf_gap", "sweep3_leaf_gap", "late_leaf_gap")


def _norm(x):
    v = float(torch.linalg.vector_norm(x))
    return v if math.isfinite(v) else math.inf


def _change(leaves, start):
    return {k: _norm(v - start[k] if k in start else v) for k, v in leaves.items()}


def elbo_gap(program, reference):
    """The largest relative ELBO gap over [(ELBO, leaves)] of both sides."""
    return max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for (p, _), (r, _) in zip(program, reference))


def leaf_gap(program, reference, start):
    """(gap, worst leaf) between the program's and the reference's leaves
    after a sweep, by their change from ``start``."""
    r, p = _change(reference, start), _change(program, start)
    med = statistics.median(r.values())
    gaps = {k: abs(p[k] - r[k]) / max(r[k], med) if math.isfinite(p[k]) else math.inf
            for k in r}
    worst = max(gaps, key=gaps.get)
    return (gaps[worst] if math.isfinite(gaps[worst]) else math.inf), worst


def compare(program, reference, start):
    """The checked sweeps' three numbers (and the worst leaf of each leaf
    gap) from [(ELBO, leaves)] of the program and of the reference over the
    same sweeps, and the starting leaves."""
    out = {"elbo_gap": elbo_gap(program, reference)}
    for name, i in (("sweep1_leaf_gap", 0), ("sweep3_leaf_gap", len(reference) - 1)):
        out[name], out[name + ".leaf"] = leaf_gap(program[i][1], reference[i][1], start)
    return out


def compare_late(program, reference, observables):
    """The late sweep's two numbers from [(ELBO, leaves)] of one sweep of
    each side from the same state, on data of ``observables`` observables;
    a reference of None (the program's state does not fit the data) fails
    both."""
    if reference is None:
        return {"late_elbo_gap": math.inf, "late_leaf_gap": math.inf}
    (e_p, p), (e_r, r) = program[0], reference[0]
    gaps = {k: _norm(p[k] - r[k]) / max(_norm(r[k]), 1e-30) if p[k].shape == r[k].shape
            else math.inf for k in r}
    worst = max(gaps, key=gaps.get)
    return {"late_elbo_gap": abs(e_p - e_r) / observables if math.isfinite(e_p) else math.inf,
            "late_leaf_gap": gaps[worst], "late_leaf_gap.leaf": worst}


def compared(limits):
    """The numbers a cell compares: those of ``REQUIRED`` and those its
    limits name, in the order of ``NAMES``."""
    return [k for k in NAMES if k in REQUIRED or k in limits]


def verdict(numbers, limits, failed):
    """Whether every number the cell compares is within its limit and no
    sweep of the window failed; a number or limit that is missing fails."""
    ok = failed == 0
    for k in compared(limits):
        v, lim = numbers.get(k), limits.get(k)
        ok = ok and v is not None and lim is not None and v <= lim
    return bool(ok)
