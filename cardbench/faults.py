"""Faults planted under the timed path, for the checks that ``correct``
comes out false when the program is wrong: each wraps the family's
function that builds the model.  Used by ``calibrate.py`` (readings at a
cell's own size on the card) and by ``tests/test_cardbench_run.py``."""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered_elbo", "late_altered")
CHECKED_SWEEPS = 3  # every traffic mix's ``checked_sweeps``: ``late_altered`` starts after them


@contextlib.contextmanager
def planted(fault, drv):
    """A function that builds the model with ``fault`` planted, for
    ``run.run_cell(..., build=)``:

    - ``unchanged``: every sweep returns the model's parameters as it found
      them (its E-step outputs and ELBO as computed);
    - ``half_batch``: the model sees the first half of the trajectories and
      every sum over the batch is doubled, the mean over the rest;
    - ``altered_elbo``: each sweep's ELBO comes back one part in a thousand
      higher than computed;
    - ``late_altered``: once the checked sweeps have run right, as a route
      taken after warm-up would, each sweep's role marginals come back one
      part in a thousand higher than computed.
    """
    from pyvbmp_tpu_torch.utils import torchutils

    saved = torchutils.BATCH_REDUCE

    def build(cfg, inputs, device):
        model = drv.build(cfg, inputs, device)
        step, update = model._dmbd_step, model.update
        if fault == "half_batch":
            def half(y, *a, **kw):
                return update(y[:, : y.shape[1] // 2], *a, **kw)

            model.update = half
        elif fault == "unchanged":
            def same(x0, A, transition, initial, B, *rest, **kw):
                out = step(x0, A, transition, initial, B, *rest, **kw)
                return (x0, A, transition, initial, B) + tuple(out[5:])

            model._dmbd_step = same
        elif fault == "late_altered":
            calls = [0]

            def late(*a, **kw):
                out = step(*a, **kw)
                calls[0] += 1
                if calls[0] <= CHECKED_SWEEPS:
                    return out
                return tuple(out[:6]) + (out[6] * (1 + 1e-3),) + tuple(out[7:])

            model._dmbd_step = late
        elif fault == "altered_elbo":
            def altered(*a, **kw):
                out = step(*a, **kw)
                return tuple(out[:-1]) + (out[-1] + 1e-3 * out[-1].abs(),)

            model._dmbd_step = altered
        return model

    if fault == "half_batch":
        torchutils.BATCH_REDUCE = lambda xs: tuple(2 * x for x in xs)
    elif fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield build
    finally:
        torchutils.BATCH_REDUCE = saved
