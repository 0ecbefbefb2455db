"""Faults planted under the timed path of the NLDS family, for the checks
that ``correct`` comes out false when the program is wrong: each wraps the
family's function that builds the model, with the contract of
``cardbench/faults.py`` (whose faults patch DMBD's step).  Used by
``tests/test_torch_nlds_cell.py`` and, for the readings a cell's limits
are set from at its own size on the card, by this module's command line:

    python3 cardbench/nlds_faults.py --workload nlds.T1000.b1000 --seeds 3 \
        --seconds 2 --out faults.nlds.T1000.b1000.json

which runs the cell (``run.run_cell``) once a fault and a seed and prints
each run's readings (``cardbench/check.py`` names them).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# ``cardbench/faults.py``'s but ``late_altered``: a 1e-3 change of q(s) after the
# window lies inside the late sweep's float32 gap of this cell (the worst
# leaf 8.7e-4 on sound runs), so no limit tells it from a sound run
FAULTS = ("unchanged", "half_batch", "altered_elbo", "qs_unchanged")
NODES = ("x0", "A", "B", "pi0")


@contextlib.contextmanager
def planted(fault, drv):
    """A function that builds the model with ``fault`` planted, for
    ``run.run_cell(..., build=)``:

    - ``unchanged``: every sweep leaves the model's parameters as it found
      them (its q(s), latent posterior and ELBO as computed);
    - ``qs_unchanged``: every sweep returns q(s) as it found it (its
      parameters, latent posterior and ELBO as computed);
    - ``half_batch``: the model sees the first half of the trajectories (and
      of q(s)) and every sum over the batch is doubled, the mean over the
      rest;
    - ``altered_elbo``: each sweep's ELBO comes back one part in a thousand
      higher than computed.
    """
    from pyvbmp_tpu_torch.utils import torchutils

    saved = torchutils.BATCH_REDUCE

    def build(cfg, inputs, device):
        model = drv.build(cfg, inputs, device)
        step, update = model._vb_step, model.update
        if fault == "half_batch":
            def half(y, *a, **kw):
                b = y.shape[1] // 2
                if model.p is not None and model.p.shape[1] != b:
                    model.p = model.p[:, :b]
                return update(y[:, :b], *a, **kw)

            model.update = half
        elif fault == "unchanged":
            def same(*a, **kw):
                nodes = [getattr(model, k) for k in NODES]
                beta = model.T.beta
                out = step(*a, **kw)
                for k, v in zip(NODES, nodes):
                    setattr(model, k, v)
                model.T.beta = beta
                return out

            model._vb_step = same
        elif fault == "qs_unchanged":
            def same_qs(p, *a, **kw):
                return (p,) + tuple(step(p, *a, **kw)[1:])

            model._vb_step = same_qs
        elif fault == "altered_elbo":
            def altered(*a, **kw):
                out = step(*a, **kw)
                return tuple(out[:-1]) + (out[-1] + 1e-3 * out[-1].abs(),)

            model._vb_step = altered
        return model

    if fault == "half_batch":
        torchutils.BATCH_REDUCE = lambda xs: tuple(2 * x for x in xs)
    elif fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield build
    finally:
        torchutils.BATCH_REDUCE = saved


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from cardbench.run import driver, load_cell, run_cell

    if not torch.cuda.is_available():
        raise SystemExit("nlds_faults.py needs a CUDA card")
    torch.set_num_threads(1)
    drv = driver(load_cell(args.workload)[1])
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        for fault in FAULTS:
            with planted(fault, drv) as build:
                result, _ = run_cell(args.workload, seed, args.seconds, 0, build=build)
            row = dict(kind=f"fault_{fault}", seed=seed, correct=result["correct"],
                       **result["readings"])
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"rows": rows}, indent=1))


if __name__ == "__main__":
    main()
