"""Readings that the limits of a cell's comparison are set from, at the
cell's own size on the card (``cardbench/check.py`` names the numbers):

- sound: the program's checked sweeps against the float64 reference, one
  reading a seed (the lower readings: the largest over the seeds);
- control: the reference computed in the nearest precision below the
  configuration's float32, float32 with TF32 matrix products, in the
  program's place;
- faults (``faults.py``) planted in the program: a sweep that leaves the
  parameters unchanged, half of the batch left out with the mean taken over
  the rest.

The checked sweeps' numbers need no window; the late sweep's come from
whole runs of the cell (``run.run_cell``, a window of ``--seconds``), the
program's and the control's, on ``--late`` seeds:

    python3 cardbench/calibrate.py --workload <cell> --seeds 12 --control 3 --faults 3 \
        --late 3 --seconds 30 --out calibrate.<cell>.json

The runs of the benchmark do not run this; it prints one line a reading
and writes them all to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cardbench import check, faults  # noqa: E402
from cardbench.run import driver, load_cell, run_cell  # noqa: E402


def program_sweeps(drv, cfg, traffic, inputs, device, build):
    model = build(cfg, inputs, device)
    out = [(drv.sweep(model, inputs, traffic), drv.snapshot(model))
           for _ in range(traffic["checked_sweeps"])]
    del model
    torch.cuda.empty_cache()
    return out


def tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--late", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py needs a CUDA card")
    _, cfg, traffic, _, _, _ = load_cell(args.workload)
    drv = driver(cfg)
    n = traffic["checked_sweeps"]
    rows = []

    def record(kind, seed, numbers, seconds):
        row = dict(kind=kind, seed=seed, seconds=seconds, **numbers)
        rows.append(row)
        print(json.dumps(row), flush=True)

    tf32(False)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        inputs = drv.make_inputs(cfg, traffic, seed, "cuda")
        start = drv.start(cfg, inputs)
        t0 = time.perf_counter()
        prog = program_sweeps(drv, cfg, traffic, inputs, "cuda", drv.build)
        t1 = time.perf_counter()
        ref64 = drv.reference(cfg, inputs, traffic, n)
        torch.cuda.synchronize()
        record("sound", seed, check.compare(prog, ref64, start), [t1 - t0, time.perf_counter() - t1])
        if i < args.control:
            tf32(True)
            t0 = time.perf_counter()
            low = drv.reference(cfg, inputs, traffic, n, dtype=torch.float32)
            tf32(False)
            record("control_tf32", seed, check.compare(low, ref64, start),
                   [time.perf_counter() - t0])
        if i < args.faults:
            for fault in ("unchanged", "half_batch"):
                with faults.planted(fault, drv) as build:
                    bad = program_sweeps(drv, cfg, traffic, inputs, "cuda", build)
                record(f"fault_{fault}", seed, check.compare(bad, ref64, start), [])
        del inputs, ref64
        torch.cuda.empty_cache()
    for i in range(args.late):
        seed = args.first_seed + 104729 * (i + 1)
        t0 = time.perf_counter()
        result, _ = run_cell(args.workload, seed, args.seconds, 0, control=True)
        record("sound_run", seed, result["readings"],
               [time.perf_counter() - t0])
        record("control_tf32_run", seed, result["control_checks"], [])
        torch.cuda.empty_cache()

    summary = {}
    for name in check.NAMES:
        by = {}
        for r in rows:
            if name in r:
                by.setdefault(r["kind"].removesuffix("_run"), []).append(r[name])
        summary[name] = {"sound_max": max(by.get("sound", [float("nan")])),
                         **{f"{k}_min": min(v) for k, v in by.items() if k != "sound"}}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
