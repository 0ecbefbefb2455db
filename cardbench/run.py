"""Run one cell of the benchmark of the PyTorch and CUDA port once, on one
NVIDIA card, and print its result as one JSON line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration (``cardbench/configs/<name>.json``, whose ``family`` names a
module in ``cardbench/drivers/``) and a traffic mix
(``cardbench/traffic/<name>.json``); the cell's own file
(``cardbench/workloads/<cell>.json``) holds its limits and its operation
count.  Per-layer metrics are read by ``cardbench/metrics/<name>.py``.

Set-up: the data and the starting state from ``--seed`` on the card, the
model, and the checked sweeps (through the timed entry point; they also
warm up every shape and build the kernels).  The window then times sweeps
of one continuing fit on the host clock, each from its call to its return,
for ``--seconds``.  With ``--trace 1`` the window is followed by a fixed
count of sweeps under ``torch.profiler``, and the per-layer metrics are
printed in place of the end-to-end ones.  Then one more sweep is run
through the same call, from a copy of the program's whole state taken
before it.  Once the program's state is freed, the plain reference reruns
the checked sweeps from the drawn state, and that last sweep from the
copy, in float64, and ``correct`` is decided (``cardbench/check.py``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cardbench import check, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pyvbmp_tpu")


def load_cell(name, root=ROOT):
    """(cell entry, configuration, traffic, cell file, end-to-end metrics,
    per-layer metrics) of the cell ``name``, read from BENCHMARK.json and
    the files it names."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "cardbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    own = json.loads((root / "cardbench" / "workloads" / f"{name}.json").read_text())
    return cell, cfg, traffic, own, spec["end_to_end"], spec["per_layer"]


def driver(cfg):
    return importlib.import_module(f"cardbench.drivers.{cfg['family']}")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def trace_context(prof, sweeps, traced_s):
    """Device kernels, device spans, busy seconds and the longest idle gaps
    by the host operation that ran across them, from a profile of
    ``sweeps`` sweeps."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    spans = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in dev]
    kernels = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in dev
               if not e.name.startswith(("Memcpy", "Memset"))]
    busy = work.union_seconds(spans)
    ops = {}
    for name, a, b in kernels:
        ops[name] = ops.get(name, 0.0) + (b - a)
    gaps = {}
    if spans:
        starts = [e.time_range.start * 1e-6 for e in host]
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        for a, b in work.idle_gaps(spans, lo, hi):
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            best = None
            for e in host[max(0, i - 400):i]:
                if e.time_range.end * 1e-6 >= mid and (
                        best is None or e.time_range.elapsed_us() < best.time_range.elapsed_us()):
                    best = e
            key = best.name if best is not None else "no host operation"
            gaps[key] = gaps.get(key, 0.0) + (b - a)
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(kernels=kernels, device_spans=spans, busy_s=busy, sweeps=sweeps,
                traced_s=traced_s, breakdown={"device_ops": top(ops), "idle_gaps": top(gaps)})


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT, build=None, control=False):
    """One run of the cell; returns (result dict, lines comparing each
    checked number with its limit).  ``build`` replaces the family's function
    that builds the model (faults are planted through it).  With
    ``control`` the result also holds, under ``control_checks``, the numbers
    of the reference computed in float32 with TF32 matrix products in the
    program's place (``calibrate.py``; the benchmark's runs do not)."""
    cell, cfg, traffic, own, e2e, per_layer = load_cell(name, root)
    drv = driver(cfg)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    inputs = drv.make_inputs(cfg, traffic, seed, device)
    model = (build or drv.build)(cfg, inputs, device)
    checked = []
    for _ in range(traffic["checked_sweeps"]):
        elbo = drv.sweep(model, inputs, traffic)
        checked.append((elbo, drv.snapshot(model)))
    sync()
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    times, failed = [], 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        t0 = time.perf_counter()
        elbo = drv.sweep(model, inputs, traffic)
        times.append(time.perf_counter() - t0)
        failed += not math.isfinite(elbo)
    window_s = time.perf_counter() - w0
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0

    ctx = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        n = traffic["traced_sweeps"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                drv.sweep(model, inputs, traffic)
            sync()
            traced_s = time.perf_counter() - t0
        ctx = trace_context(prof, n, traced_s)
        ctx.update(work=work, cell=own, scans=drv.shapes(cfg, traffic),
                   sweep_s=window_s / len(times), window_peak_bytes=window_peak)
    before = drv.state(model)
    late = [(drv.sweep(model, inputs, traffic), drv.snapshot(model))]
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules the benchmark may not load are loaded: {', '.join(found)}")

    def references(dtype):
        early = drv.reference(cfg, inputs, traffic, traffic["checked_sweeps"], dtype)
        try:
            from_state = drv.reference_from(cfg, inputs, traffic, before, dtype)
        except ValueError as err:
            print(f"cardbench: no late reference: {err}", file=sys.stderr)
            from_state = None
        return early, from_state

    def compare(early, from_state, program=(checked, late)):
        return {**check.compare(program[0], early, drv.start(cfg, inputs)),
                **check.compare_late(program[1], from_state, drv.observables(inputs))}

    ref_early, ref_late = references(torch.float64)
    numbers = compare(ref_early, ref_late)
    control_numbers = None
    if control and ref_late is not None:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            low = references(torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        control_numbers = compare(ref_early, ref_late, program=low)
    limits = own.get("limits", {})
    correct = check.verdict(numbers, limits, failed)
    lines = [f"{k} {numbers[k]!r} limit {limits.get(k)!r}" + (
        f" (worst leaf {numbers[k + '.leaf']})" if k + ".leaf" in numbers else "")
        for k in check.compared(limits)] + [f"failed_sweeps {failed} limit 0"]

    if trace:
        metrics = {}
        for m in per_layer:
            value = importlib.import_module(f"cardbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "sweeps_per_s": len(times) / window_s,
            "sweep_ms_p95": 1e3 * statistics.quantiles(times, n=100, method="inclusive")[94]
            if len(times) > 1 else 1e3 * times[0],
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e
                   if m["name"] in values and name in m.get("workloads", [name])}
    result = {
        "correct": correct,
        "attempted": len(times),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": max(setup_peak, window_peak),
        },
    }
    if on_card:
        result["device"]["power_limit_w"] = power_limit_w()
    if trace:
        result["device"].update(busy_s=ctx["busy_s"], window_s=ctx["traced_s"])
        result["breakdown"] = ctx["breakdown"]
    # every number with its worst leaf, compared or not, for calibrate.py and the record
    result["readings"] = {k: numbers[k] for k in check.NAMES}
    result["worst_leaves"] = {k: numbers[k + ".leaf"] for k in check.NAMES if k + ".leaf" in numbers}
    if control_numbers is not None:
        result["control_checks"] = control_numbers
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)}
                        for k in check.compared(limits)}
    result["checks"]["failed_sweeps"] = {"value": failed, "limit": 0}
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: the cell needs {cell['chips']} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    # one process with one thread for host-side tensor work: idle OpenMP
    # workers of a wide pool contend with the thread that dispatches the
    # sweep, and made runs of one cell differ by a fifth
    torch.set_num_threads(1)
    result, lines = run_cell(args.workload, args.seed, args.seconds, args.trace)
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
