"""The spans of the DMBD sweep (``pyvbmp_tpu_torch/utils/trace.py``) and the
benchmark's charge of a trace to them (``cardbench/charge.py``).

On the CPU: a small DMBD fit under ``torch.profiler`` opens each phase's
span once a sweep, nested as documented; with no profiler active a sweep
records nothing; the charge rule on synthetic traces; the spans leave the
harness's existing readings as they were; each new reader, and a traced
run of the harness finding the spans in its profile."""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cardbench import charge, run, work
from cardbench.tests.conftest import tiny_root  # noqa: F401  (a fixture)
from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.utils import trace

STEP = ["dmbd.role_estep", "dmbd.role_mstep", "dmbd.obs_update", "dmbd.latent_estep",
        "dmbd.elbo", "dmbd.latent_mstep"]
NEW_METRICS = ("estep_launches_per_sweep", "mstep_launches_per_sweep",
               "host_syncs_per_sweep", "allocator_calls_per_sweep")
REPO = Path(__file__).resolve().parent.parent
OLD_METRICS = ("launches_per_sweep", "torch_ops_ms_per_sweep", "logsemiring_scan_roofline",
               "kalman_plane_scan_roofline", "device_idle_pct", "peak_mem_gib", "sweep_mfu_pct")


def small_fit():
    """A Lorenz-width DMBD on the CPU with the scan smoothers, and its data."""
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    y = np.cumsum(rs.randn(16, 3, 3, 2) * 0.3, 0)
    model = DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2), parallel_scan=True,
                                          dtype=torch.float64, device="cpu")
    return model, torch.as_tensor((y - y.mean()) / y.std())


def traced_spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = list(prof.events())
    return events, charge.from_events(events)["spans"]


def children(spans, parent):
    return [i for i, s in enumerate(spans) if s[3] == parent]


def names(spans, idx):
    return [spans[i][0] for i in idx]


@pytest.mark.parametrize("latent_iters,fold", [(1, "0"), (2, "0"), (1, "1")])
def test_update_opens_each_phase_once_a_sweep_nested(monkeypatch, latent_iters, fold):
    monkeypatch.setattr(scan, "TIME_FOLD", fold)
    model, y = small_fit()
    _, spans = traced_spans(lambda: model.update(y, iters=2, latent_iters=latent_iters, lr=0.5))
    top = children(spans, None)
    assert names(spans, top) == ["dmbd.update"]
    sweeps = children(spans, top[0])
    assert names(spans, sweeps) == ["dmbd.sweep", "dmbd.sweep", "dmbd.elbo_fetch"]
    suffix = "_folded" if fold == "1" else ""
    for sweep in sweeps[:2]:
        phases = children(spans, sweep)
        assert names(spans, phases) == ["dmbd.warmup"] * (latent_iters > 1) + STEP
        by = dict(zip(names(spans, phases), phases))
        fb = children(spans, by["dmbd.role_estep"])
        assert names(spans, fb) == ["hmm.forward_backward"]
        assert names(spans, children(spans, fb[0])) == ["scan.logsemiring_scan" + suffix] * 2
        ks = children(spans, by["dmbd.latent_estep"])
        assert names(spans, ks) == ["kalman.smoother"]
        assert names(spans, children(spans, ks[0])) == ["scan.kalman_plane_scan" + suffix] * 2
        for name in STEP[1:3] + STEP[4:]:
            assert children(spans, by[name]) == []
        if latent_iters > 1:
            warm = names(spans, children(spans, by["dmbd.warmup"]))
            assert warm == ["hmm.forward_backward", "kalman.smoother"] * (latent_iters - 1)
    # none is a user annotation, which Kineto would mirror on the device's timeline
    events, _ = traced_spans(lambda: model.update(y, iters=1, lr=0.5))
    assert not any(getattr(e, "is_user_annotation", False) for e in events)


def test_a_sweep_records_nothing_without_a_profiler(monkeypatch):
    def refuse(what):
        def enter(*args, **kwargs):
            raise AssertionError(f"{what} entered")
        return enter

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse("a span's range"))
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse("record_function"))
    model, y = small_fit()
    model.update(y, iters=2, latent_iters=2, lr=0.5)
    assert trace.span("dmbd.sweep", {"sweep": 0}) is trace.span("scan.x")
    # the patch sits on the path a profiled sweep takes
    with pytest.raises(AssertionError, match="a span's range entered"):
        with profile(activities=[ProfilerActivity.CPU]):
            model.update(y, iters=1, lr=0.5)


def host(name, a, b, id=0):
    return SimpleNamespace(name=name, id=id, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a),
                           is_user_annotation=False)


def device(name, a, b, id, user=False):
    return SimpleNamespace(name=name, id=id, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a),
                           is_user_annotation=user)


# two sweeps' worth of a synthetic trace (times in us); ids are CUDA
# correlation ids, which the runtime calls and the device events share
SPANS = [host("dmbd.update", 0, 1000, 1), host("dmbd.sweep", 10, 900, 2),
         host("dmbd.role_estep", 20, 300, 3), host("hmm.forward_backward", 30, 250, 4),
         host("scan.logsemiring_scan", 40, 100, 5), host("dmbd.role_mstep", 300, 400, 6),
         host("dmbd.latent_estep", 400, 700, 7), host("dmbd.elbo", 700, 800, 8),
         host("dmbd.elbo_fetch", 900, 990, 9)]
OPS = [host("aten::mul", 21, 29, 10), host("aten::bmm", 310, 330, 11)]
CALLS = [host("cudaLaunchKernel", 25, 27, 101),         # role_estep
         host("cudaLaunchKernel", 50, 52, 102),         # scan
         host("cudaLaunchKernel", 320, 322, 103),       # role_mstep
         host("cudaMalloc", 330, 335, 104),             # role_mstep
         host("cudaLaunchKernel", 410, 412, 105),       # latent_estep
         host("cudaStreamSynchronize", 720, 790, 106),  # elbo
         host("cudaMemcpyAsync", 910, 915, 107),        # elbo_fetch
         host("cudaStreamSynchronize", 916, 980, 108),  # elbo_fetch
         host("cudaLaunchKernel", 1100, 1102, 109),     # outside dmbd.update
         host("cudaFree", 1110, 1120, 110)]             # outside dmbd.update
DEVICE = [device("void gemm_kernel", 30, 40, 101),
          device("void logsemiring_scan_kernel<4>", 60, 200, 102),
          device("void elementwise_kernel", 330, 340, 103),
          device("void kalman_plane_scan_kernel<8>", 420, 600, 105),
          device("Memcpy DtoH (Device -> Pageable)", 920, 925, 107),
          device("void reduce_kernel", 1105, 1110, 109),
          device("void orphan_kernel", 1200, 1210, 999)]


def test_charge_rule_innermost_span_gaps_and_calls_outside_update():
    c = charge.from_events(SPANS + OPS + CALLS + DEVICE)
    spans = c["spans"]
    assert [s[0] for s in spans] == [e.name for e in SPANS]  # by start; no op is a span
    assert [spans[s[3]][0] if s[3] is not None else None for s in spans] == [
        None, "dmbd.update", "dmbd.sweep", "dmbd.role_estep", "hmm.forward_backward",
        "dmbd.sweep", "dmbd.sweep", "dmbd.sweep", "dmbd.update"]
    charged = {d[0]: (charge.name_of(c, d[3]), d[4], d[5]) for d in c["device_charge"]}
    assert charged == {
        "void gemm_kernel": ("dmbd.role_estep", True, True),
        "void logsemiring_scan_kernel<4>": ("scan.logsemiring_scan", True, True),
        "void elementwise_kernel": ("dmbd.role_mstep", True, True),
        "void kalman_plane_scan_kernel<8>": ("dmbd.latent_estep", True, True),
        "Memcpy DtoH (Device -> Pageable)": ("dmbd.elbo_fetch", False, True),
        "void reduce_kernel": (charge.NO_SPAN, True, True),
        "void orphan_kernel": (charge.NO_SPAN, True, False)}
    assert {(n, charge.name_of(c, s)) for n, _, _, s in c["runtime_calls"]} >= {
        ("cudaMalloc", "dmbd.role_mstep"), ("cudaStreamSynchronize", "dmbd.elbo"),
        ("cudaStreamSynchronize", "dmbd.elbo_fetch"), ("cudaFree", charge.NO_SPAN)}
    # each gap goes to the span of the device event that ends it
    gaps = [(round(1e6 * s), charge.name_of(c, span)) for s, span in charge.idle(c)]
    assert gaps == [(20, "scan.logsemiring_scan"), (130, "dmbd.role_mstep"),
                    (80, "dmbd.latent_estep"), (320, "dmbd.elbo_fetch"),
                    (180, charge.NO_SPAN), (90, charge.NO_SPAN)]
    ctx = dict(c, sweeps=1)
    assert charge.phase(ctx, spans.index(next(s for s in spans if s[0].startswith("scan.")))) \
        == "dmbd.role_estep"
    # the calls outside dmbd.update are not counted
    assert charge.calls_in_update(ctx, charge.SYNCS) == 2
    assert charge.calls_in_update(ctx, charge.ALLOCATOR) == 1
    assert charge.launches_in(ctx, charge.ESTEP) == 3
    assert charge.launches_in(ctx, charge.MSTEP) == 1
    rows = charge.table(ctx)
    assert sum(r["launches"] for r in rows.values()) == 6
    assert rows["dmbd.elbo_fetch"]["syncs"] == 1 and rows["dmbd.role_mstep"]["allocator"] == 1
    assert rows["dmbd.role_estep"]["self_ms"] == pytest.approx(1e-3 * (280 - 220))
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(0.82)


def reading(events, sweeps=2):
    """trace_context's keys and the seven existing readers' values."""
    prof = SimpleNamespace(events=lambda: list(events))
    ctx = run.trace_context(prof, sweeps, 0.01)
    ctx.update(work=work, cell={"flops_per_sweep": 1e6},
               scans={"logsemiring_scan": (10, 4, 30), "kalman_plane_scan": (10, 6, 10)},
               sweep_s=0.002, window_peak_bytes=2 ** 20)
    return ctx, {m: run.importlib.import_module(f"cardbench.metrics.{m}").read(ctx)
                 for m in OLD_METRICS}


@pytest.mark.parametrize("extra", ["spans", "spans and charge keys"])
def test_spans_leave_the_existing_readings_as_they_were(extra):
    before, values = reading(OPS + CALLS + DEVICE)
    after, values_after = reading(SPANS + OPS + CALLS + DEVICE)
    for key in ("kernels", "device_spans", "busy_s", "sweeps", "traced_s"):
        assert after[key] == before[key], key
    assert after["breakdown"]["device_ops"] == before["breakdown"]["device_ops"]
    assert values_after == values and values["launches_per_sweep"] == 3.0
    if extra == "spans and charge keys":
        after.update(charge.from_events(SPANS + OPS + CALLS + DEVICE))
        assert all(charge.of(after) is after for _ in range(2))
        assert {m: run.importlib.import_module(f"cardbench.metrics.{m}").read(after)
                for m in OLD_METRICS} == values
    # a user annotation on the device's timeline is no work to the charge
    noted = charge.from_events(SPANS + OPS + CALLS + DEVICE
                               + [device("dmbd.sweep", 30, 900, 2, user=True)])
    assert noted == charge.from_events(SPANS + OPS + CALLS + DEVICE)


@pytest.mark.parametrize("metric,value", [
    ("estep_launches_per_sweep", 1.5), ("mstep_launches_per_sweep", 0.5),
    ("host_syncs_per_sweep", 1.0), ("allocator_calls_per_sweep", 0.5)])
def test_new_readers_on_a_synthetic_trace(metric, value):
    read = run.importlib.import_module(f"cardbench.metrics.{metric}").read
    ctx = dict(charge.from_events(SPANS + OPS + CALLS + DEVICE), sweeps=2, breakdown={})
    assert read(ctx) == value
    # no spans (a program without them): nothing to read
    assert read(dict(charge.from_events(OPS + CALLS + DEVICE), sweeps=2)) is None
    # no device events (a run on the CPU): nothing to read
    assert read(dict(charge.from_events(SPANS + OPS), sweeps=2)) is None


def test_readers_find_the_profile_of_the_frame_that_calls_them():
    events = SPANS + OPS + CALLS + DEVICE

    def harness():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.events = lambda: events
        ctx = dict(sweeps=2, breakdown={"idle_gaps": []})
        return ctx, [run.importlib.import_module(f"cardbench.metrics.{m}").read(ctx)
                     for m in NEW_METRICS]

    ctx, values = harness()
    assert values == [1.5, 0.5, 1.0, 0.5]
    assert ctx["breakdown"]["idle_by_span"][0] == ["dmbd.elbo_fetch", pytest.approx(320e-6)]
    assert dict(ctx["breakdown"]["device_by_span"])["scan.logsemiring_scan"] == \
        pytest.approx(140e-6)
    # no profile anywhere above: nothing to read
    assert charge.of(dict(sweeps=2)) is None


def test_a_traced_harness_run_finds_the_spans(tiny_root):
    # in a process of its own: the harness refuses to run beside JAX, which
    # this test process has loaded
    code = f"""
import json, pathlib, sys
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(1)
from cardbench import charge, run
seen, from_events = [], charge.from_events
def spy(events):
    out = from_events(events)
    seen.append([s[0] for s in out["spans"]])
    return out
charge.from_events = spy
result, lines = run.run_cell("tiny", 2**31 + 977, 0.1, 1, device="cpu",
                             root=pathlib.Path({str(tiny_root)!r}))
print(json.dumps(dict(correct=result["correct"], metrics=sorted(result["metrics"]),
                      seen=seen, lines=lines)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"], got["lines"]
    # the profile was found and holds the sweeps' spans; on the CPU there is
    # no device event, so no new metric is read
    assert len(got["seen"]) == 1 and got["seen"][0].count("dmbd.update") == 2
    assert got["seen"][0].count("dmbd.sweep") == 2
    assert "scan.kalman_plane_scan" in got["seen"][0]
    assert not set(NEW_METRICS) & set(got["metrics"])


@pytest.mark.gpu
def test_on_the_card_every_kernel_links_to_a_launch_inside_a_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernels have no CPU mode")
    _, y = small_fit()
    model = DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2), parallel_scan=True,
                                          device="cuda")
    y = y.to("cuda", torch.float32)
    model.update(y, iters=1, lr=0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.update(y, iters=2, lr=0.5)
    events = list(prof.events())
    assert not any(e.is_user_annotation for e in events)
    ctx = dict(charge.from_events(events), sweeps=2)
    dev = ctx["device_charge"]
    assert dev and all(linked and span is not None for _, _, _, span, _, linked in dev)
    for name, _, _, span, _, _ in dev:
        if work.group_of(name) is not None:
            assert charge.name_of(ctx, span).startswith("scan."), name
    # the same kernels the harness counts, each charged once
    assert sum(kernel for *_, kernel, _ in dev) == len(run.trace_context(prof, 2, 0.0)["kernels"])
    assert charge.calls_in_update(ctx, charge.SYNCS) >= 1  # the ELBO fetch
