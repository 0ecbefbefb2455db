"""The benchmark's NLDS cell (``nlds.T1000.b1000``): the plain reference
(``cardbench/reference/nlds.py``) against the port, the port's q(s) smoother
(the logsemiring scan pair) against the sequential loop that the JAX
package runs, the family's check of that route, the NASCAR simulator,
the cell's faults (``cardbench/nlds_faults.py``), the NLDS sweep's spans
(``pyvbmp_tpu_torch/models/nlds.py``) and the readers of the cell's
per-layer metrics (``cardbench/nlds_charge.py``).

On the CPU, at the cell's widths (K=4, h=2, obs 10) cut to T=30 and 6
trials (T=20 and 8 in the harness's runs).  Tolerances:

- the port against the reference in float64, 1e-9 of the ELBO and 1e-8 of
  each leaf's largest entry: both compute the same sweep exactly, the port
  by the lane Kalman scan and the logsemiring scan, the reference by
  sequential loops, so they part by float64 rounding alone (~1e-14 seen);
- the scan pair against the loop, 1e-10: the same smoother by another
  association order;
- the port in float32 against the reference in float64, the cell's own
  limits (``cardbench/workloads/nlds.T1000.b1000.json``), which are set at
  the cell's size on the card from the program's float32 readings.

The harness refuses to run where JAX is loaded, which this test process has
loaded (``tests/conftest.py``), so its runs go to a subprocess.  On the card
(marked ``gpu``): the route at the cell's shapes makes the host wait
nowhere and takes two logsemiring and two lane launches a sweep and no plain
scan, the control fails the cell's limits while the program passes, and a
short traced run of the cell prints ``correct`` and every metric it lists.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cardbench import check, mixlds_charge, nlds_charge, run, work
from cardbench.drivers import nlds as drv
from cardbench.nlds_faults import FAULTS
from cardbench.reference import nlds as ref
from pyvbmp_tpu_torch.models import nlds as nlds_module
from pyvbmp_tpu_torch.models.dhmm import driven_forward_backward
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.ops.parallel_hmm import driven_forward_backward_parallel
from pyvbmp_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parent.parent
CELL = "nlds.T1000.b1000"
CFG = json.loads((REPO / "cardbench" / "configs" / "nlds-nascar.json").read_text())
LIMITS = json.loads((REPO / "cardbench" / "workloads" / f"{CELL}.json").read_text())["limits"]
SMALL = dict(T=30, batch=6, lr=1.0)
SEED = 2**31 + 977


def fit(dtype, traffic=SMALL, seed=2**31 + 17):
    inputs = drv.make_inputs(CFG, traffic, seed, "cpu")
    inputs["y"] = inputs["y"].to(dtype)
    return CFG, inputs, drv.build(CFG, inputs, "cpu", dtype)


def close(port, reference):
    for (e_p, leaves_p), (e_r, leaves_r) in zip(port, reference):
        assert abs(e_p - e_r) <= 1e-9 * abs(e_r)
        for k in drv.LEAVES:
            scale = max(leaves_r[k].abs().max().item(), 1e-30)
            assert (leaves_p[k] - leaves_r[k]).abs().max().item() <= 1e-8 * scale, k


@pytest.mark.parametrize("lr", [1.0, 0.5])
def test_reference_follows_the_port_in_float64(lr):
    traffic = dict(SMALL, lr=lr)
    cfg, inputs, model = fit(torch.float64, traffic)
    port = [(drv.sweep(model, inputs, traffic), drv.snapshot(model)) for _ in range(3)]
    close(port, drv.reference(cfg, inputs, traffic, 3))


def test_reference_from_the_ports_state_follows_its_next_sweep():
    """The reference takes up the port's parameters and q(s) after three
    sweeps (``drivers.nlds.state``) and its one sweep agrees with the
    port's fourth, as the late check after the window needs."""
    cfg, inputs, model = fit(torch.float64, seed=2**31 + 29)
    for _ in range(3):
        drv.sweep(model, inputs, SMALL)
    before = drv.state(model)
    port = [(drv.sweep(model, inputs, SMALL), drv.snapshot(model))]
    reference = drv.reference_from(cfg, inputs, SMALL, before)
    close(port, reference)
    late = check.compare_late(port, reference, drv.observables(inputs))
    assert late["late_elbo_gap"] <= 1e-9 and late["late_leaf_gap"] <= 1e-8
    with pytest.raises(ValueError, match="the state's q\\(s\\)"):
        drv.reference_from(cfg, inputs, SMALL, dict(before, p=before["p"][:, :3]))


def test_scan_route_follows_the_loop(monkeypatch):
    """The scan pair against the sequential smoother on per-time
    transition logits of the NLDS's form (a pi0 row first, then a
    stick-breaking row a step) and sharp observation logits, 1e-10 of p,
    SEzz, SEz0 and logZ; and three sweeps of the model from one state, as
    it is and with the sequential smoother in the scan pair's place (the
    JAX package's q(s)), 1e-10 of the ELBO, q(s) and logZ."""
    g = torch.Generator().manual_seed(3)
    T, b, K = 40, 5, 4
    trans = torch.log_softmax(3 * torch.randn(T, b, K, K, generator=g, dtype=torch.float64), -1)
    obs = 20 * torch.randn(T, b, K, generator=g, dtype=torch.float64)
    init = torch.full((K,), -torch.log(torch.tensor(4.0)).item(), dtype=torch.float64)
    for a, c in zip(driven_forward_backward_parallel(trans, init, obs),
                    driven_forward_backward(trans, init, obs)):
        assert (a - c).abs().max().item() <= 1e-10 * max(c.abs().max().item(), 1.0)
    _, inputs, scan_m = fit(torch.float64)
    scan_m.update(inputs["y"], iters=3, lr=1.0)
    _, inputs, loop_m = fit(torch.float64)
    monkeypatch.setattr(nlds_module, "driven_forward_backward_parallel", driven_forward_backward)
    loop_m.update(inputs["y"], iters=3, lr=1.0)
    elbo_s, elbo_l = torch.tensor(scan_m.ELBO_save), torch.tensor(loop_m.ELBO_save)
    assert ((elbo_s - elbo_l).abs() <= 1e-10 * elbo_l.abs()).all()
    assert (scan_m.p - loop_m.p).abs().max().item() <= 1e-10
    assert ((scan_m.logZ - loop_m.logZ).abs() <= 1e-10 * loop_m.logZ.abs()).all()


def test_port_in_float32_is_within_the_cells_limits():
    cfg, inputs, model = fit(torch.float32)
    port = [(drv.sweep(model, inputs, SMALL), drv.snapshot(model)) for _ in range(3)]
    before = drv.state(model)
    late = [(drv.sweep(model, inputs, SMALL), drv.snapshot(model))]
    numbers = {**check.compare(port, drv.reference(cfg, inputs, SMALL, 3), drv.start(cfg, inputs)),
               **check.compare_late(late, drv.reference_from(cfg, inputs, SMALL, before),
                                    drv.observables(inputs))}
    assert check.verdict(numbers, LIMITS, 0), {k: numbers[k] for k in check.NAMES}


def test_the_family_refuses_a_program_off_the_scan_route(monkeypatch):
    """``drivers.nlds.build`` runs where the program's q(s) takes the scan
    pair, and exits at once, before the model, where it takes the
    sequential loop (as a program without the route does)."""
    assert drv.takes_the_scan(CFG, "cpu", torch.float64)
    monkeypatch.setattr(nlds_module, "driven_forward_backward_parallel", driven_forward_backward)
    assert not drv.takes_the_scan(CFG, "cpu", torch.float32)
    inputs = drv.make_inputs(CFG, SMALL, 5, "cpu")
    with pytest.raises(SystemExit, match="does not take q\\(s\\) through the logsemiring scan"):
        drv.build(CFG, inputs, "cpu")


def test_simulator_draws_nascar_trials_from_the_seed():
    a = drv.make_inputs(CFG, SMALL, 5, "cpu")
    b = drv.make_inputs(CFG, SMALL, 5, "cpu")
    c = drv.make_inputs(CFG, SMALL, 6, "cpu")
    assert a["y"].shape == (30, 6, 10) and a["y"].dtype == torch.float32
    assert torch.equal(a["y"], b["y"]) and not torch.equal(a["y"], c["y"])
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert a["state"]["p"].shape == (30, 6, 4)
    assert torch.allclose(a["state"]["p"].sum(-1), torch.ones(30, 6))
    assert drv.shapes(CFG, SMALL) == {"logsemiring_scan": (30, 4, 6), "kalman_lane_scan": (30, 2, 6)}
    # round the track: every state in use, the straights and turns in turn
    g = torch.Generator().manual_seed(11)
    y, s = ref.simulate(16, 1000, 10, g, "cpu", **CFG["data"]["parameters"])
    counts = torch.bincount(s.flatten(), minlength=4)
    assert y.shape == (1000, 16, 10) and (counts > 0.1 * s.numel()).all()
    laps = (s[1:] != s[:-1]).sum(0)
    assert (laps >= 20).all() and (laps <= 60).all()
    with pytest.raises(ValueError, match="unknown simulator"):
        drv.make_inputs(dict(CFG, data=dict(CFG["data"], simulator="rotations")), SMALL, 5, "cpu")


# -- runs of the harness on a tiny NLDS root, in a subprocess ------------------
@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """A sound traced run of a tiny NLDS cell held to the cell's limits and
    one untraced run with each fault planted, all in one process that has
    not loaded JAX."""
    root = tmp_path_factory.mktemp("nlds_root")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name="tiny", config="nlds-nascar", traffic="tiny", chips=1,
                              why="a small NLDS cell for the CPU tests")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = root / "cardbench"
    for d in ("configs", "traffic", "workloads"):
        (bench / d).mkdir(parents=True)
    shutil.copy(REPO / "cardbench" / "configs" / "nlds-nascar.json", bench / "configs")
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        dict(T=20, batch=8, lr=1.0, checked_sweeps=3, traced_sweeps=2)))
    shutil.copy(REPO / "cardbench" / "workloads" / f"{CELL}.json", bench / "workloads" / "tiny.json")
    code = f"""
import json, pathlib, sys
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(1)
from cardbench import run
from cardbench.nlds_faults import FAULTS, planted
root = pathlib.Path({str(root)!r})
result, lines = run.run_cell("tiny", {SEED}, 0.1, 1, device="cpu", root=root)
out = dict(sound=dict(correct=result["correct"], metrics=sorted(result["metrics"]), lines=lines))
drv = run.driver({{"family": "nlds"}})
for fault in FAULTS:
    with planted(fault, drv) as build:
        result, lines = run.run_cell("tiny", {SEED}, 0.1, 0, device="cpu", root=root, build=build)
    out[fault] = dict(correct=result["correct"], lines=lines)
print(json.dumps(out))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sound_tiny_run_is_correct(harness_runs):
    sound = harness_runs["sound"]
    assert sound["correct"], sound["lines"]
    # on the CPU there is no device event: no span metric is read
    assert not set(NLDS_METRICS) & set(sound["metrics"])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(harness_runs, fault):
    assert not harness_runs[fault]["correct"], harness_runs[fault]["lines"]


# -- the spans of the NLDS sweep ----------------------------------------------------
STEP = ["nlds.x_estep", "nlds.mstep", "nlds.s_estep", "nlds.gate", "nlds.elbo"]


def traced_spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = list(prof.events())
    return events, nlds_charge.from_events(events)["spans"]


def children(spans, parent):
    return [i for i, s in enumerate(spans) if s[3] == parent]


def names(spans, idx):
    return [spans[i][0] for i in idx]


def test_update_opens_each_phase_once_a_sweep_nested():
    _, inputs, model = fit(torch.float64, dict(SMALL, T=10))
    events, spans = traced_spans(lambda: model.update(inputs["y"], iters=2, lr=1.0))
    top = children(spans, None)
    assert names(spans, top) == ["nlds.update"]
    sweeps = children(spans, top[0])
    assert names(spans, sweeps) == ["nlds.sweep", "nlds.sweep", "nlds.elbo_fetch"]
    for sweep in sweeps[:2]:
        phases = children(spans, sweep)
        assert names(spans, phases) == STEP
        ks = children(spans, phases[0])
        assert names(spans, ks) == ["kalman.smoother"]
        assert names(spans, children(spans, ks[0])) == ["scan.kalman_lane_scan"] * 2
        hs = children(spans, phases[2])
        assert names(spans, hs) == ["hmm.forward_backward"]
        assert names(spans, children(spans, hs[0])) == ["scan.logsemiring_scan"] * 2
        assert all(children(spans, p) == [] for p in (phases[1], phases[3], phases[4]))
    assert children(spans, sweeps[2]) == []
    assert not any(getattr(e, "is_user_annotation", False) for e in events)


def test_a_sweep_records_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span's range entered")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    _, inputs, model = fit(torch.float64, dict(SMALL, T=10))
    model.update(inputs["y"], iters=2, lr=1.0)
    with pytest.raises(AssertionError, match="a span's range entered"):
        with profile(activities=[ProfilerActivity.CPU]):
            model.update(inputs["y"], iters=1, lr=1.0)


# -- the readers on synthetic traces ---------------------------------------------
def host(name, a, b, id=0):
    return SimpleNamespace(name=name, id=id, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a),
                           is_user_annotation=False)


def device(name, a, b, id):
    return SimpleNamespace(name=name, id=id, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a),
                           is_user_annotation=False)


# two NLDS sweeps (times in us; ids are CUDA correlation ids)
N_SPANS = [host("nlds.update", 0, 1000), host("nlds.sweep", 10, 450),
           host("nlds.x_estep", 20, 150), host("kalman.smoother", 30, 140),
           host("scan.kalman_lane_scan", 40, 80), host("nlds.mstep", 150, 200),
           host("nlds.s_estep", 200, 350), host("hmm.forward_backward", 210, 340),
           host("scan.logsemiring_scan", 220, 260), host("scan.logsemiring_scan", 270, 310),
           host("nlds.gate", 350, 420), host("nlds.elbo", 420, 440),
           host("nlds.sweep", 450, 850), host("nlds.x_estep", 460, 550),
           host("nlds.s_estep", 600, 700), host("nlds.gate", 700, 800),
           host("nlds.elbo_fetch", 900, 990)]
N_CALLS = [host("cudaLaunchKernel", 25, 27, 401), host("cudaLaunchKernel", 50, 52, 402),
           host("cudaLaunchKernel", 160, 162, 403), host("cudaStreamSynchronize", 170, 180, 404),
           host("cudaLaunchKernel", 205, 207, 405), host("cudaLaunchKernel", 230, 232, 406),
           host("cudaLaunchKernel", 280, 282, 407), host("cudaLaunchKernel", 360, 362, 408),
           host("cudaLaunchKernel", 470, 472, 409), host("cudaLaunchKernel", 610, 612, 410),
           host("cudaLaunchKernel", 710, 712, 411), host("cudaMalloc", 715, 718, 416),
           host("cudaMemcpyAsync", 910, 912, 412),
           host("cudaStreamSynchronize", 930, 980, 413),
           host("cudaLaunchKernel", 1100, 1102, 414), host("cudaStreamSynchronize", 1120, 1130, 415),
           host("cudaFree", 1140, 1150, 417)]
N_DEVICE = [device("void elementwise_kernel", 30, 40, 401),
            device("void kalman_lane_scan_kernel<2, false>", 60, 100, 402),
            device("void gemm_kernel", 165, 175, 403), device("void reduce_kernel", 210, 215, 405),
            device("void logsemiring_scan_kernel<4, float>", 240, 250, 406),
            device("void logsemiring_scan_kernel<4, float>", 290, 300, 407),
            device("void elementwise_kernel", 370, 400, 408),
            device("void elementwise_kernel", 480, 490, 409),
            device("void reduce_kernel", 620, 630, 410), device("void elementwise_kernel", 720, 740, 411),
            device("Memcpy DtoH (Device -> Pageable)", 920, 925, 412),
            device("void reduce_kernel", 1105, 1110, 414)]
# one DMBD sweep, then one MixLDS sweep, after them
D_SPANS = [host("dmbd.update", 2000, 2500), host("dmbd.sweep", 2010, 2400),
           host("dmbd.role_estep", 2020, 2100), host("dmbd.latent_mstep", 2200, 2300),
           host("dmbd.elbo_fetch", 2400, 2490)]
D_CALLS = [host("cudaLaunchKernel", 2030, 2032, 301), host("cudaMalloc", 2210, 2215, 302),
           host("cudaLaunchKernel", 2220, 2222, 303), host("cudaStreamSynchronize", 2420, 2480, 304)]
D_DEVICE = [device("void gemm_kernel", 2040, 2050, 301), device("void elementwise_kernel", 2230, 2240, 303)]
M_SPANS = [host("mixlds.update", 3000, 3500), host("mixlds.sweep", 3010, 3400),
           host("mixlds.lds_estep", 3020, 3200), host("mixlds.mstep", 3300, 3390),
           host("mixlds.elbo_fetch", 3400, 3490)]
M_CALLS = [host("cudaLaunchKernel", 3030, 3032, 501), host("cudaLaunchKernel", 3310, 3312, 502),
           host("cudaStreamSynchronize", 3420, 3480, 503)]
M_DEVICE = [device("void kalman_lane_scan_kernel<2, false>", 3040, 3080, 501),
            device("void gemm_kernel", 3320, 3340, 502)]
NLDS_METRICS = ("nlds_s_estep_launches_per_sweep", "nlds_s_estep_ms_per_sweep",
                "nlds_x_estep_ms_per_sweep", "nlds_gate_ms_per_sweep", "nlds_host_syncs_per_sweep",
                "nlds_allocator_calls_per_sweep")
MIXLDS_METRICS = ("kalman_lane_scan_roofline", "mixlds_estep_ms_per_sweep",
                  "mixlds_mstep_ms_per_sweep", "mixlds_host_syncs_per_sweep")
DMBD_METRICS = ("launches_per_sweep", "torch_ops_ms_per_sweep", "logsemiring_scan_roofline",
                "kalman_plane_scan_roofline", "device_idle_pct", "peak_mem_gib", "sweep_mfu_pct",
                "estep_launches_per_sweep", "mstep_launches_per_sweep", "host_syncs_per_sweep",
                "allocator_calls_per_sweep")
SCANS = {"kalman_lane_scan": (10, 2, 30), "logsemiring_scan": (10, 4, 30),
         "kalman_plane_scan": (10, 6, 10)}


def harness(events, metrics, sweeps=2):
    """The readers' values as ``run.run_cell`` reads them: ``trace_context``'s
    keys, then each reader in turn with a profile held by this frame."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.events = lambda: list(events)
    ctx = run.trace_context(prof, sweeps, 0.01)
    ctx.update(work=work, cell={"flops_per_sweep": 1e6}, scans=SCANS, sweep_s=0.002,
               window_peak_bytes=2 ** 20)
    values = {m: run.importlib.import_module(f"cardbench.metrics.{m}").read(ctx) for m in metrics}
    return ctx, values


def test_nlds_readers_on_a_synthetic_trace():
    ctx, values = harness(N_SPANS + N_CALLS + N_DEVICE, NLDS_METRICS)
    # the s E-step's own kernel, its two scans; then the second sweep's
    assert values["nlds_s_estep_launches_per_sweep"] == pytest.approx((3 + 1) / 2)
    assert values["nlds_s_estep_ms_per_sweep"] == pytest.approx(1e-3 * (5 + 10 + 10 + 10) / 2)
    assert values["nlds_x_estep_ms_per_sweep"] == pytest.approx(1e-3 * (10 + 40 + 10) / 2)
    assert values["nlds_gate_ms_per_sweep"] == pytest.approx(1e-3 * (30 + 20) / 2)
    # the stray sync in the M-step and the ELBO fetch's; not the one outside
    assert values["nlds_host_syncs_per_sweep"] == 1.0
    # the gate's cudaMalloc in the second sweep; not the cudaFree outside
    assert values["nlds_allocator_calls_per_sweep"] == 0.5
    breakdown = ctx["breakdown"]
    assert dict(breakdown["device_by_span"])["scan.logsemiring_scan"] == pytest.approx(20e-6)
    assert dict(breakdown["idle_by_span"])["nlds.elbo_fetch"] == pytest.approx(180e-6)
    rows = nlds_charge.charge.table(nlds_charge.of(ctx))
    assert rows["nlds.mstep"]["launches"] == 0.5 and rows["nlds.mstep"]["syncs"] == 0.5


@pytest.mark.parametrize("metric", NLDS_METRICS)
def test_nlds_readers_find_nothing_without_spans_or_device_events(metric):
    # no spans (a program without them, or another family's cell)
    assert harness(N_CALLS + N_DEVICE, [metric])[1][metric] is None
    assert harness(D_SPANS + D_CALLS + D_DEVICE, [metric])[1][metric] is None
    assert harness(M_SPANS + M_CALLS + M_DEVICE, [metric])[1][metric] is None
    # no device events (a run on the CPU)
    assert harness(N_SPANS + N_CALLS, [metric])[1][metric] is None
    assert nlds_charge.of(dict(sweeps=2)) is None  # no profile anywhere above


@pytest.mark.parametrize("events", [D_SPANS + D_CALLS + D_DEVICE, M_SPANS + M_CALLS + M_DEVICE],
                         ids=["dmbd", "mixlds"])
def test_other_readers_are_unchanged_by_the_nlds_readers(events):
    """In a DMBD or a MixLDS cell the new readers read nothing and leave every
    existing reading and the breakdown as they were; on a trace holding every
    family's spans each family's span readers read their own."""
    others = DMBD_METRICS + MIXLDS_METRICS
    before, alone = harness(events, others)
    after, beside = harness(events, others + NLDS_METRICS)
    assert {m: beside[m] for m in others} == alone
    assert all(beside[m] is None for m in NLDS_METRICS)
    assert after["breakdown"] == before["breakdown"]
    span_metrics = DMBD_METRICS[7:] + MIXLDS_METRICS[1:]
    everything = D_SPANS + D_CALLS + D_DEVICE + M_SPANS + M_CALLS + M_DEVICE
    _, both = harness(everything, others)
    _, all_three = harness(everything + N_SPANS + N_CALLS + N_DEVICE, others + NLDS_METRICS)
    assert {m: all_three[m] for m in span_metrics} == {m: both[m] for m in span_metrics}
    _, nlds_alone = harness(N_SPANS + N_CALLS + N_DEVICE, NLDS_METRICS)
    assert {m: all_three[m] for m in NLDS_METRICS} == nlds_alone
    assert mixlds_charge.of(dict(sweeps=2)) is None


# -- on the card -------------------------------------------------------------------
def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the logsemiring and lane Kalman scans have no CPU mode")


@pytest.mark.gpu
def test_on_the_card_the_route_takes_the_scan_kernels_and_no_host_sync():
    """At the cell's shapes: q(s)'s smoother makes the host wait nowhere
    (``torch.cuda.set_sync_debug_mode("error")`` raises on a synchronizing
    call), and a sweep takes two logsemiring and two lane launches and no
    plain scan."""
    need_card()
    traffic = dict(T=1000, batch=1000, lr=1.0)
    inputs = drv.make_inputs(CFG, traffic, 2**31 + 7, "cuda")
    model = drv.build(CFG, inputs, "cuda")
    model.update(inputs["y"], iters=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    T, b, K = 1000, 1000, 4
    trans = torch.log_softmax(torch.randn(T, b, K, K, generator=g, device="cuda"), -1)
    obs = 10 * torch.randn(T, b, K, generator=g, device="cuda")
    init = torch.full((K,), -1.3862943611198906, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, SEzz, SEz0, logZ = driven_forward_backward_parallel(trans, init, obs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert p.shape == (T, b, K) and SEzz.shape == (T, b, K, K) and logZ.shape == (b,)
    assert torch.isfinite(logZ).all()
    log, lane = scan.LOGSEMIRING, scan.KALMAN_LANE
    counts = (log.launches, log.plain_calls, lane.launches, lane.plain_calls)
    model.update(inputs["y"], iters=2)
    assert (log.launches - counts[0], lane.launches - counts[2]) == (4, 4)
    assert (log.plain_calls, lane.plain_calls) == (counts[1], counts[3])
    assert (log.folded.launches, log.folded.plain_calls) == (0, 0)


@pytest.mark.gpu
def test_on_the_card_the_control_fails_and_the_program_passes():
    """A short run of the cell at its own size, its checked and late sweeps,
    with the control's numbers (the reference in float32 with TF32 matrix
    products, in the program's place) beside the program's."""
    need_card()
    result, lines = run.run_cell(CELL, 2**31 + 201, 2, 0, control=True)
    assert result["correct"], lines
    assert not check.verdict(result["control_checks"], LIMITS, 0), result["control_checks"]


@pytest.mark.gpu
def test_on_the_card_a_short_traced_run_of_the_cell_is_correct():
    need_card()
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", CELL, "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert listed == set(result["metrics"])
    # no launch a time step: a few hundred in all (504 measured on an H100),
    # where the sequential driven forward-backward takes ~51 a step at T=1000
    assert result["metrics"]["nlds_s_estep_launches_per_sweep"]["value"] <= 1000
