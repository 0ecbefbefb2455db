#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pyvbmp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on a line of its own; any failure exits non-zero and
prints no result:

1. guard: a CUDA card is present; its name and power limit; TF32 off; the
   four kernels build from pyvbmp_tpu_torch/csrc with nvcc (one process per
   source, all at once);
2. each kernel against its plain PyTorch version at the shapes of the two
   main paths, forward and reverse (max relative error <= 1e-4, logw
   relative to its scale), with both times;
3. DMBD on batched Lorenz trajectories (T=399, batch=100, obs (3,2),
   role_dims (1,2,1), hidden_dims (2,2,2)) for 10 sweeps on the card: the
   ELBO is finite and rises at every sweep, the logsemiring and plane Kalman
   kernels ran 2 x sweeps times, the lane Kalman kernel 0 times, and no
   plain scan ran;
4. the same initial state (carried as a numpy state dict) and data for 3
   sweeps on the card (float32) and on the CPU (float64, plain scans): the
   ELBO trajectories agree within relative 1e-4;
5. MixtureofLinearDynamicalSystems(4, (3,), 2, 0, 0, parallel_scan=True) on
   the batched-MixLDS data (T=100, batch=1000: 4000 Kalman lanes at h=2)
   for 10 sweeps on the card: the ELBO is finite, rises over the first 5
   sweeps and ends above where it started, the lane Kalman kernel ran
   2 x sweeps times, the other two 0 times, and no plain scan ran;
6. phase 4 for MixLDS: one numpy state, 3 sweeps on the card (float32) and
   on the CPU (float64), ELBO trajectories within relative 1e-4;
7. the weighted_outer kernel against its plain version (computed in float64
   on the card) at the digits shape (S=1347, p=65, K=9), the JAX module's
   measured size (S=400000, p=32, K=16) and an MNIST-16x16 shape (S=60000,
   p=257, K=9): max |kernel - plain| / max |plain| <= 1e-4, with the
   kernel's and the float32 plain version's times;
8. MultiNomialLogisticRegression (Polya-Gamma) on the digits bake-off
   (benchmarks/classification_bakeoff.py: 1347 train / 450 test, 64 pixels,
   10 classes) in float32 on the card with TF32 enabled globally: 10 x
   raw_update(iters=2), then predict.  weighted_outer ran exactly 20 times,
   its plain version and every scan 0 times; test accuracy >= 0.90; the
   training ELBO is finite;
9. the phase-8 fit from the same numpy state in float64 on the CPU: the
   training ELBOs agree within relative 1e-4 and the test argmax on >= 99%
   of the 450 samples;
10. the other three bake-off arms on the card in float32: Bouchard MNLR
   (10 x raw_update(iters=2)), dMixtureofLinearTransforms (4 experts) and
   NLRegression_Multinomial (4 components), each raw_update(iters=10):
   test accuracy >= 0.90, finite ELBO, and neither weighted_outer nor any
   scan launched;
11. the scan kernels at the DMBD-Flocking shapes (logsemiring (150, 14, 14,
   240), plane Kalman H=14 at T=150, N=20), one pass and time-folded (Cp=8,
   L=19), forward and reverse, against their plain versions (max relative
   error <= 1e-4), and the folded lane kernel at the MixLDS shape; kernel,
   folded-scan (all three phases) and plain times;
12. DMBD on Flocking (benchmarks/flocking_bench.py:19: T=150, batch=20, 12
   birds x 4 channels, role_dims (2,2,2), hidden_dims (2,2,2), three
   objects: K = H = 14) in float32 on the card, update(y, iters=10,
   latent_iters=1, lr=1.0) after a warm-up sweep, from one numpy state
   twice: the time fold off, then "auto".  Each run: sweeps/s; the ELBO is
   finite and rises at every sweep; launches (fold off: 2 per sweep each of
   the one-pass logsemiring and plane Kalman kernels, 0 folded; fold on: 2
   per sweep of each folded scan, 0 one-pass; the lane kernels and
   weighted_outer 0; no plain version); particular_assignment() is (T,
   batch, 12) with values in 0..3.  The two ELBO trajectories agree within
   relative 1e-4;
13. the same state and data for 3 sweeps on the card (float32, fold on) and
   on the CPU (float64, fold off): ELBO trajectories within relative 1e-4;
14. MixLDS (phase 5's data and state) for 3 sweeps with the fold off, then
   forced on ("1", the only switch that folds a lane scan): the one-pass,
   then the folded lane kernel ran 2 x sweeps times, every other kernel 0
   times, no plain version; the two ELBO trajectories within relative 1e-4.

Phases 1-10 run with the time fold off, whatever PYVBMP_PALLAS_TIME_FOLD
says; phases 11-14 set it themselves.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

CFG = dict(T=399, batch=100, obs_shape=(3, 2), role_dims=(1, 2, 1),
           hidden_dims=(2, 2, 2), sweeps=10, compare_sweeps=3, seed=0)
# benchmarks/mixlds_bench.py at reference_times.json:mixlds_T100_b1000_K4
MIX = dict(T=100, batch=1000, obs_dim=3, hidden=2, num_systems=4, sweeps=10,
           compare_sweeps=3, data_seed=3, seed=0)
# benchmarks/classification_bakeoff.py's digits task.  The initial states
# come from this seed: the mixture arms' accuracy depends on the initial
# state (0.882-0.951 over seeds 0-7 on the CPU in float32; 0.931 at seed 2).
DIGITS = dict(classes=10, mnlr_updates=10, mnlr_iters=2, mixture=4, mixture_iters=10,
              seed=2, min_acc=0.90, min_agree=0.99)
# benchmarks/flocking_bench.py:19-20 at reference_times.json:dmbd_flocking_T150_b20_obj3
FLOCK = dict(T=150, batch=20, n_birds=12, obs_dim=4, role_dims=(2, 2, 2),
             hidden_dims=(2, 2, 2), number_of_objects=3, sweeps=10, compare_sweeps=3,
             seed=0)
SCATTER_SHAPES = [("digits", 1347, 65, 9), ("weighted_scatter.py:16", 400000, 32, 16),
                  ("MNIST-16x16", 60000, 257, 9)]
REL_TOL = 1e-4


def fail(msg):
    print(f"FAIL {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(out, ref):
    """Max |out - ref| over max |ref|, both over finite entries; -inf
    entries must sit at the same places, and nothing may be NaN."""
    if torch.isnan(out).any() or torch.isnan(ref).any():
        return float("inf"), float("inf")
    if not torch.equal(torch.isinf(out), torch.isinf(ref)):
        return float("inf"), float("inf")
    fin = torch.isfinite(ref)
    diff = (out[fin] - ref[fin]).abs().max().item()
    scale = ref[fin].abs().max().item()
    return diff / max(scale, 1e-30), diff


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_guard():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pyvbmp_tpu_torch.ops import _cuda, scan

    scan.TIME_FOLD = "0"

    t0 = time.perf_counter()
    _cuda.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 guard: {torch.cuda.get_device_name(0)}; card {card}; "
          f"kernels built and loaded in {build_s:.2f} s")
    for so_log in sorted(_cuda.BUILD_DIR.glob("*.log")):
        for line in so_log.read_text().splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                print(f"  ptxas: {line.strip()}")
    return card


def semiring_elems(rs, T, K, N):
    """Log transition + observation logits with a masked transition, as the
    role chain builds them."""
    trans = np.log(rs.dirichlet(np.ones(K), K))
    trans[0, K - 1] = trans[K - 1, 0] = -np.inf
    obs = rs.randn(T, N, K) * 2.0
    M = trans[None, None] + obs[..., None, :]  # (T, N, K, K)
    return np.ascontiguousarray(M.transpose(0, 2, 3, 1))


def kalman_elems(rs, T, H, N):
    """Pair potentials whose joint (a, b) precision is SPD, so every prefix
    and suffix stays a proper potential."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    plane = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, -1))
    return (
        plane(J[..., :H, :H]), plane(J[..., :H, H:]), plane(J[..., H:, H:]),
        plane(rs.randn(T, N, H)), plane(rs.randn(T, N, H)),
        rs.randn(T, N),
    )


def lane_elems(rs, T, H, N):
    """kalman_elems packed by components (pyvbmp_tpu_torch/ops/smallmat.py)."""
    from pyvbmp_tpu_torch.ops import smallmat as sm

    Jaa, Jab, Jbb, ha, hb, w = (torch.from_numpy(x) for x in kalman_elems(rs, T, H, N))
    dense = lambda x: x.permute(0, 3, 1, 2)  # (T, H, H, N) -> (T, N, H, H)
    return (sm.sym_pack(dense(Jaa)), sm.gen_pack(dense(Jab)), sm.sym_pack(dense(Jbb)),
            ha, hb, w)


def phase_kernels(card):
    from pyvbmp_tpu_torch.ops import scan

    rs = np.random.RandomState(CFG["seed"])
    T = CFG["T"]
    N_roles = CFG["batch"] * CFG["obs_shape"][0]
    N_mix = MIX["batch"] * MIX["num_systems"]
    cases = [
        (scan.LOGSEMIRING, "K=4 N=300 (bench)", (semiring_elems(rs, T, 4, N_roles),)),
        (scan.LOGSEMIRING, "K=7 N=300", (semiring_elems(rs, T, 7, N_roles),)),
        (scan.KALMAN_PLANE, "H=6 N=100 (bench)", kalman_elems(rs, T, 6, CFG["batch"])),
        (scan.KALMAN_PLANE, "H=10 N=100", kalman_elems(rs, T, 10, CFG["batch"])),
        (scan.KALMAN_LANE, "H=2 T=100 N=4000 (bench)", lane_elems(rs, MIX["T"], 2, N_mix)),
        (scan.KALMAN_LANE, "H=3 T=100 N=4000", lane_elems(rs, MIX["T"], 3, N_mix)),
        (scan.KALMAN_LANE, "H=1 T=100 N=4000", lane_elems(rs, MIX["T"], 1, N_mix)),
    ]
    record = {s.name: dict(abs=0.0, ms=None, plain_ms=None) for s in scan.SCANS}
    for s, label, arrays in cases:
        leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                       for a in arrays)
        for reverse in (False, True):
            out = s.kernel(leaves, reverse)
            ref = s.plain(leaves, reverse)
            torch.cuda.synchronize()
            errs = [rel_err(o, r) for o, r in zip(out, ref)]
            err = max(e[0] for e in errs)
            abs_err = max(e[1] for e in errs)
            ms = time_ms(lambda: s.kernel(leaves, reverse), 20)
            plain_ms = time_ms(lambda: s.plain(leaves, reverse), 2)
            print(f"phase 2 {s.name} {label} {'reverse' if reverse else 'forward'}: "
                  f"max rel err {err:.3e} (abs {abs_err:.3e}); kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms; card {card}")
            if not err <= REL_TOL:
                fail(f"{s.name} {label}: kernel disagrees with plain ({err:.3e})")
            rec = record[s.name]
            rec["abs"] = max(rec["abs"], abs_err)
            if "bench" in label and not reverse:
                rec["ms"], rec["plain_ms"] = ms, plain_ms
    return record


def lorenz_data(dtype, device):
    from pyvbmp_tpu_torch.simulations import Lorenz

    sim = Lorenz()
    sim.num_steps = CFG["T"] * 5 + 6
    g = torch.Generator().manual_seed(CFG["seed"])
    data = sim.simulate(CFG["batch"], generator=g)[: CFG["T"]]
    return data.to(device=device, dtype=dtype)


def build_model(generator):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery

    return DynamicMarkovBlanketDiscovery(
        obs_shape=CFG["obs_shape"], role_dims=CFG["role_dims"],
        hidden_dims=CFG["hidden_dims"], parallel_scan=True,
        generator=generator, dtype=torch.float64,
    )


def drive(model, sweeps, *data):
    """One ``update`` of ``sweeps`` sweeps with every kernel count set to 0
    just before it; returns (seconds, launches, plain calls) read just
    after."""
    reset_counts()
    t0 = time.perf_counter()
    model.update(*data, iters=sweeps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (dt, *read_counts())


def check_launches(path, launches, plain, want):
    print(f"  kernel launches {launches} (want {want}); plain versions {plain}")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{path}: {name} launched {launches[name]} times, want {n}")
        if plain[name] != 0:
            fail(f"{path}: plain {name} ran {plain[name]} times on the card's path")


def phase_dmbd(card):
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    y = lorenz_data(torch.float32, "cuda")
    state = dmbd_state(build_model(torch.Generator().manual_seed(CFG["seed"])))
    warm = dmbd_from_state(state, device="cuda", dtype=torch.float32)
    warm.update(y, iters=1)
    model = dmbd_from_state(state, device="cuda", dtype=torch.float32)
    sweeps = CFG["sweeps"]
    dt, launches, plain = drive(model, sweeps, y)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 3 DMBD-Lorenz T={CFG['T']} batch={CFG['batch']} {sweeps} sweeps: "
          f"{sweeps / dt:.3f} sweeps/s ({dt:.3f} s); card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("ELBO not finite")
    if not (np.diff(elbo) > 0).all():
        fail("ELBO did not rise at every sweep")
    check_launches("DMBD", launches, plain, {
        "logsemiring_scan": 2 * sweeps, "kalman_plane_scan": 2 * sweeps,
        "kalman_lane_scan": 0, "weighted_outer": 0})
    p = model.obs_model.p
    mu = model.px.mu
    if p.shape != (CFG["T"], CFG["batch"], CFG["obs_shape"][0], 4):
        fail(f"p has shape {tuple(p.shape)}")
    if not (torch.isfinite(p).all() and torch.isfinite(mu).all()):
        fail("posteriors not finite")
    return launches


@contextlib.contextmanager
def time_fold(switch):
    """The scans' time-fold switch set to ``switch`` for the block."""
    from pyvbmp_tpu_torch.ops import scan

    old, scan.TIME_FOLD = scan.TIME_FOLD, switch
    try:
        yield
    finally:
        scan.TIME_FOLD = old


def compare_card_cpu(label, from_state, state, y64, n, card, card_fold="0"):
    """``n`` sweeps from one numpy state on the card (float32, time fold
    ``card_fold``) and on the CPU (float64, fold off): the ELBO trajectories
    agree within REL_TOL."""
    gpu = from_state(state, device="cuda", dtype=torch.float32)
    cpu = from_state(state, device="cpu", dtype=torch.float64)
    with time_fold(card_fold):
        gpu.update(y64.to(device="cuda", dtype=torch.float32), iters=n)
    cpu.update(y64, iters=n)
    e_gpu = np.asarray(gpu.ELBO_save, np.float64)
    e_cpu = np.asarray(cpu.ELBO_save, np.float64)
    dev = np.abs(e_gpu - e_cpu) / np.abs(e_cpu)
    print(f"{label} card f32 vs CPU f64, {n} sweeps: ELBO card {e_gpu.tolist()} "
          f"cpu {e_cpu.tolist()}; max rel dev {dev.max():.3e}; card {card}")
    if not dev.max() <= REL_TOL:
        fail(f"{label}: card and CPU ELBO trajectories differ by {dev.max():.3e}")


def phase_compare(card):
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    state = dmbd_state(build_model(torch.Generator().manual_seed(CFG["seed"] + 1)))
    compare_card_cpu("phase 4", dmbd_from_state, state,
                     lorenz_data(torch.float64, "cpu"), CFG["compare_sweeps"], card)


def mixlds_data():
    """The batched-MixLDS data of benchmarks/mixlds_bench.py:make_data: K
    rotating 2-d latent systems seen through random 3-d projections,
    (T, batch, 3) float32."""
    rs = np.random.RandomState(MIX["data_seed"])
    T, o, h = MIX["T"], MIX["obs_dim"], MIX["hidden"]

    def rollout(theta, n):
        A = np.asarray(
            [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
        ) * 0.98
        C = rs.randn(o, h)
        x = rs.randn(n, h)
        ys = []
        for t in range(T):
            x = x @ A.T + 0.05 * rs.randn(n, h)
            ys.append(x @ C.T + 0.1 * rs.randn(n, o))
        return np.stack(ys)

    per = MIX["batch"] // MIX["num_systems"]
    y = np.concatenate(
        [rollout(0.1 + 0.15 * k, per) for k in range(MIX["num_systems"])], 1
    )
    return y.astype(np.float32)


def mixlds_state0(seed):
    from pyvbmp_tpu_torch.models import MixtureofLinearDynamicalSystems
    from pyvbmp_tpu_torch.utils.convert import mixlds_state

    return mixlds_state(MixtureofLinearDynamicalSystems(
        MIX["num_systems"], (MIX["obs_dim"],), MIX["hidden"], 0, 0,
        parallel_scan=True, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64,
    ))


def phase_mixlds(card):
    from pyvbmp_tpu_torch.utils.convert import mixlds_from_state

    y = torch.from_numpy(mixlds_data()).cuda()
    state = mixlds_state0(MIX["seed"])
    warm = mixlds_from_state(state, device="cuda", dtype=torch.float32)
    warm.update(y, iters=1)
    model = mixlds_from_state(state, device="cuda", dtype=torch.float32)
    sweeps = MIX["sweeps"]
    dt, launches, plain = drive(model, sweeps, y)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 5 MixLDS T={MIX['T']} batch={MIX['batch']} K={MIX['num_systems']} "
          f"h={MIX['hidden']} {sweeps} sweeps: {sweeps / dt:.3f} sweeps/s "
          f"({dt:.3f} s); card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("MixLDS ELBO not finite")
    if not (np.diff(elbo)[:5] > 0).all():
        fail("MixLDS ELBO did not rise over the first 5 sweeps")
    if not elbo[-1] > elbo[0]:
        fail("MixLDS ELBO ended below where it started")
    check_launches("MixLDS", launches, plain, {
        "logsemiring_scan": 0, "kalman_plane_scan": 0,
        "kalman_lane_scan": 2 * sweeps, "weighted_outer": 0})
    p, logZ = model.p, model.logZ
    if p.shape != (MIX["batch"], MIX["num_systems"]):
        fail(f"p has shape {tuple(p.shape)}")
    if not (torch.isfinite(p).all() and torch.isfinite(logZ).all()):
        fail("MixLDS posteriors not finite")
    if not torch.allclose(p.sum(-1), torch.ones_like(p[:, 0]), atol=1e-5):
        fail("MixLDS responsibilities do not sum to 1")
    return launches


def phase_mixlds_compare(card):
    from pyvbmp_tpu_torch.utils.convert import mixlds_from_state

    compare_card_cpu("phase 6 MixLDS", mixlds_from_state, mixlds_state0(MIX["seed"] + 1),
                     torch.from_numpy(mixlds_data()).double(), MIX["compare_sweeps"], card)


def phase_scatter(card):
    from pyvbmp_tpu_torch.ops import weighted_scatter as ws

    rs = np.random.RandomState(CFG["seed"])
    rec = dict(abs=0.0, ms=None, plain_ms=None)
    for label, S, p, K in SCATTER_SHAPES:
        X = torch.tensor(rs.randn(S, p), dtype=torch.float32, device="cuda")
        W = torch.tensor(rs.rand(S, K), dtype=torch.float32, device="cuda")
        out = ws.WEIGHTED_OUTER.kernel(X, W)
        ref = ws.weighted_outer_einsum(X.double(), W.double())
        torch.cuda.synchronize()
        err, abs_err = rel_err(out.double(), ref)
        ms = time_ms(lambda: ws.WEIGHTED_OUTER.kernel(X, W), 20)
        plain_ms = time_ms(lambda: ws.weighted_outer_einsum(X, W), 20)
        gflop = 2.0 * S * K * p * p / 1e9
        print(f"phase 7 weighted_outer {label} S={S} p={p} K={K} ({gflop:.3f} GFLOP "
              f"full): max rel err {err:.3e} (abs {abs_err:.3e}); kernel {ms:.4f} ms, "
              f"plain (float32 einsum) {plain_ms:.4f} ms; card {card}")
        if not err <= REL_TOL:
            fail(f"weighted_outer {label}: kernel disagrees with plain ({err:.3e})")
        rec["abs"] = max(rec["abs"], abs_err)
        if label == "digits":
            rec["ms"], rec["plain_ms"] = ms, plain_ms
    return rec


def digits():
    """The bake-off's digits split as float64 CPU tensors: Xtr, Ytr (one-hot),
    Xte, and the test labels yte (numpy)."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from classification_bakeoff import load_digits_task

    Xtr, ytr, Xte, yte = load_digits_task()
    Ytr = np.eye(DIGITS["classes"])[ytr]
    return (*(torch.tensor(a, dtype=torch.float64) for a in (Xtr, Ytr, Xte)), yte)


def kernel_counts():
    from pyvbmp_tpu_torch.ops import scan, weighted_scatter as ws

    return (*scan.SCANS, *scan.FOLDED_SCANS, ws.WEIGHTED_OUTER)


def reset_counts():
    torch.cuda.synchronize()
    for k in kernel_counts():
        k.launches = 0
        k.plain_calls = 0


def read_counts():
    return ({k.name: k.launches for k in kernel_counts()},
            {k.name: k.plain_calls for k in kernel_counts()})


def fit_mnlr(m, X, Y):
    for _ in range(DIGITS["mnlr_updates"]):
        m.raw_update(X, Y, iters=DIGITS["mnlr_iters"])


def classifier_elbo(m, X, Y):
    return float(m.Elog_like(X, Y).sum() - m.KLqprior())


def phase_mnlr(card, data):
    from pyvbmp_tpu_torch.transforms import MultiNomialLogisticRegression
    from pyvbmp_tpu_torch.utils.convert import mnlr_from_state, mnlr_state

    Xtr, Ytr, Xte, yte = data
    g = torch.Generator().manual_seed(DIGITS["seed"])
    state = mnlr_state(MultiNomialLogisticRegression(
        DIGITS["classes"], Xtr.shape[1], generator=g, dtype=torch.float64))
    X, Y, Xe = (a.to("cuda", torch.float32) for a in (Xtr, Ytr, Xte))
    mnlr_from_state(state, "cuda", torch.float32).raw_update(X, Y)  # warm-up
    m = mnlr_from_state(state, "cuda", torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        reset_counts()
        t0 = time.perf_counter()
        fit_mnlr(m, X, Y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = read_counts()
        labels = m.predict(Xe).argmax(-1).cpu().numpy()
        elbo = classifier_elbo(m, X, Y)
        tf32_kept = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    acc = float((labels == yte).mean())
    print(f"phase 8 MNLR (PG) digits, {DIGITS['mnlr_updates']} x raw_update(iters="
          f"{DIGITS['mnlr_iters']}), float32, TF32 enabled globally: fit {dt:.4f} s; "
          f"test accuracy {acc:.4f}; ELBO {elbo:.6e}; card {card}")
    print(f"  launches {launches}; plain calls {plain}; the caller's TF32 setting "
          f"{'kept' if tf32_kept else 'lost'} after the pinned calls")
    want = DIGITS["mnlr_updates"] * DIGITS["mnlr_iters"]
    if launches["weighted_outer"] != want or plain["weighted_outer"] != 0:
        fail(f"MNLR: weighted_outer launched {launches['weighted_outer']} times "
             f"(want {want}), plain {plain['weighted_outer']} (want 0)")
    if any(launches[s] or plain[s] for s in launches if s != "weighted_outer"):
        fail("MNLR: a scan ran on the classifier's path")
    if not tf32_kept:
        fail("the precision pin did not restore the caller's TF32 setting")
    if not acc >= DIGITS["min_acc"]:
        fail(f"MNLR digits accuracy {acc:.4f} < {DIGITS['min_acc']}")
    if not np.isfinite(elbo):
        fail("MNLR ELBO not finite")
    return state, elbo, labels, launches


def phase_mnlr_compare(card, data, state, elbo_gpu, labels_gpu):
    from pyvbmp_tpu_torch.utils.convert import mnlr_from_state

    Xtr, Ytr, Xte, _ = data
    cpu = mnlr_from_state(state, "cpu", torch.float64)
    fit_mnlr(cpu, Xtr, Ytr)
    elbo_cpu = classifier_elbo(cpu, Xtr, Ytr)
    labels_cpu = cpu.predict(Xte).argmax(-1).numpy()
    dev = abs(elbo_gpu - elbo_cpu) / abs(elbo_cpu)
    agree = float((labels_cpu == labels_gpu).mean())
    print(f"phase 9 MNLR (PG) card f32 vs CPU f64 after {DIGITS['mnlr_updates']} updates: "
          f"ELBO card {elbo_gpu:.9e} cpu {elbo_cpu:.9e}, rel dev {dev:.3e}; test argmax "
          f"agrees on {agree:.4f} of {len(labels_cpu)}; card {card}")
    if not dev <= REL_TOL:
        fail(f"MNLR card and CPU ELBOs differ by {dev:.3e}")
    if not agree >= DIGITS["min_agree"]:
        fail(f"MNLR card and CPU labels agree on only {agree:.4f}")


def phase_other_arms(card, data):
    from pyvbmp_tpu_torch import transforms as tr

    Xtr, Ytr, Xte, yte = data
    X, Y, Xe = (a.to("cuda", torch.float32) for a in (Xtr, Ytr, Xte))
    K, p, mix = DIGITS["classes"], Xtr.shape[1], DIGITS["mixture"]

    def make(cls, *extra):
        g = torch.Generator().manual_seed(DIGITS["seed"])
        return cls(K, p, *extra, generator=g, dtype=torch.float32, device="cuda")

    def bouchard():
        m = make(tr.MultiNomialLogisticRegression_Bouchard)
        fit_mnlr(m, X, Y)
        return m.predict(Xe).argmax(-1), classifier_elbo(m, X, Y)

    def mixture(cls):
        m = make(cls, mix)
        m.raw_update(X, Y, iters=DIGITS["mixture_iters"])
        return m.predict(Xe)[0].mean()[..., 0].argmax(-1), m.ELBO_save[-1]

    arms = [
        ("MNLR (Bouchard)", bouchard),
        (f"dMixLT ({mix} experts)", lambda: mixture(tr.dMixtureofLinearTransforms)),
        (f"NLR-multinomial ({mix} components)",
         lambda: mixture(tr.NLRegression_Multinomial)),
    ]
    for name, fit in arms:
        reset_counts()
        t0 = time.perf_counter()
        labels, elbo = fit()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = read_counts()
        acc = float((labels.cpu().numpy() == yte).mean())
        print(f"phase 10 {name} digits, float32: fit and predict {dt:.4f} s (first "
              f"run, no warm-up); test accuracy {acc:.4f}; ELBO {elbo:.6e}; card {card}")
        if any(launches.values()) or any(plain.values()):
            fail(f"{name}: a kernel or a plain version ran ({launches}, {plain})")
        if not acc >= DIGITS["min_acc"]:
            fail(f"{name} digits accuracy {acc:.4f} < {DIGITS['min_acc']}")
        if not np.isfinite(elbo):
            fail(f"{name} ELBO not finite")


def phase_fold_kernels(card):
    """Phase 11: one-pass and folded kernels against their plain versions at
    the DMBD-Flocking shapes (and the folded lane kernel at the MixLDS
    shape).  Returns the folded kernels' record and the one-pass kernels'
    largest absolute error at K = H = 14."""
    from pyvbmp_tpu_torch.ops import scan

    rs = np.random.RandomState(FLOCK["seed"])
    T = FLOCK["T"]
    cases = [
        (scan.LOGSEMIRING, "K=14 T=150 N=240 (Flocking)",
         (semiring_elems(rs, T, 14, FLOCK["batch"] * FLOCK["n_birds"]),)),
        (scan.KALMAN_PLANE, "H=14 T=150 N=20 (Flocking)", kalman_elems(rs, T, 14, FLOCK["batch"])),
        (scan.KALMAN_LANE, "H=2 T=100 N=4000", lane_elems(rs, MIX["T"], 2, MIX["batch"] * 4)),
    ]
    folded = {s.folded.name: dict(abs=0.0, ms=None, plain_ms=None) for s in scan.SCANS}
    one_pass = {s.name: 0.0 for s in scan.SCANS}
    for s, label, arrays in cases:
        leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                       for a in arrays)
        Cp, L = scan.fold_shape(leaves[0].shape[0], leaves[0].shape[-1])
        routes = ([("folded", s.folded, "folded scan (phase 1 + fused phases 2-3)")]
                  + ([] if s is scan.KALMAN_LANE else [("one-pass", s, "one-pass kernel")]))
        for reverse in (False, True):
            for route, fn, what in routes:
                out = fn.kernel(leaves, reverse)
                ref = fn.plain(leaves, reverse)
                torch.cuda.synchronize()
                errs = [rel_err(o, r) for o, r in zip(out, ref)]
                err, abs_err = max(e[0] for e in errs), max(e[1] for e in errs)
                ms = time_ms(lambda: fn.kernel(leaves, reverse), 10)
                plain_ms = time_ms(lambda: fn.plain(leaves, reverse), 1)
                print(f"phase 11 {fn.name} {label} {'reverse' if reverse else 'forward'}"
                      f"{f' (Cp={Cp}, L={L})' if route == 'folded' else ''}: max rel err "
                      f"{err:.3e} (abs {abs_err:.3e}); {what} {ms:.4f} ms, plain "
                      f"{plain_ms:.3f} ms; card {card}")
                if not err <= REL_TOL:
                    fail(f"{fn.name} {label}: kernel disagrees with plain ({err:.3e})")
                if route == "one-pass":
                    one_pass[s.name] = max(one_pass[s.name], abs_err)
                    continue
                rec = folded[fn.name]
                rec["abs"] = max(rec["abs"], abs_err)
                if not reverse:
                    rec["ms"], rec["plain_ms"] = ms, plain_ms
    return folded, one_pass


def flocking_data(dtype, device):
    from pyvbmp_tpu_torch.simulations import Flocking

    sim = Flocking(n_birds=FLOCK["n_birds"], Tmax=FLOCK["T"], batch_size=FLOCK["batch"])
    y = sim.simulate(torch.Generator().manual_seed(FLOCK["seed"]))
    return y.to(device=device, dtype=dtype)


def flocking_state(seed):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_state

    return dmbd_state(DynamicMarkovBlanketDiscovery(
        obs_shape=(FLOCK["n_birds"], FLOCK["obs_dim"]), role_dims=FLOCK["role_dims"],
        hidden_dims=FLOCK["hidden_dims"], number_of_objects=FLOCK["number_of_objects"],
        parallel_scan=True, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64,
    ))


def phase_flocking(card):
    """Phase 12: DMBD-Flocking at full width, the fold off and then on, from
    one state.  Returns each route's launches."""
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    y = flocking_data(torch.float32, "cuda")
    state = flocking_state(FLOCK["seed"])
    sweeps = FLOCK["sweeps"]
    fit = dict(iters=sweeps, latent_iters=1, lr=1.0)
    zero = {"kalman_lane_scan": 0, "kalman_lane_scan_folded": 0, "weighted_outer": 0}
    want = {
        "0": {"logsemiring_scan": 2 * sweeps, "kalman_plane_scan": 2 * sweeps,
              "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0, **zero},
        "auto": {"logsemiring_scan": 0, "kalman_plane_scan": 0,
                 "logsemiring_scan_folded": 2 * sweeps,
                 "kalman_plane_scan_folded": 2 * sweeps, **zero},
    }
    elbos, launches_by_route = {}, {}
    for fold in ("0", "auto"):
        with time_fold(fold):
            dmbd_from_state(state, device="cuda", dtype=torch.float32).update(
                y, iters=1, latent_iters=1, lr=1.0)
            model = dmbd_from_state(state, device="cuda", dtype=torch.float32)
            reset_counts()
            t0 = time.perf_counter()
            model.update(y, **fit)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches, plain = read_counts()
        elbo = np.asarray(model.ELBO_save, np.float64)
        print(f"phase 12 DMBD-Flocking T={FLOCK['T']} batch={FLOCK['batch']} "
              f"birds={FLOCK['n_birds']} objects={FLOCK['number_of_objects']} (K=H=14), "
              f"time fold {fold}, {sweeps} sweeps: {sweeps / dt:.3f} sweeps/s "
              f"({dt:.3f} s); card {card}")
        print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
        if fold == "auto":
            print("  each folded launch runs two CUDA kernels (phase 1; phases 2-3 "
                  "fused); phase 2 makes no launch of its own")
        if not np.isfinite(elbo).all():
            fail(f"Flocking (fold {fold}): ELBO not finite")
        if not (np.diff(elbo) > 0).all():
            fail(f"Flocking (fold {fold}): ELBO did not rise at every sweep")
        check_launches(f"Flocking (fold {fold})", launches, plain, want[fold])
        pa = model.particular_assignment()
        shape = (FLOCK["T"], FLOCK["batch"], FLOCK["n_birds"])
        if tuple(pa.shape) != shape or pa.min() < 0 or pa.max() > FLOCK["number_of_objects"]:
            fail(f"particular_assignment: shape {tuple(pa.shape)}, values "
                 f"{int(pa.min())}..{int(pa.max())}")
        counts = np.bincount(pa.flatten().cpu().numpy(), minlength=4).tolist()
        print(f"  particular_assignment {tuple(pa.shape)}, label counts {counts}")
        elbos[fold], launches_by_route[fold] = elbo, launches
    dev = (np.abs(elbos["auto"] - elbos["0"]) / np.abs(elbos["0"])).max()
    print(f"  fold on vs off: max rel ELBO dev {dev:.3e}")
    if not dev <= REL_TOL:
        fail(f"Flocking: the fold changes the ELBO trajectory by {dev:.3e}")
    return launches_by_route


def phase_flocking_compare(card):
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    compare_card_cpu("phase 13 DMBD-Flocking (card: fold on)", dmbd_from_state,
                     flocking_state(FLOCK["seed"] + 1), flocking_data(torch.float64, "cpu"),
                     FLOCK["compare_sweeps"], card, card_fold="auto")


def phase_mixlds_folded(card):
    """Phase 14: MixLDS (phase 5's data and state) with the time fold off,
    then forced on ("1", the only switch that folds a lane scan).  Returns
    the forced run's launches."""
    from pyvbmp_tpu_torch.utils.convert import mixlds_from_state

    y = torch.from_numpy(mixlds_data()).cuda()
    state = mixlds_state0(MIX["seed"])
    n = MIX["compare_sweeps"]
    want = {"0": {"kalman_lane_scan": 2 * n, "kalman_lane_scan_folded": 0},
            "1": {"kalman_lane_scan": 0, "kalman_lane_scan_folded": 2 * n}}
    elbos = {}
    for fold in ("0", "1"):
        model = mixlds_from_state(state, device="cuda", dtype=torch.float32)
        with time_fold(fold):
            dt, launches, plain = drive(model, n, y)
        print(f"phase 14 MixLDS time fold {fold}, {n} sweeps: {n / dt:.3f} sweeps/s "
              f"({dt:.3f} s); card {card}")
        check_launches(f"MixLDS (fold {fold})", launches, plain, {
            "logsemiring_scan": 0, "kalman_plane_scan": 0, "logsemiring_scan_folded": 0,
            "kalman_plane_scan_folded": 0, "weighted_outer": 0, **want[fold]})
        elbos[fold] = np.asarray(model.ELBO_save, np.float64)
        if not np.isfinite(elbos[fold]).all():
            fail(f"MixLDS (fold {fold}): ELBO not finite")
    dev = (np.abs(elbos["1"] - elbos["0"]) / np.abs(elbos["0"])).max()
    print(f"  fold on vs off: ELBO {elbos['1'].tolist()} vs {elbos['0'].tolist()}; "
          f"max rel dev {dev:.3e}")
    if not dev <= REL_TOL:
        fail(f"MixLDS: the fold changes the ELBO trajectory by {dev:.3e}")
    return launches


def main():
    card = phase_guard()
    record = phase_kernels(card)
    launches_dmbd = phase_dmbd(card)
    phase_compare(card)
    launches_mix = phase_mixlds(card)
    phase_mixlds_compare(card)
    scatter = phase_scatter(card)
    data = digits()
    state, elbo, labels, launches_mnlr = phase_mnlr(card, data)
    phase_mnlr_compare(card, data, state, elbo, labels)
    phase_other_arms(card, data)
    folded, one_pass = phase_fold_kernels(card)
    launches_flock = phase_flocking(card)
    phase_flocking_compare(card)
    launches_mix_folded = phase_mixlds_folded(card)
    from pyvbmp_tpu_torch.ops import scan, weighted_scatter as ws

    kernels = []
    for s in scan.SCANS:
        r = record[s.name]
        kernels.append(dict(
            name=s.name, route="cuda", source=s.source, replaces=s.replaces,
            launches=launches_dmbd[s.name] + launches_mix[s.name]
            + launches_flock["0"][s.name],
            max_abs_err=max(r["abs"], one_pass[s.name]), ms=r["ms"],
            plain_ms=r["plain_ms"],
        ))
    for s in scan.FOLDED_SCANS:
        r = folded[s.name]
        kernels.append(dict(
            name=s.name, route="cuda", source=s.source, replaces=s.replaces,
            launches=launches_flock["auto"][s.name] + launches_mix_folded[s.name],
            max_abs_err=r["abs"],
            ms=r["ms"], plain_ms=r["plain_ms"],
        ))
    w = ws.WEIGHTED_OUTER
    kernels.append(dict(
        name=w.name, route="cuda", source=w.source, replaces=w.replaces,
        launches=launches_mnlr[w.name], max_abs_err=scatter["abs"],
        ms=scatter["ms"], plain_ms=scatter["plain_ms"],
    ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
