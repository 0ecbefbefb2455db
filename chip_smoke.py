#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pyvbmp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline CSRC_DIR] [--trace]

Phases, each reported on a line of its own; any failure exits non-zero and
prints no result:

1. guard: a CUDA card is present; its name and power limit; TF32 off; the
   four kernels build from pyvbmp_tpu_torch/csrc with nvcc (one process per
   source, all at once);
2. each kernel against its plain PyTorch version, forward and reverse (max
   relative error <= 1e-4, logw relative to its scale, the -inf pattern
   identical), with the kernel's time (scan_ms: a CUDA graph of 50
   launches through the C entry point replayed, each launch on its own
   copy of the inputs and outputs, rotated so that a launch finds its
   bytes out of the L2), the time through its wrapper (checks and
   allocations included) and the plain version's (one call after a first
   call):
   the logsemiring kernel at K = 4 (DMBD-Lorenz) and every rung (K = 3, 6,
   7, 8, 10, 16, 32) and the generic K = 40 (T=399, N=300), and K = 121
   (T=40, N=8); the plane Kalman kernel at H = 6 (DMBD-Lorenz), 4, 8, 10,
   15, 16 and 32 (T=399, N=100); the lane kernel at H = 1, 2, 3 (T=100,
   N=4000) and at H = 2 on four times the lanes (N=16000); and the
   scans of phases 15-17 and 19-21 at the shapes those paths give them
   (HMM-core K=8 T=200 N=200, and the same with a transition per step and
   lane as dHMM builds them; ARHMM K=4 T=200 N=200; NLDS lane H=2 T=200
   N=8; Cradle K=6 T=200 N=50 and H=6 N=10; Flame K=3 T=100 N=12 and H=4
   N=1; life K=12 T=128 N=384; artificial life K=10 T=199 N=16; LDS-core
   lane H=2 T=200 N=100);
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
   p=257, K=9): max |kernel - plain| / max |plain| <= 1e-4 and an exactly
   symmetric output, with the kernel's time (per call, and on the device
   from a profiler trace), the float32 plain version's and one
   torch.einsum call's;
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
   error <= 1e-4), and the folded lane kernel at the MixLDS shape (Cp=4,
   L=25) at H = 1, 2, 3; kernel, folded-scan (all three phases) and plain
   times;
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
   times, no plain version; the two ELBO trajectories within relative 1e-4;
15. HMM-core (benchmarks/core_models_bench.py:19: T=200, batch=200, K=8,
   d=4, NormalInverseWishart observations, its hmm_data recipe, seed 0),
   HMM(..., parallel_scan=True) for 10 sweeps after a warm-up: sweeps/s;
   the ELBO is finite and ends above where it started; the logsemiring
   kernel ran 2 x sweeps times, every other kernel 0 times, no plain
   version; then card f32 vs CPU f64 from one numpy state, 3 sweeps, within
   relative 1e-4;
16. DMBD on the ported NewtonsCradle's data (benchmarks/cradle_bench.py:
   5 balls, ball size 0.2, g=1, leak 0.01, dt 0.05, "1 ball object", T=200,
   batch 10; role_dims and hidden_dims (2,2,2): K = 6, h = 6),
   parallel_scan=True: the simulator on the card within relative 1e-6 of
   the CPU's, sweeps/s over 5 sweeps after a warm-up, 2 launches a sweep of
   each scan kernel and no plain version, then card f32 vs CPU f64 over 3
   sweeps within relative 1e-4;
17. DMBD on the ported FlameSimulator's data at examples/flame_example.py's
   full size (500 steps, every fifth: T=100, batch 1, obs (12,1); role_dims
   (1,1,1), hidden_dims (2,1,1): K = 3, h = 4), lr=0.5: the simulator on the
   card vs the CPU as in 16, then 3 sweeps card f32 vs CPU f64 within
   relative 1e-4 with 2 launches a sweep of each scan kernel;
18. DMBD-Lorenz with parallel_scan=False (the JAX default), 3 sweeps: no
   kernel launched and no plain scan; the ELBO rises; card f32 within
   relative 1e-4 of CPU f64; ELBO() is ELBO_last and KLqprior() is finite;
19. the recurrent switching LDS at the size of examples/nlds_example.py
   (make_data(T=200, B=8): obs 3, two rotation regimes switching every 50
   steps; NLDS((3,), hidden_dim=2, mixture_dim=2)), fit(iters=30,
   restarts=6) in float32 on the card: sweeps/s, the segmentation accuracy
   against the true regimes (max(acc, 1 - acc)), 2 lane Kalman launches a
   sweep and no other kernel or plain version, the best restart's ELBO
   rises; then 3 sweeps from one numpy state (q(s) included), card f32 vs
   CPU f64 within relative 1e-4;
20. dHMM with parallel_scan=True at the HMM-core widths (phase 15's data,
   K=8, d=4, NormalInverseWishart observations) driven by inputs of width
   2 (np.random.RandomState(1).randn): 10 sweeps after a warm-up, sweeps/s,
   the ELBO trajectory (finite, ends above where it started), 2
   logsemiring launches a sweep on the per-time elements and no other
   kernel; then card f32 vs CPU f64 over 3 sweeps within relative 1e-4;
21. ARHMM(4, 2, 2) with parallel_scan=True on two AR regimes switching
   every 10 steps at T=200, batch 200 (logsemiring K=4 on 200 lanes): as
   phase 20;
22. examples/life_as_we_know_it_example.py at full size: its synthetic
   particle soup (T=770, 64 particles, 6 clusters, seed 0: data (128, 6,
   64, 4)), role_dims (0,1,1), hidden_dims (12,4,4), 6 objects (K = 12, H =
   60: the dense Kalman form), parallel_scan=True, lr=0.5, float32: 5
   sweeps after a warm-up, sweeps/s; the ELBO finite and ending above where
   it started; 2 logsemiring launches a sweep, no Kalman kernel and no
   plain scan; card f32 vs CPU f64 over 3 sweeps from one numpy state, and
   Elog_like card vs CPU, within relative 1e-4;
23. examples/artificial_life_example.py at full size: synthetic rotors
   (T_synth=400, 16 particles: data (199, 1, 16, 4)), role_dims (0,1,0),
   hidden_dims (8,4,2), 10 objects, regression_dim=-1 (K = 10, H = 68),
   ptemp annealed 5 -> 1 over 3 + 3 sweeps: as phase 22 (the comparison
   over 1 sweep at ptemp 5 and 2 at ptemp 1);
24. DMBD-Lorenz (phase 3's data and widths) with unique_obs=True: one role
   model per observable, no role transition mask; 3 sweeps card f32 vs CPU
   f64 with 2 launches a sweep of each scan kernel, and Elog_like card vs
   CPU, within relative 1e-4;
25. GMM-core (benchmarks/core_models_bench.py:19-28: gmm_data with
   n=200000, nc=16, d=8, seed 0): GaussianMixtureModel(16, 8) in float32 on
   the card, initialize, then 10 iterations after a warm-up, iterations/s;
   the ELBO finite and ending above where it started; no kernel and no
   plain scan; card f32 vs CPU f64 over 3 iterations within relative 1e-4;
26. the tensor-state HMMs on the HMM-core data (phase 15's): Tensor_HMM
   (NormalInverseWishart (4,), batch (2, 4), state axes (2, 4)), HHMM (the
   same observations, event_dim=2) and Factorial_HMM(3, (2,), (4,)), each
   10 sweeps in float32 after a warm-up: sweeps/s; the ELBO finite and
   ending above where it started; no kernel and no plain scan (their
   smoother is sequential, as in the JAX package); then card f32 vs CPU
   f64 over 3 sweeps from one numpy state: ELBO, p and KLqprior within
   relative 1e-4;
27. GMM_vector(16, 8) (vector-format NIW components) on GMM-core's data as
   (n, 8, 1) columns: as phase 25, and KLqprior card vs CPU within
   relative 1e-4 (p's deviation printed);
28. LDS-core (benchmarks/core_models_bench.py:20: lds_data, T=200,
   batch=100, obs 4, hidden 2) with a caller's observation model,
   MatrixNormalGamma.create((4, 2), pad_X=True), and parallel_scan=True:
   10 sweeps of update(y) in float32 after a warm-up, sweeps/s; the ELBO
   finite and ending above where it started; the lane Kalman kernel 2
   launches a sweep at (200, 2, 100), no other kernel, no plain scan; card
   f32 vs CPU f64 over 3 sweeps within relative 1e-4;
29. examples/two_moons.py's loop at full size (n=400, the example's data; a
   dMixtureofLinearTransforms(2, 2, 4) layer and an MNLR(2, 2) head, both
   pad_X=True; 20 iterations) in float32 on the card: seconds, test
   accuracy >= 0.80, no kernel; the same numpy state in float64 on the
   CPU: the argmax predictions agree on >= 99% of the points;
30. every node ported with the tensor HMMs (the Wisharts: plain, Eigh,
   UnitDet, UnitTrace; DiagonalWishart and its UnitTrace;
   MatrixNormalGamma and its UnitTrace with pad_X; Hierarchical_Dirichlet,
   Transition, HierarchicalTransition; the two MVN message types; the two
   vector-format NIWs) at batch (1000,), events 4 x 4 (8 for the NIWs):
   one update from fixed statistics, then the KL and expectations, card f32
   vs CPU f64 within relative 1e-4 (node_suite).

Phases 1-10 run with the time fold off, whatever PYVBMP_PALLAS_TIME_FOLD
says; phases 11-14 set it themselves.  Phases 2, 7 and 11 print each kernel's
bound (BOUND_MS: bytes in once and out once over 3.35 TB/s, or FP32
operations over 67 TFLOP/s, whichever is larger) and its share of it.

--baseline CSRC_DIR builds a second set of kernels from CSRC_DIR (an earlier
version of pyvbmp_tpu_torch/csrc, e.g. unpacked with git archive into a
gitignored directory) beside ours, and times the two in turns (baseline,
ours, ours, baseline) at the phase-7 scatter shapes and at the phase-2 and
phase-11 scan shapes whose size the earlier kernels took (BASELINE_SIZES).
With --baseline, MixLDS (phase 5's data and state) is also timed end to
end with our lane kernel and the baseline's, in 12 alternating pairs.  --trace profiles 3
sweeps of DMBD-Lorenz, of DMBD-Flocking on both routes and of MixLDS with
the fold off and forced on (device busy time, kernel time by kind, wall
clock), of NLDS, dHMM and ARHMM, of DMBD-life, DMBD-artificial-life and
GMM-core (3 iterations), and of the three tensor HMMs, GMM_vector, LDS-core
with the pad_X observation model and two moons.  Neither changes what the
phases check.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# phase 2's other sizes: every logsemiring rung (K <= 4, 8, 16, 32) and the
# generic K > 32; the plane Kalman kernel's one-solve-per-thread design (H
# <= 14) and its looped one (H >= 15), exact rungs and padded sizes
PHASE2_K = (3, 6, 7, 8, 10, 16, 32, 40)
PHASE2_H = (4, 8, 10, 15, 16, 32)
# the generic logsemiring path past any shared-memory size (no main path)
PHASE2_WIDE_K = dict(K=121, T=40, N=8)
# the sizes a --baseline build is timed at: those the kernels took before
# they took every size (K = 4, 7, 14 and H = 6, 10, 14), and every lane H
BASELINE_SIZES = {"logsemiring_scan": (4, 7, 14), "kalman_plane_scan": (6, 10, 14),
                  "kalman_lane_scan": (1, 2, 3)}
# benchmarks/core_models_bench.py:19 (HMM_CFG), NormalInverseWishart
# observations, data from its hmm_data recipe
HMM_CORE = dict(T=200, batch=200, K=8, d=4, sweeps=10, compare_sweeps=3, data_seed=0,
                seed=0)
# examples/nlds_example.py at full size: make_data(T=200, B=8), NLDS((3,),
# hidden_dim=2, mixture_dim=2), fit(iters=30, restarts=6)
NLDS_EX = dict(T=200, B=8, hidden=2, mixture=2, iters=30, restarts=6, compare_sweeps=3,
               data_seed=0, seed=0)
# dHMM at the HMM-core widths (HMM_CORE's data), inputs of width 2 from
# np.random.RandomState(1).randn as tests/test_models_hmm_lds.py makes them
DHMM_CORE = dict(p=2, sweeps=10, compare_sweeps=3, input_seed=1, seed=0)
# ARHMM(4, 2, 2) on tests/test_models_hmm_lds.py's two-regime AR recipe at
# HMM_CORE's T and batch
ARHMM_CFG = dict(dim=4, n=2, p=2, sweeps=10, compare_sweeps=3, data_seed=0, seed=0)
# DMBD at the Newton's-cradle widths (benchmarks/cradle_bench.py:21-33: K = 6,
# h = 6) and the Flame widths (examples/flame_example.py:16-27: K = 3, h = 4)
# on the ported simulators' data: the cradle's 5 balls, "1 ball object",
# T=200, batch 10; the flame's 500 steps, every fifth kept (T=100), batch 1
WIDTHS = {
    "Cradle": dict(obs_shape=(5, 2), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2), T=200,
                   batch=10),
    "Flame": dict(obs_shape=(12, 1), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1), T=100,
                  batch=1),
}
CRADLE = dict(n_balls=5, ball_size=0.2, g=1, leak=0.01, dt=0.05, init_type="1 ball object",
              sweeps=5, compare_sweeps=3, data_seed=3, seed=0)
FLAME = dict(num_steps=500, delta_t=0.02, thermal_diffusivity=0.5, temperature_threshold=0.45,
             num_sources=12, stride=5, lr=0.5, compare_sweeps=3, data_seed=0, seed=0)
# examples/life_as_we_know_it_example.py at full size: its synthetic soup
# (load_life(T=770, n=64, k=6), seed 0: data (128, 6, 64, 4)), role_dims (0,
# 1, 1), hidden_dims (12, 4, 4), 6 objects: K = 12, H = 60 (the dense Kalman
# form); examples/artificial_life_example.py at full size: synthetic rotors
# (T_synth=400, 16 particles: data (199, 1, 16, 4)), role_dims (0, 1, 0),
# hidden_dims (8, 4, 2), 10 objects, regression_dim=-1: K = 10, H = 68, its
# ptemp annealed 5 -> 1 (3 + 3 sweeps here).  ``scan`` is the logsemiring
# scan's (T, K, lanes) on each path.  Both run at the examples' lr=0.5.
LIFE = dict(T=770, n=64, k=6, role_dims=(0, 1, 1), hidden_dims=(12, 4, 4),
            number_of_objects=6, regression_dim=0, schedule=((1.0, 5),),
            compare=((1.0, 3),), lr=0.5, scan=(128, 12, 384), seed=0)
ALIFE = dict(T_synth=400, n=16, role_dims=(0, 1, 0), hidden_dims=(8, 4, 2),
             number_of_objects=10, regression_dim=-1, schedule=((5.0, 3), (1.0, 3)),
             compare=((5.0, 1), (1.0, 2)), lr=0.5, scan=(199, 10, 16), seed=0)
# benchmarks/core_models_bench.py:19-28 (GMM_CFG) with its gmm_data recipe
GMM_CORE = dict(n=200000, nc=16, d=8, iters=10, compare_iters=3, data_seed=0, seed=0)
# benchmarks/core_models_bench.py:19's HMM data (HMM_CORE) under the
# tensor-state HMMs: 8 joint states as the axes (2, 4) (Tensor_HMM, HHMM) or
# as 3 binary factors (Factorial_HMM)
TENSOR_HMM = dict(sweeps=10, compare_sweeps=3, seed=0)
# benchmarks/core_models_bench.py:20 (LDS_CFG) with its lds_data recipe: obs
# 4, hidden 2, the observation model a MatrixNormalGamma of event (4, 2)
# with pad_X=True (its bias column takes the LDS's regressor)
LDS_CORE = dict(T=200, batch=100, obs=4, hidden=2, sweeps=10, compare_sweeps=3,
                data_seed=0, seed=0)
# examples/two_moons.py at full size: two_moons(n=400), a
# dMixtureofLinearTransforms(2, 2, 4, pad_X=True) layer, an
# MultiNomialLogisticRegression(2, 2, pad_X=True) head, 20 iterations
MOONS = dict(n=400, hidden=2, experts=4, iters=20, min_acc=0.80, min_agree=0.99, seed=0)
NODE_BATCH = 1000  # phase 30: every new node at batch (1000,)
SIM_TOL = 1e-6  # a simulator on the card against the same simulator on the CPU
REL_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet (dense FP32 below)
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20  # H100 L2 cache
SCAN_REPS = 50  # launches a scan kernel is timed over (scan_ms)


def bound_ms(nbytes, flops):
    """(least time in ms, what bounds it) for a function that must move
    ``nbytes`` and do ``flops`` FP32 operations on one H100."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def scan_work(name, T, size, N):
    """(bytes, FP32 operations) of one inclusive scan of T elements on N
    lanes: each element read once and each prefix written once, and one
    combine per row after the first.  logsemiring: K^3 adds, exps and sums;
    plane Kalman: Cholesky (2/3 H^3), 2H+1 solves ((2H+1) H^2), A'A, B'B,
    A'B (6 H^3) and A'c, B'c, c'c; lane Kalman: the same on h <= 3."""
    if name.startswith("logsemiring"):
        floats, ops = size * size, 3 * size ** 3
    else:
        H = size
        packed = name.startswith("kalman_lane")
        floats = (H * (H + 1) + H * H if packed else 3 * H * H) + 2 * H + 1
        ops = 2 * H ** 3 / 3 + (2 * H + 1) * H * H + 6 * H ** 3 + 4 * H * H + 2 * H
    return 2 * 4 * T * N * floats, (T - 1) * N * ops


def scatter_work(S, p, K):
    """(bytes, FP32 operations) of the weighted scatter: X, W read once, O
    written once; one multiply-add per (s, k) and upper-triangle entry."""
    return 4 * (S * p + S * K + K * p * p), 2 * S * K * p * (p + 1) // 2


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


def time_ms(fn, reps, warm=True):
    """Mean ms of ``reps`` calls of ``fn``, after one call of its own
    unless ``warm`` is false (the caller has just made it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_baseline(csrc):
    """The kernels of another csrc directory, built as ours are (into a build
    directory beside it) and bound with the earlier scatter signature when
    the directory has it."""
    import ctypes

    from pyvbmp_tpu_torch.ops import _cuda

    csrc = Path(csrc).resolve()
    lib = _cuda.build(csrc, csrc.parent / "_build")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if "int group" not in (csrc / "weighted_outer.cu").read_text():
        lib.weighted_outer_f32.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.baseline_scatter_args = 5
    else:
        lib.baseline_scatter_args = 7
    return lib


@contextlib.contextmanager
def library(lib):
    """The kernels taken from ``lib`` (a baseline build) inside the block."""
    from pyvbmp_tpu_torch.ops import _cuda

    old, _cuda._library = _cuda._library, lib
    try:
        yield
    finally:
        _cuda._library = old


def graph_ms(fn, reps):
    """Mean ms of one call of ``fn`` replayed from a CUDA graph of ``reps``
    calls: the device's time for its launches, free of the host's time to
    make them (longer than the lane kernels' own)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 3) / reps


def in_turns(ours, theirs, reps, clock=time_ms):
    """(our ms, their ms), timed in turns: theirs, ours, ours, theirs."""
    b1 = clock(theirs, reps)
    o1, o2 = clock(ours, reps), clock(ours, reps)
    b2 = clock(theirs, reps)
    return (o1 + o2) / 2, (b1 + b2) / 2


def scan_launches(s, leaves, reverse, folded=False, reps=SCAN_REPS):
    """lib -> a call that launches scan ``s``'s kernel (its time fold when
    ``folded``: both CUDA kernels) through ``lib``'s C entry point with
    Scan.launch's arguments.  Each call reads and writes its own copy of
    the inputs and outputs, rotating over enough copies that those of a
    call have left the L2 before they come round again (every shape whose
    ``reps`` copies exceed 4 x L2_BYTES)."""
    from pyvbmp_tpu_torch.ops import scan

    T, size, N = s.check(leaves)
    args = scan.fold_args(T, N, reverse) if folded else dict(chunks=1, L=T, offset=0)
    C = args["chunks"]
    nbytes = 2 * 4 * sum(x.numel() for x in leaves)
    sets = min(reps, -(-4 * L2_BYTES // nbytes))
    copies = [([x.clone() for x in leaves], [torch.empty_like(x) for x in leaves],
               [x.new_empty((C,) + x.shape[1:]) if C > 1 else None for x in leaves])
              for _ in range(sets)]

    def launches(lib):
        entry, turn = getattr(lib, s.symbol), itertools.count()

        def call():
            ins, outs, totals = copies[next(turn) % sets]
            rc = entry(*(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
                       *(None if t is None else t.data_ptr() for t in totals),
                       T, size, N, C, args["L"], args["offset"], int(reverse),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                fail(f"{s.name}: launch failed, cudaError {rc}")

        return call

    return launches


def scan_ms(s, leaves, reverse, folded=False, base=None, reps=SCAN_REPS):
    """(our ms, baseline ms or None): one launch of scan ``s``'s kernel
    (scan_launches) by graph_ms over ``reps`` launches, from our library
    and, in turns, from a baseline library."""
    from pyvbmp_tpu_torch.ops import _cuda

    launches = scan_launches(s, leaves, reverse, folded, reps)
    ours = launches(_cuda.load_library())
    if base is None:
        return graph_ms(ours, reps), None
    return in_turns(ours, launches(base), reps, graph_ms)


def baseline_scatter(lib, X, W):
    """The scatter through a baseline library; one with the earlier
    signature gets the earlier split plan (pass-1 blocks per upper tile,
    class and S-chunk, ~4 per SM, chunks of >= 128 rows)."""
    from pyvbmp_tpu_torch.ops import weighted_scatter as ws

    if lib.baseline_scatter_args == 7:
        with library(lib):
            return ws.WEIGHTED_OUTER.kernel(X, W)
    S, p = X.shape
    K = W.shape[1]
    n_tiles = -(-p // 32)
    n_upper = n_tiles * (n_tiles + 1) // 2
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    want = max(1, min(-(-4 * sms // (K * n_upper)), -(-S // 128)))
    rows = -(-(-(-S // want)) // 32) * 32
    n_splits = -(-S // rows)
    out = torch.empty((K, p, p), dtype=torch.float32, device=X.device)
    partial = torch.empty(n_splits * K * n_upper * 1024, dtype=torch.float32, device=X.device)
    rc = lib.weighted_outer_f32(X.data_ptr(), W.data_ptr(), out.data_ptr(), partial.data_ptr(),
                                S, p, K, n_splits, rows, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"baseline weighted_outer: cudaError {rc}")
    return out


def device_ms(fn, reps=10):
    """Device time of one ``fn()`` in ms: the sum of its kernels' durations
    in a profiler trace of ``reps`` calls (free of the host's dispatch time,
    which sets the event-timed figure for a call this short)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / reps / 1e3 if spans else float("nan")


def share(ms, bound):
    return f"bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of it"


def phase_guard(baseline=None):
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
    with ThreadPoolExecutor(2) as pool:
        ours = pool.submit(_cuda.load_library)
        base = pool.submit(build_baseline, baseline) if baseline else None
        ours.result()
        build_s = time.perf_counter() - t0
        base_lib = base.result() if base else None
    print(f"phase 1 guard: {torch.cuda.get_device_name(0)}; card {card}; "
          f"kernels built and loaded in {build_s:.2f} s"
          + (f" (baseline {baseline} built beside them)" if baseline else ""))
    for so_log in sorted(_cuda.BUILD_DIR.glob("*.log")):
        for line in so_log.read_text().splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "nvcc ")):
                print(f"  build: {line.strip()}")
    return card, base_lib


def semiring_elems(rs, T, K, N, per_time=False):
    """Log transition + observation logits with a masked transition, as the
    role chain builds them; with ``per_time`` a transition for every step
    and lane, as the dHMM builds them."""
    trans = np.log(rs.dirichlet(np.ones(K), (T, N, K) if per_time else K))
    trans[..., 0, K - 1] = trans[..., K - 1, 0] = -np.inf
    obs = rs.randn(T, N, K) * 2.0
    M = trans + obs[..., None, :]  # (T, N, K, K)
    return np.ascontiguousarray(M.transpose(0, 2, 3, 1))


def kalman_elems(rs, T, H, N):
    """Pair potentials whose joint (a, b) precision is SPD, so every prefix
    and suffix stays a proper potential."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = W @ np.swapaxes(W, -1, -2) / (2 * H) + np.eye(2 * H)  # batched BLAS, not einsum
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


def phase_kernels(card, base=None):
    from pyvbmp_tpu_torch.ops import scan

    rs = np.random.RandomState(CFG["seed"])
    T = CFG["T"]
    N_roles = CFG["batch"] * CFG["obs_shape"][0]
    N_mix = MIX["batch"] * MIX["num_systems"]
    wide = PHASE2_WIDE_K
    cases = [
        (scan.LOGSEMIRING, "K=4 N=300 (bench)", (semiring_elems(rs, T, 4, N_roles),)),
        *[(scan.LOGSEMIRING, f"K={k} N=300", (semiring_elems(rs, T, k, N_roles),))
          for k in PHASE2_K],
        (scan.LOGSEMIRING, f"K={wide['K']} T={wide['T']} N={wide['N']}",
         (semiring_elems(rs, wide["T"], wide["K"], wide["N"]),)),
        (scan.KALMAN_PLANE, "H=6 N=100 (bench)", kalman_elems(rs, T, 6, CFG["batch"])),
        *[(scan.KALMAN_PLANE, f"H={h} N=100", kalman_elems(rs, T, h, CFG["batch"]))
          for h in PHASE2_H],
        (scan.KALMAN_LANE, "H=2 T=100 N=4000 (bench)", lane_elems(rs, MIX["T"], 2, N_mix)),
        (scan.KALMAN_LANE, "H=3 T=100 N=4000", lane_elems(rs, MIX["T"], 3, N_mix)),
        (scan.KALMAN_LANE, "H=1 T=100 N=4000", lane_elems(rs, MIX["T"], 1, N_mix)),
        # four times the lanes: four blocks of 32 lanes an SM, not one
        (scan.KALMAN_LANE, "H=2 T=100 N=16000", lane_elems(rs, MIX["T"], 2, 4 * N_mix)),
    ]
    # the scans of the HMM-core, Cradle and Flame paths at the shapes those
    # paths give them (T, K or H, lanes), ragged lane blocks included
    hc = HMM_CORE
    cases.append((scan.LOGSEMIRING, f"K={hc['K']} T={hc['T']} N={hc['batch']} (HMM-core)",
                  (semiring_elems(rs, hc["T"], hc["K"], hc["batch"]),)))
    # the dHMM's per-time elements at the HMM-core shape, ARHMM's K=4 on 200
    # lanes and NLDS's lane scan (N=8: the per-lane copy path)
    cases.append((scan.LOGSEMIRING, f"K={hc['K']} T={hc['T']} N={hc['batch']} per-time (dHMM)",
                  (semiring_elems(rs, hc["T"], hc["K"], hc["batch"], per_time=True),)))
    cases.append((scan.LOGSEMIRING, f"K={ARHMM_CFG['dim']} T={hc['T']} N={hc['batch']} (ARHMM)",
                  (semiring_elems(rs, hc["T"], ARHMM_CFG["dim"], hc["batch"]),)))
    cases.append((scan.KALMAN_LANE, f"H={NLDS_EX['hidden']} T={NLDS_EX['T']} "
                  f"N={NLDS_EX['B']} (NLDS)",
                  lane_elems(rs, NLDS_EX["T"], NLDS_EX["hidden"], NLDS_EX["B"])))
    for name, w in WIDTHS.items():
        K, H = sum(w["role_dims"]), sum(w["hidden_dims"])
        N = w["batch"] * w["obs_shape"][0]
        cases.append((scan.LOGSEMIRING, f"K={K} T={w['T']} N={N} ({name})",
                      (semiring_elems(rs, w["T"], K, N),)))
        cases.append((scan.KALMAN_PLANE, f"H={H} T={w['T']} N={w['batch']} ({name})",
                      kalman_elems(rs, w["T"], H, w["batch"])))
    # the role scans of phases 22-23 (their Kalman legs take the dense form)
    for name, c in (("life", LIFE), ("artificial life", ALIFE)):
        T, K, N = c["scan"]
        cases.append((scan.LOGSEMIRING, f"K={K} T={T} N={N} ({name})",
                      (semiring_elems(rs, T, K, N),)))
    # phase 28's lane scan, LDS-core with a pad_X observation model: N=100 is
    # not a multiple of 32, so the per-lane copy path
    c = LDS_CORE
    cases.append((scan.KALMAN_LANE, f"H={c['hidden']} T={c['T']} N={c['batch']} (LDS-core)",
                  lane_elems(rs, c["T"], c["hidden"], c["batch"])))
    record = {s.name: dict(abs=0.0, ms=None, plain_ms=None, bound=None) for s in scan.SCANS}
    for s, label, arrays in cases:
        leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                       for a in arrays)
        Tn, Nn = leaves[0].shape[0], leaves[0].shape[-1]
        bound = bound_ms(*scan_work(s.name, Tn, s.size_of(leaves), Nn))
        size = s.size_of(leaves)
        for reverse in (False, True):
            out = s.kernel(leaves, reverse)
            ref = s.plain(leaves, reverse)
            plain_ms = time_ms(lambda: s.plain(leaves, reverse), 1, warm=False)
            errs = [rel_err(o, r) for o, r in zip(out, ref)]
            err = max(e[0] for e in errs)
            abs_err = max(e[1] for e in errs)
            ms, base_ms = scan_ms(s, leaves, reverse,
                                  base=base if size in BASELINE_SIZES.get(s.name, ()) else None)
            wrapped = time_ms(lambda: s.kernel(leaves, reverse), 20)
            print(f"phase 2 {s.name} {label} {'reverse' if reverse else 'forward'}: "
                  f"max rel err {err:.3e} (abs {abs_err:.3e}); kernel {ms:.4f} ms"
                  + (f" (baseline {base_ms:.4f} ms)" if base_ms else "")
                  + f", through the wrapper {wrapped:.4f} ms, plain {plain_ms:.3f} ms; "
                  f"{share(ms, bound)}; card {card}")
            if not err <= REL_TOL:
                fail(f"{s.name} {label}: kernel disagrees with plain ({err:.3e})")
            rec = record[s.name]
            rec["abs"] = max(rec["abs"], abs_err)
            if "bench" in label and not reverse:
                rec["ms"], rec["plain_ms"], rec["bound"] = ms, plain_ms, bound
    return record


def lorenz_data(dtype, device):
    from pyvbmp_tpu_torch.simulations import Lorenz

    sim = Lorenz()
    sim.num_steps = CFG["T"] * 5 + 6
    g = torch.Generator().manual_seed(CFG["seed"])
    # integrated on the CPU, so every phase fits the same data
    data = sim.simulate(CFG["batch"], generator=g, device="cpu")[: CFG["T"]]
    return data.to(device=device, dtype=dtype)


def build_model(generator, parallel_scan=True):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery

    return DynamicMarkovBlanketDiscovery(
        obs_shape=CFG["obs_shape"], role_dims=CFG["role_dims"],
        hidden_dims=CFG["hidden_dims"], parallel_scan=parallel_scan,
        generator=generator, dtype=torch.float64, device="cpu",
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


def to_card(data):
    """Float64 CPU tensors (nested in tuples) as float32 on the card."""
    if isinstance(data, tuple):
        return tuple(to_card(x) for x in data)
    return data.to(device="cuda", dtype=torch.float32)


def compare_card_cpu(label, from_state, state, args, n, card, card_fold="0", fit=None):
    """``n`` sweeps (``update(*args, iters=n, **fit)``) from one numpy state
    on the card (float32, time fold ``card_fold``) and on the CPU (float64,
    fold off): the ELBO trajectories agree within REL_TOL.  ``args`` is the
    tuple of ``update``'s positional arguments, in float64 on the CPU.
    Returns the card's model, its run's launches and plain calls, and the
    CPU's model."""
    fit = fit or {}
    gpu = from_state(state, device="cuda", dtype=torch.float32)
    cpu = from_state(state, device="cpu", dtype=torch.float64)
    on_card = to_card(args)
    with time_fold(card_fold):
        reset_counts()
        gpu.update(*on_card, iters=n, **fit)
        torch.cuda.synchronize()
        launches, plain = read_counts()
    cpu.update(*args, iters=n, **fit)
    e_gpu = np.asarray(gpu.ELBO_save, np.float64)
    e_cpu = np.asarray(cpu.ELBO_save, np.float64)
    dev = np.abs(e_gpu - e_cpu) / np.abs(e_cpu)
    print(f"{label} card f32 vs CPU f64, {n} sweeps: ELBO card {e_gpu.tolist()} "
          f"cpu {e_cpu.tolist()}; max rel dev {dev.max():.3e}; card {card}")
    if not dev.max() <= REL_TOL:
        fail(f"{label}: card and CPU ELBO trajectories differ by {dev.max():.3e}")
    return gpu, launches, plain, cpu


def phase_compare(card):
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    state = dmbd_state(build_model(torch.Generator().manual_seed(CFG["seed"] + 1)))
    compare_card_cpu("phase 4", dmbd_from_state, state,
                     (lorenz_data(torch.float64, "cpu"),), CFG["compare_sweeps"], card)


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
                     (torch.from_numpy(mixlds_data()).double(),), MIX["compare_sweeps"],
                     card)


def phase_scatter(card, base=None):
    from pyvbmp_tpu_torch.ops import weighted_scatter as ws

    rs = np.random.RandomState(CFG["seed"])
    rec = dict(abs=0.0, ms=None, plain_ms=None, library_ms=None, bound=None)
    for label, S, p, K in SCATTER_SHAPES:
        X = torch.tensor(rs.randn(S, p), dtype=torch.float32, device="cuda")
        W = torch.tensor(rs.rand(S, K), dtype=torch.float32, device="cuda")
        out = ws.WEIGHTED_OUTER.kernel(X, W)
        ref = ws.weighted_outer_einsum(X.double(), W.double())
        torch.cuda.synchronize()
        err, abs_err = rel_err(out.double(), ref)
        bound = bound_ms(*scatter_work(S, p, K))
        ours = lambda: ws.WEIGHTED_OUTER.kernel(X, W)
        dev_txt = f" (device {device_ms(ours):.4f} ms)"
        if base is None:
            ms, base_txt = time_ms(ours, 20), ""
        else:
            theirs = lambda: baseline_scatter(base, X, W)
            ms, base_ms = in_turns(ours, theirs, 20)
            base_err = rel_err(theirs().double(), ref)[0]
            base_txt = (f"; baseline kernel {base_ms:.4f} ms (device {device_ms(theirs):.4f} "
                        f"ms; max rel err {base_err:.3e})")
        plain_ms = time_ms(lambda: ws.weighted_outer_einsum(X, W), 20)
        library_ms = time_ms(lambda: torch.einsum("sk,si,sj->kij", W, X, X), 20)
        print(f"phase 7 weighted_outer {label} S={S} p={p} K={K} "
              f"({scatter_work(S, p, K)[1] / 1e9:.3f} GFLOP on the triangle): max rel err "
              f"{err:.3e} (abs {abs_err:.3e}); kernel {ms:.4f} ms{dev_txt}, plain (float32 einsum "
              f"formulation) {plain_ms:.4f} ms, one torch.einsum call {library_ms:.4f} ms; "
              f"{share(ms, bound)}{base_txt}; card {card}")
        if not err <= REL_TOL:
            fail(f"weighted_outer {label}: kernel disagrees with plain ({err:.3e})")
        if not torch.equal(out, out.transpose(1, 2)):
            fail(f"weighted_outer {label}: output not exactly symmetric")
        rec["abs"] = max(rec["abs"], abs_err)
        if label == "digits":
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound=bound)
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


def phase_fold_kernels(card, base=None):
    """Phase 11: one-pass and folded kernels against their plain versions at
    the DMBD-Flocking shapes (and the folded lane kernel at the MixLDS
    shape, H = 1, 2, 3).  Returns the folded kernels' record and the
    one-pass kernels' largest absolute error at K = H = 14."""
    from pyvbmp_tpu_torch.ops import scan

    rs = np.random.RandomState(FLOCK["seed"])
    T = FLOCK["T"]
    cases = [
        (scan.LOGSEMIRING, "K=14 T=150 N=240 (Flocking)",
         (semiring_elems(rs, T, 14, FLOCK["batch"] * FLOCK["n_birds"]),)),
        (scan.KALMAN_PLANE, "H=14 T=150 N=20 (Flocking)", kalman_elems(rs, T, 14, FLOCK["batch"])),
        *[(scan.KALMAN_LANE, f"H={h} T=100 N=4000" + (" (MixLDS)" if h == MIX["hidden"] else ""),
           lane_elems(rs, MIX["T"], h, MIX["batch"] * MIX["num_systems"])) for h in (2, 1, 3)],
    ]
    folded = {s.folded.name: dict(abs=0.0, ms=None, plain_ms=None, bound=None)
              for s in scan.SCANS}
    one_pass = {s.name: 0.0 for s in scan.SCANS}
    for s, label, arrays in cases:
        leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                       for a in arrays)
        Cp, L = scan.fold_shape(leaves[0].shape[0], leaves[0].shape[-1])
        bound = bound_ms(*scan_work(s.name, leaves[0].shape[0], s.size_of(leaves),
                                    leaves[0].shape[-1]))
        routes = ([("folded", s.folded, "folded scan (phase 1 + fused phases 2-3)")]
                  + ([] if s is scan.KALMAN_LANE else [("one-pass", s, "one-pass kernel")]))
        for reverse in (False, True):
            for route, fn, what in routes:
                out = fn.kernel(leaves, reverse)
                ref = fn.plain(leaves, reverse)
                plain_ms = time_ms(lambda: fn.plain(leaves, reverse), 1, warm=False)
                errs = [rel_err(o, r) for o, r in zip(out, ref)]
                err, abs_err = max(e[0] for e in errs), max(e[1] for e in errs)
                ms, base_ms = scan_ms(s, leaves, reverse, route == "folded", base)
                wrapped = time_ms(lambda: fn.kernel(leaves, reverse), 10)
                print(f"phase 11 {fn.name} {label} {'reverse' if reverse else 'forward'}"
                      f"{f' (Cp={Cp}, L={L})' if route == 'folded' else ''}: max rel err "
                      f"{err:.3e} (abs {abs_err:.3e}); {what} {ms:.4f} ms"
                      + (f" (baseline {base_ms:.4f} ms)" if base_ms else "")
                      + f", through the wrapper {wrapped:.4f} ms, plain {plain_ms:.3f} ms; "
                      f"{share(ms, bound)}; card {card}")
                if not err <= REL_TOL:
                    fail(f"{fn.name} {label}: kernel disagrees with plain ({err:.3e})")
                if route == "one-pass":
                    one_pass[s.name] = max(one_pass[s.name], abs_err)
                    continue
                rec = folded[fn.name]
                rec["abs"] = max(rec["abs"], abs_err)
                if not reverse and ("Flocking" in label or "MixLDS" in label):
                    rec["ms"], rec["plain_ms"], rec["bound"] = ms, plain_ms, bound
    return folded, one_pass


def flocking_data(dtype, device):
    from pyvbmp_tpu_torch.simulations import Flocking

    sim = Flocking(n_birds=FLOCK["n_birds"], Tmax=FLOCK["T"], batch_size=FLOCK["batch"])
    y = sim.simulate(torch.Generator().manual_seed(FLOCK["seed"]), device="cpu")
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
                     flocking_state(FLOCK["seed"] + 1), (flocking_data(torch.float64, "cpu"),),
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


def phase_mixlds_turns(card, base, pairs=12, n=3, runs=3):
    """MixLDS (phase 5's data and state) per sweep with the baseline's lane
    kernel and ours, in ``pairs`` pairs of turns whose order alternates
    (baseline first, then ours first): each turn a model from the state, a
    warm-up sweep, then ``runs`` updates of ``n`` sweeps, and the median of
    their per-sweep times.  Prints each side's median and quartiles over
    its turns and the share of pairs that ours won."""
    from pyvbmp_tpu_torch.ops import _cuda
    from pyvbmp_tpu_torch.utils.convert import mixlds_from_state

    y = torch.from_numpy(mixlds_data()).cuda()
    state = mixlds_state0(MIX["seed"])

    def turn(lib):
        with library(lib):
            model = mixlds_from_state(state, device="cuda", dtype=torch.float32)
            model.update(y, iters=1)
            times = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.update(y, iters=n)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / n * 1e3)
        return float(np.median(times))

    ours_lib = _cuda.load_library()
    theirs, ours = [], []
    for k in range(pairs):
        if k % 2 == 0:
            theirs.append(turn(base))
            ours.append(turn(ours_lib))
        else:
            ours.append(turn(ours_lib))
            theirs.append(turn(base))
    won = sum(o < t for o, t in zip(ours, theirs)) / pairs

    def quartiles(x):
        return "/".join(f"{v:.3f}" for v in np.percentile(x, [25, 50, 75]))

    print(f"MixLDS in turns, ms per sweep over {pairs} alternating pairs (each turn the median "
          f"of {runs} x {n} sweeps), quartiles 25/50/75: baseline {quartiles(theirs)}, ours "
          f"{quartiles(ours)}; ours faster in {won:.0%} of pairs; card {card}")
    print("MixLDS in turns, each pair (baseline, ours): "
          + ", ".join(f"({t:.3f}, {o:.3f})" for t, o in zip(theirs, ours)))


def hmm_data():
    """benchmarks/core_models_bench.py:hmm_data at HMM_CORE: sticky K-state
    chains (stay with probability 0.9) seen through Gaussian means, (T,
    batch, d) float64."""
    rs = np.random.RandomState(HMM_CORE["data_seed"])
    K, T, B = HMM_CORE["K"], HMM_CORE["T"], HMM_CORE["batch"]
    mus = rs.randn(K, HMM_CORE["d"]) * 3
    z = np.zeros((T, B), np.int64)
    for t in range(1, T):
        stay = rs.rand(B) < 0.9
        z[t] = np.where(stay, z[t - 1], rs.randint(0, K, B))
    return torch.from_numpy(mus[z] + rs.randn(T, B, HMM_CORE["d"]))


def hmm_state0(seed):
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import HMM
    from pyvbmp_tpu_torch.utils.convert import hmm_state

    g = torch.Generator().manual_seed(seed)
    obs = NormalInverseWishart.create((HMM_CORE["d"],), (HMM_CORE["K"],), generator=g,
                                      dtype=torch.float64)
    return hmm_state(HMM(obs, parallel_scan=True, generator=g, dtype=torch.float64,
                         device="cpu"))


def phase_hmm(card):
    """Phase 15: the standalone HMM at the core_hmm config with the scan
    smoother, 10 sweeps after a warm-up, then card f32 vs CPU f64.  Returns
    the timed run's launches."""
    from pyvbmp_tpu_torch.utils.convert import hmm_from_state

    y64 = hmm_data()
    y = y64.to("cuda", torch.float32)
    state = hmm_state0(HMM_CORE["seed"])
    hmm_from_state(state, "cuda", torch.float32).update(y, iters=1)
    model = hmm_from_state(state, "cuda", torch.float32)
    sweeps = HMM_CORE["sweeps"]
    dt, launches, plain = drive(model, sweeps, y)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 15 HMM-core T={HMM_CORE['T']} batch={HMM_CORE['batch']} K={HMM_CORE['K']} "
          f"d={HMM_CORE['d']} (NIW, parallel_scan=True) {sweeps} sweeps: "
          f"{sweeps / dt:.3f} sweeps/s ({dt:.3f} s); card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("HMM-core ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail("HMM-core ELBO ended below where it started")
    check_launches("HMM-core", launches, plain, {
        "logsemiring_scan": 2 * sweeps, "kalman_plane_scan": 0, "kalman_lane_scan": 0,
        "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
        "kalman_lane_scan_folded": 0, "weighted_outer": 0})
    if tuple(model.p.shape) != (HMM_CORE["T"], HMM_CORE["batch"], HMM_CORE["K"]):
        fail(f"HMM-core p has shape {tuple(model.p.shape)}")
    compare_card_cpu("phase 15 HMM-core", hmm_from_state, hmm_state0(HMM_CORE["seed"] + 1),
                     (y64,), HMM_CORE["compare_sweeps"], card)
    return launches


def cradle_sim():
    from pyvbmp_tpu_torch.simulations import NewtonsCradle

    w, c = WIDTHS["Cradle"], CRADLE
    return NewtonsCradle(n_balls=c["n_balls"], ball_size=c["ball_size"], Tmax=w["T"],
                         batch_size=w["batch"], g=c["g"], leak=c["leak"], dt=c["dt"])


def flame_sim(device):
    from pyvbmp_tpu_torch.simulations import FlameSimulator

    c = FLAME
    return FlameSimulator(c["num_steps"], c["delta_t"], c["thermal_diffusivity"],
                          c["temperature_threshold"], c["num_sources"],
                          generator=torch.Generator().manual_seed(c["data_seed"]),
                          device=device)


def flame_data(temperature):
    """examples/flame_example.py's data: every fifth step, (T, 1, sources, 1)."""
    return temperature[:: FLAME["stride"]][:, None, :, None]


def check_simulator(label, on_card, on_cpu, card):
    """The card's simulation agrees with the CPU's (both float64)."""
    err = rel_err(on_card.cpu(), on_cpu)[0]
    print(f"  {label} simulated on the card vs the CPU: max rel dev {err:.3e}; card {card}")
    if not err <= SIM_TOL:
        fail(f"{label}: the simulator on the card and on the CPU differ by {err:.3e}")


def widths_state(name, seed):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_state

    dims = {k: WIDTHS[name][k] for k in ("obs_shape", "role_dims", "hidden_dims")}
    return dmbd_state(DynamicMarkovBlanketDiscovery(
        **dims, parallel_scan=True, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64, device="cpu"))


SCAN_PAIR_WANT = {"logsemiring_scan": 2, "kalman_plane_scan": 2, "kalman_lane_scan": 0,
                  "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
                  "kalman_lane_scan_folded": 0, "weighted_outer": 0}


def per_sweep(want, sweeps):
    return {k: v * sweeps for k, v in want.items()}


def phase_cradle(card):
    """Phase 16: DMBD with the scan smoothers on the ported NewtonsCradle's
    data (benchmarks/cradle_bench.py: 5 balls, "1 ball object", T=200,
    batch 10): sweeps/s over 5 sweeps after a warm-up, 2 launches a sweep of
    each scan kernel, then card f32 vs CPU f64 over 3 sweeps.  Returns the
    timed run's launches."""
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    w, c = WIDTHS["Cradle"], CRADLE
    sim = cradle_sim()
    y64, _ = sim.generate_data(c["init_type"], torch.Generator().manual_seed(c["data_seed"]),
                               device="cpu")
    if tuple(y64.shape) != (w["T"], w["batch"]) + w["obs_shape"]:
        fail(f"Cradle data has shape {tuple(y64.shape)}")
    on_card, _ = sim.generate_data(
        c["init_type"], torch.Generator().manual_seed(c["data_seed"]), device="cuda")
    check_simulator("NewtonsCradle", on_card, y64, card)
    y = y64.to("cuda", torch.float32)
    state = widths_state("Cradle", c["seed"])
    dmbd_from_state(state, "cuda", torch.float32).update(y, iters=1)
    model = dmbd_from_state(state, "cuda", torch.float32)
    dt, launches, plain = drive(model, c["sweeps"], y)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 16 DMBD-Cradle (NewtonsCradle data) T={w['T']} batch={w['batch']} obs "
          f"{w['obs_shape']} (K={sum(w['role_dims'])}, h={sum(w['hidden_dims'])}) "
          f"{c['sweeps']} sweeps: {c['sweeps'] / dt:.3f} sweeps/s ({dt:.3f} s); card {card}")
    print(f"  ELBO trajectory {elbo.tolist()}")
    if not np.isfinite(elbo).all():
        fail("DMBD-Cradle: ELBO not finite")
    check_launches("DMBD-Cradle", launches, plain, per_sweep(SCAN_PAIR_WANT, c["sweeps"]))
    n = c["compare_sweeps"]
    _, launches_cmp, plain_cmp, _ = compare_card_cpu(
        "phase 16 DMBD-Cradle", dmbd_from_state, widths_state("Cradle", c["seed"] + 1),
        (y64,), n, card)
    check_launches("DMBD-Cradle (card vs CPU)", launches_cmp, plain_cmp,
                   per_sweep(SCAN_PAIR_WANT, n))
    return launches


def phase_flame(card):
    """Phase 17: DMBD with the scan smoothers on the ported FlameSimulator's
    data at examples/flame_example.py's full size (500 steps, every fifth:
    T=100, batch 1, obs (12, 1)), lr=0.5: card f32 vs CPU f64 over 3
    sweeps, 2 launches a sweep of each scan kernel.  Returns the card run's
    launches."""
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    w, c = WIDTHS["Flame"], FLAME
    temperature, ign, _ = flame_sim("cpu").simulate()
    y64 = flame_data(temperature)
    if tuple(y64.shape) != (w["T"], w["batch"]) + w["obs_shape"]:
        fail(f"Flame data has shape {tuple(y64.shape)}")
    check_simulator("FlameSimulator", flame_sim("cuda").simulate()[0], temperature, card)
    print(f"  sources ignited: {int(torch.isfinite(ign).sum())} of {c['num_sources']}")
    n = c["compare_sweeps"]
    t0 = time.perf_counter()
    gpu, launches, plain, _ = compare_card_cpu(
        f"phase 17 DMBD-Flame (FlameSimulator data) T={w['T']} batch={w['batch']} obs "
        f"{w['obs_shape']} (K={sum(w['role_dims'])}, h={sum(w['hidden_dims'])}) lr={c['lr']}",
        dmbd_from_state, widths_state("Flame", c["seed"]), (y64,), n, card,
        fit=dict(lr=c["lr"]))
    print(f"  card and CPU runs {time.perf_counter() - t0:.3f} s")
    check_launches("DMBD-Flame", launches, plain, per_sweep(SCAN_PAIR_WANT, n))
    if not np.isfinite(gpu.ELBO_save).all():
        fail("DMBD-Flame: ELBO not finite")
    return launches


def phase_sequential(card):
    """Phase 18: DMBD-Lorenz with parallel_scan=False (the JAX default): the
    sequential smoothers launch no kernel; the ELBO rises; card f32 vs CPU
    f64; ELBO() is ELBO_last and KLqprior() is finite."""
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    state = dmbd_state(build_model(torch.Generator().manual_seed(CFG["seed"]),
                                   parallel_scan=False))
    n = CFG["compare_sweeps"]
    t0 = time.perf_counter()
    gpu, launches, plain, _ = compare_card_cpu(
        f"phase 18 DMBD-Lorenz parallel_scan=False T={CFG['T']} batch={CFG['batch']}",
        dmbd_from_state, state, (lorenz_data(torch.float64, "cpu"),), n, card)
    print(f"  card and CPU runs {time.perf_counter() - t0:.3f} s")
    check_launches("DMBD sequential", launches, plain, {k: 0 for k in launches})
    elbo = np.asarray(gpu.ELBO_save, np.float64)
    kl = gpu.KLqprior()
    print(f"  ELBO steps {np.diff(elbo).tolist()}; ELBO() {gpu.ELBO():.6e}; "
          f"KLqprior() {float(kl):.6e}")
    if gpu.parallel_scan or not gpu.cross_cov_compat:
        fail("the state did not carry parallel_scan=False")
    if not (np.diff(elbo) > 0).all():
        fail("DMBD sequential: ELBO did not rise at every sweep")
    if gpu.ELBO() != gpu.ELBO_last or not torch.isfinite(kl).all():
        fail("DMBD sequential: ELBO() is not ELBO_last, or KLqprior() is not finite")


def nlds_data():
    """examples/nlds_example.py:make_data at NLDS_EX, in numpy: a 2-d latent
    rotating slowly (0.08 rad a step) or fast (0.5), the regime flipping
    every 50 steps, seen through a random 3 x 2 map with noise 0.1.
    Returns y (T, B, 3) float64 and the true regimes (T, B)."""
    def rot(th):
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])

    rs = np.random.RandomState(NLDS_EX["data_seed"])
    As = [0.98 * rot(0.08), 0.98 * rot(0.5)]
    C = rs.randn(3, 2)
    x = rs.randn(NLDS_EX["B"], 2)
    ys, zs = [], []
    z = np.zeros(NLDS_EX["B"], int)
    for t in range(NLDS_EX["T"]):
        if t % 50 == 0 and t > 0:
            z = 1 - z
        A = np.stack([As[zi] for zi in z])
        x = np.einsum("bij,bj->bi", A, x) + 0.05 * rs.randn(NLDS_EX["B"], 2)
        ys.append(x @ C.T + 0.1 * rs.randn(NLDS_EX["B"], 3))
        zs.append(z.copy())
    return torch.from_numpy(np.stack(ys)), np.stack(zs)


def nlds_model(generator, dtype, device):
    from pyvbmp_tpu_torch.models import NLDS

    return NLDS((3,), hidden_dim=NLDS_EX["hidden"], mixture_dim=NLDS_EX["mixture"],
                generator=generator, dtype=dtype, device=device)


def phase_nlds(card):
    """Phase 19: the recurrent switching LDS at the size of
    examples/nlds_example.py: fit(iters=30, restarts=6) on the card in
    float32 (sweeps/s, segmentation accuracy, lane Kalman launches a sweep,
    the best restart's ELBO rising), then 3 sweeps from one numpy state on
    the card and on the CPU in float64.  Returns the fit's launches."""
    from pyvbmp_tpu_torch.utils.convert import nlds_from_state, nlds_state

    y64, ztrue = nlds_data()
    y = y64.to("cuda", torch.float32)
    iters, restarts = NLDS_EX["iters"], NLDS_EX["restarts"]
    model = nlds_model(torch.Generator().manual_seed(NLDS_EX["seed"]), torch.float32, "cuda")
    reset_counts()
    t0 = time.perf_counter()
    model.fit(y, iters=iters, restarts=restarts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    sweeps = iters * restarts
    hard = model.assignment().cpu().numpy()
    acc = max((hard == ztrue).mean(), (hard == 1 - ztrue).mean())
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 19 NLDS T={NLDS_EX['T']} batch={NLDS_EX['B']} obs 3 hidden "
          f"{NLDS_EX['hidden']} mixture {NLDS_EX['mixture']}, fit(iters={iters}, "
          f"restarts={restarts}): {sweeps / dt:.3f} sweeps/s ({dt:.3f} s); segmentation "
          f"accuracy {acc:.4f}; card {card}")
    print(f"  best restart's ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}")
    if not np.isfinite(elbo).all():
        fail("NLDS ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail("NLDS: the best restart's ELBO did not rise")
    check_launches("NLDS", launches, plain, {
        "logsemiring_scan": 0, "kalman_plane_scan": 0, "kalman_lane_scan": 2 * sweeps,
        "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
        "kalman_lane_scan_folded": 0, "weighted_outer": 0})
    if hard.shape != ztrue.shape:
        fail(f"NLDS assignment has shape {hard.shape}")
    start = nlds_model(torch.Generator().manual_seed(NLDS_EX["seed"] + 1), torch.float64,
                       "cpu")
    start.p = start._initial_p(NLDS_EX["T"], NLDS_EX["B"], y64)
    n = NLDS_EX["compare_sweeps"]
    _, launches_cmp, plain_cmp, _ = compare_card_cpu(
        "phase 19 NLDS", nlds_from_state, nlds_state(start), (y64,), n, card)
    check_launches("NLDS (card vs CPU)", launches_cmp, plain_cmp, {"kalman_lane_scan": 2 * n})
    return launches


def dhmm_inputs():
    """Inputs of width DHMM_CORE['p'] as tests/test_models_hmm_lds.py makes
    them (np.random.RandomState(1).randn), float64."""
    rs = np.random.RandomState(DHMM_CORE["input_seed"])
    return torch.from_numpy(rs.randn(HMM_CORE["T"], HMM_CORE["batch"], DHMM_CORE["p"]))


def dhmm_state0(seed):
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import dHMM
    from pyvbmp_tpu_torch.utils.convert import dhmm_state

    g = torch.Generator().manual_seed(seed)
    obs = NormalInverseWishart.create((HMM_CORE["d"],), (HMM_CORE["K"],), generator=g,
                                      dtype=torch.float64)
    return dhmm_state(dHMM(obs, DHMM_CORE["p"], parallel_scan=True, generator=g,
                           dtype=torch.float64, device="cpu"))


def ar_pairs(T, B, seed):
    """tests/test_models_hmm_lds.py:test_arhmm_runs's recipe: two AR
    regimes (0.9 I and a 0.9 rotation) switching every 10 steps; X (the
    previous point) and Y (the next), each (T, B, 1, 2, 1) float64."""
    rs = np.random.RandomState(seed)
    A1 = np.eye(2) * 0.9
    A2 = np.asarray([[0.0, -0.9], [0.9, 0.0]])
    x = rs.randn(B, 2)
    X, Y = [], []
    for t in range(T):
        y = x @ (A1 if (t // 10) % 2 == 0 else A2).T + 0.05 * rs.randn(B, 2)
        X.append(x)
        Y.append(y)
        x = y
    return tuple(torch.from_numpy(np.stack(a)[..., None, :, None]) for a in (X, Y))


def arhmm_state0(seed):
    from pyvbmp_tpu_torch.models import ARHMM
    from pyvbmp_tpu_torch.utils.convert import arhmm_state

    m = ARHMM(ARHMM_CFG["dim"], ARHMM_CFG["n"], ARHMM_CFG["p"],
              generator=torch.Generator().manual_seed(seed), dtype=torch.float64,
              device="cpu")
    m.parallel_scan = True
    return arhmm_state(m)


def phase_chain(card, phase, label, from_state, state, data64, sweeps, n_cmp, want):
    """A chain model's ``sweeps`` sweeps on the card in float32 after a
    warm-up sweep (sweeps/s, the ELBO trajectory, launches: ``want`` a
    sweep of the one-pass logsemiring scan, no other kernel, no plain
    version), then ``n_cmp`` sweeps card f32 vs CPU f64 from the next
    state.  ``data64`` is the tuple of ``update``'s positional arguments,
    float64 on the CPU.  Returns the timed run's launches."""
    data = to_card(data64)
    from_state(state(0), "cuda", torch.float32).update(*data, iters=1)
    model = from_state(state(0), "cuda", torch.float32)
    dt, launches, plain = drive(model, sweeps, *data)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase {phase} {label} {sweeps} sweeps: {sweeps / dt:.3f} sweeps/s ({dt:.3f} s); "
          f"card {card}")
    print(f"  ELBO trajectory {elbo.tolist()}")
    if not np.isfinite(elbo).all():
        fail(f"{label}: ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail(f"{label}: ELBO ended below where it started")
    check_launches(label, launches, plain, {
        "logsemiring_scan": want * sweeps, "kalman_plane_scan": 0, "kalman_lane_scan": 0,
        "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
        "kalman_lane_scan_folded": 0, "weighted_outer": 0})
    if tuple(model.p.shape[:2]) != (HMM_CORE["T"], HMM_CORE["batch"]):
        fail(f"{label}: p has shape {tuple(model.p.shape)}")
    compare_card_cpu(f"phase {phase} {label}", from_state, state(1), data64, n_cmp, card)
    return launches


def phase_dhmm(card):
    """Phase 20: dHMM with the scan smoother at the HMM-core widths (phase
    15's data and NormalInverseWishart observations) driven by inputs of
    width 2: 2 logsemiring launches a sweep on the per-time elements."""
    from pyvbmp_tpu_torch.utils.convert import dhmm_from_state

    return phase_chain(
        card, 20, f"dHMM T={HMM_CORE['T']} batch={HMM_CORE['batch']} K={HMM_CORE['K']} "
        f"d={HMM_CORE['d']} p={DHMM_CORE['p']} (NIW, parallel_scan=True)",
        dhmm_from_state, lambda i: dhmm_state0(DHMM_CORE["seed"] + i),
        (dhmm_inputs(), hmm_data()), DHMM_CORE["sweeps"], DHMM_CORE["compare_sweeps"], 2)


def phase_arhmm(card):
    """Phase 21: ARHMM(4, 2, 2) with the scan smoother on the two-regime AR
    recipe at T=200, batch 200: logsemiring K=4 on 200 lanes."""
    from pyvbmp_tpu_torch.utils.convert import arhmm_from_state

    c = ARHMM_CFG
    return phase_chain(
        card, 21, f"ARHMM({c['dim']}, {c['n']}, {c['p']}) T={HMM_CORE['T']} "
        f"batch={HMM_CORE['batch']} (parallel_scan=True)",
        arhmm_from_state, lambda i: arhmm_state0(c["seed"] + i),
        (ar_pairs(HMM_CORE["T"], HMM_CORE["batch"], c["data_seed"]),), c["sweeps"],
        c["compare_sweeps"], 2)


def life_data():
    """examples/life_as_we_know_it_example.py:load_life's synthetic particle
    soup at LIFE's size: (T' / 6, 6, n, 4) positions and velocities, float64."""
    c = LIFE
    rs = np.random.RandomState(0)
    member = rs.randint(0, c["k"], c["n"])
    centers = np.cumsum(0.02 * rs.randn(c["T"], c["k"], 2), axis=0)
    jitter = 0.15 * rs.randn(c["T"], c["n"], 2)
    for t in range(1, c["T"]):
        jitter[t] = 0.95 * jitter[t - 1] + 0.05 * rs.randn(c["n"], 2)
    data = centers[:, member] + jitter
    data = data / data.std()
    v = np.diff(data, axis=0)
    data = np.concatenate((data[1:], v / v.std()), -1)
    T6 = (data.shape[0] // 6) * 6
    data = data[:T6].reshape(6, T6 // 6, c["n"], 4).swapaxes(0, 1)
    return torch.from_numpy(data.astype(np.float32).astype(np.float64))


def rotor_data():
    """examples/artificial_life_example.py:load_rotor_story's synthetic rotors
    at ALIFE's size: (T, 1, n, 4), float64."""
    c = ALIFE
    rs = np.random.RandomState(0)
    t = np.arange(c["T_synth"])[:, None]
    centers = 0.5 * np.stack([np.cos(2 * np.pi * t / 300.0), np.sin(2 * np.pi * t / 300.0)], -1)
    phase = rs.rand(c["n"]) * 2 * np.pi
    omega = 2 * np.pi / (20.0 + 10.0 * rs.rand(c["n"]))
    radius = 0.3 + 0.4 * rs.rand(c["n"])
    ang = phase[None, :] + omega[None, :] * t
    data = centers + radius[None, :, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    data = data + 0.02 * rs.randn(*data.shape)
    data = data / data.std()
    v = np.diff(data, axis=0)
    data = np.concatenate((data[1:], v / v.std()), -1)
    data = data[: data.shape[0] // 2][:, None]
    return torch.from_numpy(data.astype(np.float32).astype(np.float64))


ROLE_SCAN_WANT = {"logsemiring_scan": 2, "kalman_plane_scan": 0, "kalman_lane_scan": 0,
                  "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
                  "kalman_lane_scan_folded": 0, "weighted_outer": 0}


def run_schedule(model, y, schedule, lr):
    """``update`` at each (ptemp, sweeps) of ``schedule`` in turn."""
    for ptemp, n in schedule:
        model.obs_model.ptemp = ptemp
        model.update(y, iters=n, lr=lr)


def compare_elog_like(label, state, y64, card):
    """Elog_like from one numpy state on the card (float32) and on the CPU
    (float64): within REL_TOL of the largest CPU value."""
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    gpu = dmbd_from_state(state, "cuda", torch.float32).Elog_like(y64.to("cuda", torch.float32))
    cpu = dmbd_from_state(state, "cpu", torch.float64).Elog_like(y64)
    err = rel_err(gpu.double().cpu(), cpu)[0]
    print(f"  {label} Elog_like card f32 vs CPU f64: shape {tuple(cpu.shape)}, max rel dev "
          f"{err:.3e}; card {card}")
    if not (torch.isfinite(gpu).all() and err <= REL_TOL):
        fail(f"{label}: Elog_like on the card and the CPU differ by {err:.3e}")


def phase_example(card, phase, name, cfg, y64):
    """Phases 22-23: an example's DMBD at full size with the scan smoothers
    (its Kalman leg in the dense form, h > 32): ``cfg['schedule']`` sweeps
    after a warm-up sweep (sweeps/s; the ELBO finite, ending above where it
    started; 2 logsemiring launches a sweep, no Kalman kernel, no plain
    scan), then card f32 vs CPU f64 over ``cfg['compare']`` from one numpy
    state, and Elog_like card vs CPU.  Returns the timed run's launches."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    def state(seed):
        return dmbd_state(DynamicMarkovBlanketDiscovery(
            tuple(y64.shape[-2:]), cfg["role_dims"], cfg["hidden_dims"],
            regression_dim=cfg["regression_dim"], number_of_objects=cfg["number_of_objects"],
            parallel_scan=True, generator=torch.Generator().manual_seed(seed),
            dtype=torch.float64, device="cpu"))

    lr = cfg["lr"]
    y = y64.to("cuda", torch.float32)
    state0 = state(cfg["seed"])
    model = dmbd_from_state(state0, "cuda", torch.float32)
    K, H = model.role_dim, model.hidden_dim
    shape = (y64.shape[0], K, y64.shape[1] * y64.shape[2])
    if shape != cfg["scan"]:
        fail(f"{name}: the role scan's (T, K, lanes) is {shape}, not {cfg['scan']}")
    run_schedule(model, y, [(cfg["schedule"][0][0], 1)], lr)  # warm-up sweep
    model = dmbd_from_state(state0, "cuda", torch.float32)
    sweeps = sum(n for _, n in cfg["schedule"])
    reset_counts()
    t0 = time.perf_counter()
    run_schedule(model, y, cfg["schedule"], lr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase {phase} DMBD-{name} data {tuple(y64.shape)} roles {cfg['role_dims']} hidden "
          f"{cfg['hidden_dims']} x {cfg['number_of_objects']} objects (K={K}, H={H}, dense "
          f"Kalman form) (ptemp, sweeps) {cfg['schedule']} lr={lr}: {sweeps / dt:.3f} sweeps/s "
          f"({dt:.3f} s); card {card}")
    print(f"  ELBO trajectory {elbo.tolist()}")
    if not np.isfinite(elbo).all():
        fail(f"DMBD-{name}: ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail(f"DMBD-{name}: ELBO ended below where it started")
    check_launches(f"DMBD-{name}", launches, plain, per_sweep(ROLE_SCAN_WANT, sweeps))

    t0 = time.perf_counter()
    st = state(cfg["seed"] + 1)
    gpu = dmbd_from_state(st, "cuda", torch.float32)
    cpu = dmbd_from_state(st, "cpu", torch.float64)
    reset_counts()
    run_schedule(gpu, y, cfg["compare"], lr)
    torch.cuda.synchronize()
    launches_cmp, plain_cmp = read_counts()
    run_schedule(cpu, y64, cfg["compare"], lr)
    e_gpu = np.asarray(gpu.ELBO_save, np.float64)
    e_cpu = np.asarray(cpu.ELBO_save, np.float64)
    dev = np.abs(e_gpu - e_cpu) / np.abs(e_cpu)
    print(f"phase {phase} DMBD-{name} card f32 vs CPU f64, (ptemp, sweeps) {cfg['compare']}: "
          f"ELBO card {e_gpu.tolist()} cpu {e_cpu.tolist()}; max rel dev {dev.max():.3e}; "
          f"{time.perf_counter() - t0:.3f} s; card {card}")
    if not dev.max() <= REL_TOL:
        fail(f"DMBD-{name}: card and CPU ELBO trajectories differ by {dev.max():.3e}")
    check_launches(f"DMBD-{name} (card vs CPU)", launches_cmp, plain_cmp,
                   per_sweep(ROLE_SCAN_WANT, sum(n for _, n in cfg["compare"])))
    compare_elog_like(f"phase {phase} DMBD-{name}", dmbd_state(cpu), y64, card)
    return launches


def phase_life(card):
    return phase_example(card, 22, "life", LIFE, life_data())


def phase_alife(card):
    return phase_example(card, 23, "artificial-life", ALIFE, rotor_data())


def phase_unique_obs(card):
    """Phase 24: DMBD-Lorenz with unique_obs=True (one role model per
    observable, no role transition mask) on phase 3's data and widths: card
    f32 vs CPU f64 over 3 sweeps, 2 launches a sweep of each scan kernel,
    then Elog_like card vs CPU.  Returns the card run's launches."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    state = dmbd_state(DynamicMarkovBlanketDiscovery(
        obs_shape=CFG["obs_shape"], role_dims=CFG["role_dims"],
        hidden_dims=CFG["hidden_dims"], unique_obs=True, parallel_scan=True,
        generator=torch.Generator().manual_seed(CFG["seed"]), dtype=torch.float64,
        device="cpu"))
    y64 = lorenz_data(torch.float64, "cpu")
    n = CFG["compare_sweeps"]
    t0 = time.perf_counter()
    gpu, launches, plain, cpu = compare_card_cpu(
        f"phase 24 DMBD-Lorenz unique_obs=True T={CFG['T']} batch={CFG['batch']}",
        dmbd_from_state, state, (y64,), n, card)
    print(f"  card and CPU runs {time.perf_counter() - t0:.3f} s")
    check_launches("DMBD unique_obs", launches, plain, per_sweep(SCAN_PAIR_WANT, n))
    if gpu.obs_model.batch_shape != (CFG["obs_shape"][0],) or \
            gpu.obs_model.transition_mask is not None:
        fail("DMBD unique_obs: the role model is not one per observable without a mask")
    compare_elog_like("phase 24 DMBD unique_obs", dmbd_state(cpu), y64, card)
    return launches


def gmm_data():
    """benchmarks/core_models_bench.py:gmm_data at GMM_CORE: well separated
    Gaussian clusters, (n, d) float32 values held in float64."""
    c = GMM_CORE
    rs = np.random.RandomState(c["data_seed"])
    mus = rs.randn(c["nc"], c["d"]) * 4
    z = rs.randint(0, c["nc"], c["n"])
    X = (mus[z] + rs.randn(c["n"], c["d"])).astype(np.float32)
    return torch.from_numpy(X.astype(np.float64))


def gmm_state0(seed, X64):
    from pyvbmp_tpu_torch.models import GaussianMixtureModel
    from pyvbmp_tpu_torch.utils.convert import gmm_state

    g = torch.Generator().manual_seed(seed)
    m = GaussianMixtureModel(GMM_CORE["nc"], GMM_CORE["d"], generator=g, dtype=torch.float64,
                             device="cpu")
    m.initialize(X64, generator=g)
    return gmm_state(m)


def phase_gmm(card):
    """Phase 25: GMM-core, GaussianMixtureModel(16, 8) on n=200000 points
    in float32 on the card: initialize, then 10 iterations after a warm-up
    (iterations/s; the ELBO finite, ending above where it started; no
    kernel and no plain scan), then card f32 vs CPU f64 over 3 iterations
    from one numpy state.  Returns the timed run's launches."""
    from pyvbmp_tpu_torch.utils.convert import gmm_from_state

    c = GMM_CORE
    X64 = gmm_data()
    X = X64.to("cuda", torch.float32)
    state = gmm_state0(c["seed"], X64)
    gmm_from_state(state, "cuda", torch.float32).update(X, iters=1)
    model = gmm_from_state(state, "cuda", torch.float32)
    dt, launches, plain = drive(model, c["iters"], X)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 25 GMM-core n={c['n']} nc={c['nc']} d={c['d']} (NIW components) "
          f"{c['iters']} iterations: {c['iters'] / dt:.3f} it/s ({dt:.3f} s); card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("GMM-core: ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail("GMM-core: ELBO ended below where it started")
    check_launches("GMM-core", launches, plain, {k: 0 for k in launches})
    if tuple(model.p.shape) != (c["n"], c["nc"]):
        fail(f"GMM-core: p has shape {tuple(model.p.shape)}")
    compare_card_cpu("phase 25 GMM-core", gmm_from_state, gmm_state0(c["seed"] + 1, X64),
                     (X64,), c["compare_iters"], card)
    return launches


def tensor_hmm_states(seed):
    """(label, numpy state) of the three tensor-state HMMs at HMM_CORE's
    widths, built on the CPU in float64 from ``seed``."""
    from pyvbmp_tpu_torch import models
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.utils.convert import tensor_hmm_state

    d = HMM_CORE["d"]
    kw = dict(dtype=torch.float64, device="cpu")

    def obs(g):
        return NormalInverseWishart.create((d,), (2, 4), generator=g, dtype=torch.float64)

    builds = (
        ("Tensor_HMM NIW (4,) batch (2, 4), state (2, 4)",
         lambda g: models.Tensor_HMM(obs(g), (2, 4), generator=g, **kw)),
        ("HHMM NIW (4,) batch (2, 4), event_dim=2",
         lambda g: models.HHMM(obs(g), event_dim=2, generator=g, **kw)),
        ("Factorial_HMM(3, (2,), (4,))",
         lambda g: models.Factorial_HMM(3, (2,), (d,), generator=g, **kw)),
    )
    return [(label, tensor_hmm_state(build(torch.Generator().manual_seed(seed))))
            for label, build in builds]


def compare_outputs(label, gpu, cpu, outputs, card):
    """Each named output (a method of the models, or an attribute) on the
    card against the CPU: within REL_TOL of the CPU's largest entry."""
    def value(m, name):
        v = getattr(m, name)
        return (v() if callable(v) else v).double().cpu()

    errs = {name: rel_err(value(gpu, name), value(cpu, name))[0] for name in outputs}
    print(f"  {label} card f32 vs CPU f64: max rel dev "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; card {card}")
    if not max(errs.values()) <= REL_TOL:
        fail(f"{label}: card and CPU differ ({errs})")


def phase_tensor_hmm(card):
    """Phase 26: Tensor_HMM, HHMM and Factorial_HMM on the HMM-core data in
    float32 on the card: 10 sweeps after a warm-up (sweeps/s; the ELBO
    finite and ending above where it started; no kernel, no plain scan: the
    smoother is sequential, as in the JAX package), then 3 sweeps card f32
    vs CPU f64 from one numpy state (ELBO, p, KLqprior)."""
    from pyvbmp_tpu_torch.utils.convert import tensor_hmm_from_state

    c = TENSOR_HMM
    y64 = hmm_data()
    y = y64.to("cuda", torch.float32)
    for (label, state), (_, state_cmp) in zip(tensor_hmm_states(c["seed"]),
                                              tensor_hmm_states(c["seed"] + 1)):
        tensor_hmm_from_state(state, "cuda", torch.float32).update(y, iters=1)
        model = tensor_hmm_from_state(state, "cuda", torch.float32)
        dt, launches, plain = drive(model, c["sweeps"], y)
        elbo = np.asarray(model.ELBO_save, np.float64)
        print(f"phase 26 {label} T={HMM_CORE['T']} batch={HMM_CORE['batch']} d={HMM_CORE['d']} "
              f"{c['sweeps']} sweeps: {c['sweeps'] / dt:.3f} sweeps/s ({dt:.3f} s); card {card}")
        print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
        if not np.isfinite(elbo).all():
            fail(f"{label}: ELBO not finite")
        if not elbo[-1] > elbo[0]:
            fail(f"{label}: ELBO ended below where it started")
        check_launches(label, launches, plain, {k: 0 for k in launches})
        if tuple(model.p.shape) != (HMM_CORE["T"], HMM_CORE["batch"]) + model.event_shape:
            fail(f"{label}: p has shape {tuple(model.p.shape)}")
        gpu, _, _, cpu = compare_card_cpu(f"phase 26 {label}", tensor_hmm_from_state,
                                          state_cmp, (y64,), c["compare_sweeps"], card)
        compare_outputs(f"phase 26 {label}", gpu, cpu, ("p", "KLqprior"), card)


def gmm_vector_state0(seed, X64):
    from pyvbmp_tpu_torch.dists import GMM_vector
    from pyvbmp_tpu_torch.utils.convert import gmm_state

    g = torch.Generator().manual_seed(seed)
    m = GMM_vector(GMM_CORE["nc"], GMM_CORE["d"], generator=g, dtype=torch.float64, device="cpu")
    m.initialize(X64, generator=g)
    return gmm_state(m)


def phase_gmm_vector(card):
    """Phase 27: GMM_vector(16, 8) (vector-format NIW components) on GMM-core's
    data as (n, 8, 1) columns in float32 on the card: initialize, 10
    iterations after a warm-up (it/s; the ELBO finite and ending above
    where it started; no kernel), then card f32 vs CPU f64 over 3
    iterations (ELBO and KLqprior; p's deviation printed)."""
    from pyvbmp_tpu_torch.utils.convert import gmm_from_state

    c = GMM_CORE
    X64 = gmm_data()[..., None]
    X = X64.to("cuda", torch.float32)
    state = gmm_vector_state0(c["seed"], X64)
    gmm_from_state(state, "cuda", torch.float32).update(X, iters=1)
    model = gmm_from_state(state, "cuda", torch.float32)
    dt, launches, plain = drive(model, c["iters"], X)
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 27 GMM_vector n={c['n']} nc={c['nc']} d={c['d']} (NIW vector-format "
          f"components) {c['iters']} iterations: {c['iters'] / dt:.3f} it/s ({dt:.3f} s); "
          f"card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("GMM_vector: ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail("GMM_vector: ELBO ended below where it started")
    check_launches("GMM_vector", launches, plain, {k: 0 for k in launches})
    gpu, _, _, cpu = compare_card_cpu("phase 27 GMM_vector", gmm_from_state,
                                      gmm_vector_state0(c["seed"] + 1, X64), (X64,),
                                      c["compare_iters"], card)
    compare_outputs("phase 27 GMM_vector", gpu, cpu, ("KLqprior",), card)
    # the assignments differ most at the few points between two components
    # (~1e-4 of p there); reported, not held to REL_TOL
    dev = rel_err(gpu.p.double().cpu(), cpu.p)[0]
    agree = (gpu.p.argmax(-1).cpu() == cpu.p.argmax(-1)).double().mean().item()
    print(f"  phase 27 GMM_vector p: max dev {dev:.3e}, argmax agree on {agree:.6f}")


def lds_core_data():
    """benchmarks/core_models_bench.py:lds_data at LDS_CORE: a damped
    rotation (0.2 rad a step) in 2 dims seen through a random 4 x 2 map,
    (T, batch, 4) float32 values held in float64."""
    c = LDS_CORE
    rs = np.random.RandomState(c["data_seed"])
    th = 0.2
    A = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * 0.98
    C = rs.randn(c["obs"], c["hidden"])
    x = rs.randn(c["batch"], c["hidden"])
    ys = []
    for _ in range(c["T"]):
        x = x @ A.T + 0.05 * rs.randn(c["batch"], c["hidden"])
        ys.append(x @ C.T + 0.1 * rs.randn(c["batch"], c["obs"]))
    return torch.from_numpy(np.stack(ys).astype(np.float32).astype(np.float64))


def lds_core_state0(seed):
    from pyvbmp_tpu_torch.models import LinearDynamicalSystems
    from pyvbmp_tpu_torch.transforms import MatrixNormalGamma
    from pyvbmp_tpu_torch.utils.convert import lds_state

    c = LDS_CORE
    g = torch.Generator().manual_seed(seed)
    obs = MatrixNormalGamma.create((c["obs"], c["hidden"]), pad_X=True, generator=g,
                                   dtype=torch.float64)
    return lds_state(LinearDynamicalSystems(
        (c["obs"],), c["hidden"], obs_model=obs, parallel_scan=True, generator=g,
        dtype=torch.float64, device="cpu"))


LANE_WANT = {"logsemiring_scan": 0, "kalman_plane_scan": 0, "kalman_lane_scan": 2,
             "logsemiring_scan_folded": 0, "kalman_plane_scan_folded": 0,
             "kalman_lane_scan_folded": 0, "weighted_outer": 0}


def phase_lds_obs(card):
    """Phase 28: LDS-core with a caller's observation model,
    MatrixNormalGamma.create((4, 2), pad_X=True), and the scan smoother, in
    float32 on the card: 10 sweeps (one update each) after a warm-up
    (sweeps/s; the ELBO finite and ending above where it started; 2 lane
    Kalman launches a sweep at (200, 2, 100), no other kernel, no plain
    scan), then card f32 vs CPU f64 over 3 sweeps.  Returns the timed
    run's launches."""
    from pyvbmp_tpu_torch.utils.convert import lds_from_state

    c = LDS_CORE
    y64 = lds_core_data()
    y = y64.to("cuda", torch.float32)
    state = lds_core_state0(c["seed"])
    lds_from_state(state, "cuda", torch.float32).update(y)
    model = lds_from_state(state, "cuda", torch.float32)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(c["sweeps"]):
        model.update(y)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    elbo = np.asarray(model.ELBO_save, np.float64)
    print(f"phase 28 LDS-core T={c['T']} batch={c['batch']} obs {c['obs']} hidden {c['hidden']}, "
          f"obs_model MatrixNormalGamma (4, 2) pad_X=True, parallel_scan=True, {c['sweeps']} "
          f"sweeps: {c['sweeps'] / dt:.3f} sweeps/s ({dt:.3f} s); card {card}")
    print(f"  ELBO {elbo[0]:.6e} -> {elbo[-1]:.6e}; steps {np.diff(elbo).tolist()}")
    if not np.isfinite(elbo).all():
        fail("LDS-core: ELBO not finite")
    if not elbo[-1] > elbo[0]:
        fail("LDS-core: ELBO ended below where it started")
    check_launches("LDS-core pad_X obs_model", launches, plain, per_sweep(LANE_WANT, c["sweeps"]))
    compare_card_cpu("phase 28 LDS-core pad_X obs_model", lds_from_state,
                     lds_core_state0(c["seed"] + 1), (y64,), c["compare_sweeps"], card)
    return launches


def two_moons():
    """examples/two_moons.py:two_moons at full size: (n, 2) float32 values
    held in float64, and the labels."""
    rs = np.random.RandomState(0)
    n = MOONS["n"]
    t = np.pi * rs.rand(n // 2)
    outer = np.stack([np.cos(t), np.sin(t)], -1)
    inner = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
    X = np.concatenate([outer, inner]) + 0.08 * rs.randn(n, 2)
    y = np.concatenate([np.zeros(n // 2, int), np.ones(n // 2, int)])
    return torch.from_numpy(X.astype(np.float32).astype(np.float64)), y


class MoonsFit:
    """examples/two_moons.py's loop: a dMixtureofLinearTransforms layer and
    an MNLR head, the head's backward message fused into the layer's
    forward one (``combiner``).  ``update(pX, Y, iters)`` runs ``iters``
    iterations; ``predict(pX)`` the head's class probabilities."""

    def __init__(self, states, device, dtype):
        from pyvbmp_tpu_torch.utils.convert import dmixlt_from_state, mnlr_from_state

        self.layer = dmixlt_from_state(states[0], device, dtype)
        self.head = mnlr_from_state(states[1], device, dtype)

    def update(self, pX, Y, iters=1):
        for _ in range(iters):
            pH = self.layer.forward(pX)
            self.head.update(pH, Y, iters=1)
            pH_msg, _ = self.head.backward(Y)
            self.layer.update(pX, pH.combiner(pH_msg), iters=1)

    def predict(self, pX):
        return self.head.forward(self.layer.forward(pX))


def moons_inputs(X64, y, device, dtype):
    """pX (the inputs as messages with covariance 1e-4 I) and one-hot Y."""
    from pyvbmp_tpu_torch.dists import MultivariateNormal_vector_format

    X = X64.to(device, dtype)
    eye = torch.eye(2, dtype=dtype, device=device)
    pX = MultivariateNormal_vector_format(mu=X[..., None],
                                          Sigma=1e-4 * eye.expand(len(X), 2, 2))
    return pX, torch.eye(2, dtype=dtype, device=device)[torch.as_tensor(y, device=device)]


def moons_states(seed):
    from pyvbmp_tpu_torch.transforms import (
        MultiNomialLogisticRegression, dMixtureofLinearTransforms,
    )
    from pyvbmp_tpu_torch.utils.convert import dmixlt_state, mnlr_state

    c = MOONS
    g = torch.Generator().manual_seed(seed)
    kw = dict(pad_X=True, generator=g, dtype=torch.float64, device="cpu")
    return (dmixlt_state(dMixtureofLinearTransforms(c["hidden"], 2, c["experts"], **kw)),
            mnlr_state(MultiNomialLogisticRegression(2, c["hidden"], **kw)))


def phase_moons(card):
    """Phase 29: examples/two_moons.py's loop at full size (n=400, 20
    iterations) in float32 on the card: seconds, test accuracy >= 0.80, no
    kernel launched; then the same state and data in float64 on the CPU:
    the argmax predictions agree on >= 99% of the points."""
    c = MOONS
    X64, y = two_moons()
    states = moons_states(c["seed"])
    pX, Y = moons_inputs(X64, y, "cuda", torch.float32)
    fit = MoonsFit(states, "cuda", torch.float32)
    reset_counts()
    t0 = time.perf_counter()
    fit.update(pX, Y, iters=c["iters"])
    pred = fit.predict(pX).argmax(-1).cpu().numpy()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    acc = (pred == y).mean()
    pX64, Y64 = moons_inputs(X64, y, "cpu", torch.float64)
    cpu = MoonsFit(states, "cpu", torch.float64)
    cpu.update(pX64, Y64, iters=c["iters"])
    pred_cpu = cpu.predict(pX64).argmax(-1).numpy()
    agree = (pred == pred_cpu).mean()
    print(f"phase 29 two moons n={c['n']} hidden {c['hidden']} {c['experts']} experts, "
          f"{c['iters']} iterations: {dt:.3f} s ({c['iters'] / dt:.3f} it/s); accuracy "
          f"{acc:.4f} (CPU f64 {(pred_cpu == y).mean():.4f}); card and CPU argmax agree on "
          f"{agree:.4f}; card {card}")
    if not acc >= c["min_acc"]:
        fail(f"two moons: accuracy {acc:.4f} below {c['min_acc']}")
    if not agree >= c["min_agree"]:
        fail(f"two moons: card and CPU predictions agree on only {agree:.4f}")
    check_launches("two moons", launches, plain, {k: 0 for k in launches})


def node_cases(B):
    """name -> (build on the CPU in float64 from a generator at batch
    (B,), one update from fixed statistics and the outputs to compare) for
    every node ported alongside the tensor HMMs.  ``ops(node, A)`` gets the
    node and A, which makes a numpy array a tensor like the node's."""
    from pyvbmp_tpu_torch import dists as D, transforms as Tr

    def spd(rs, B, d, n=12):
        W = rs.randn(B, d, n)
        return W @ np.swapaxes(W, -1, -2)

    def wishart():
        def build(cls):
            return lambda g: getattr(D, cls).create(
                (4, 4), (B,), scale=0.7, **({} if cls == "Wishart" else dict(generator=g)),
                dtype=torch.float64)

        def ops(n, A):
            rs = np.random.RandomState(1)
            n1 = n.ss_update(A(spd(rs, B, 4)), A(rs.rand(B) * 20 + 2), lr=0.8)
            out = {k: getattr(n1, k)() for k in (
                "mean", "ESigma", "invEinvSigma", "ElogdetinvSigma", "logdetEinvSigma",
                "KLqprior", "logZ")}
            out["invU"] = n1.invU
            return out

        return {cls: (build(cls), ops) for cls in
                ("Wishart", "WishartEigh", "WishartUnitDet", "WishartUnitTrace")}

    def diag():
        def ops(n, A):
            rs = np.random.RandomState(2)
            n1 = n.ss_update(A(rs.rand(B, 4) * 5), A(rs.rand(B, 1) * 10 + 1), lr=0.9)
            return {k: getattr(n1, k)() for k in ("ESigma", "ElogdetinvSigma",
                                                  "logdetEinvSigma", "invEinvSigma",
                                                  "KLqprior", "logZ")}

        return {cls: (lambda g, cls=cls: getattr(D, cls).create(
            (4,), (B,), scale=0.7, generator=g, dtype=torch.float64), ops)
            for cls in ("DiagonalWishart", "DiagonalWishartUnitTrace")}

    def mng():
        def ops(n, A):
            rs = np.random.RandomState(3)
            X = rs.randn(20, B, 3, 1)
            Y = rs.randn(4, 3) @ X * 0.7 + 0.3 * rs.randn(20, B, 4, 1) + 0.5
            n1 = n.raw_update(A(X), A(Y), p=A(rs.rand(20, B)), lr=0.9)
            M = A(spd(rs, B, 4))
            out = {k: getattr(n1, k)() for k in ("EXTinvUX", "EXTX", "EXXT", "ElogdetinvU",
                                                 "ESigma", "invEinvSigma", "KLqprior")}
            out.update(EXTAX=n1.EXTAX(M), like=n1.Elog_like(A(X), A(Y)))
            return out

        return {f"{cls} pad_X": (lambda g, cls=cls: getattr(Tr, cls).create(
            (4, 3), (B,), pad_X=True, generator=g, dtype=torch.float64), ops)
            for cls in ("MatrixNormalGamma", "MatrixNormalGamma_UnitTrace")}

    def dirichlets():
        def hd_ops(n, A):
            rs = np.random.RandomState(4)
            X = rs.dirichlet(np.ones(16), (20, B)).reshape(20, B, 4, 4)
            n1 = n.raw_update(A(X * 50), p=A(rs.rand(20, B)), lr=0.8)
            return dict(mean=n1.mean(), loggeomean=n1.loggeomean(), KLqprior=n1.KLqprior())

        def tr_ops(n, A):
            rs = np.random.RandomState(5)
            n1 = n.ss_update(A(rs.rand(B, 4, 4, 4, 4) * 400), lr=0.8)
            logits = A(rs.randn(B, 4, 4))
            return dict(loggeomean=n1.loggeomean(), KLqprior=n1.KLqprior(),
                        log_forward=n1.log_forward(logits))

        def htr_ops(n, A):
            rs = np.random.RandomState(6)
            n1 = n.ss_update(A(rs.rand(B, 4, 4, 4, 4) * 400), lr=0.8)
            return dict(mean=n1.mean(), loggeomean=n1.loggeomean(), KLqprior=n1.KLqprior())

        kw = dict(dtype=torch.float64)
        return {
            "Hierarchical_Dirichlet": (lambda g: D.Hierarchical_Dirichlet.create(
                (4, 4), (B,), generator=g, **kw), hd_ops),
            "Transition": (lambda g: Tr.Transition.create((4, 4), (B,), generator=g, **kw),
                           tr_ops),
            "HierarchicalTransition": (lambda g: Tr.HierarchicalTransition.create(
                (4, 4), (B,), generator=g, **kw), htr_ops),
        }

    def messages():
        def mvn_vf(g):
            rs = np.random.RandomState(7)
            return D.MultivariateNormal_vector_format(
                mu=torch.tensor(rs.randn(B, 4, 1)), Sigma=torch.tensor(spd(rs, B, 4)))

        def mvn(g):
            rs = np.random.RandomState(8)
            return D.MultivariateNormal(mu=torch.tensor(rs.randn(B, 4)),
                                        Sigma=torch.tensor(spd(rs, B, 4)))

        def vf_ops(n, A):
            rs = np.random.RandomState(9)
            X = rs.randn(20, B, 4, 1) * 2 + 1
            n1 = n.raw_update(A(X), p=A(rs.rand(20, B)))
            c = n1.combiner(D.MultivariateNormal_vector_format(
                invSigma=A(spd(rs, B, 4)), invSigmamu=A(rs.randn(B, 4, 1))))
            return dict(EXXT=n1.EXXT(), Res=n1.Res(), like=n1.Elog_like(A(X)), c_mean=c.mean())

        def mat_ops(n, A):
            rs = np.random.RandomState(10)
            X = rs.randn(20, B, 4) * 2 - 1
            n1 = n.raw_update(A(X), p=A(rs.rand(20, B)))
            return dict(EXXT=n1.EXXT(), EinvSigmamu=n1.EinvSigmamu(), like=n1.Elog_like(A(X)))

        return {"MultivariateNormal_vector_format": (mvn_vf, vf_ops),
                "MultivariateNormal": (mvn, mat_ops)}

    def niw():
        def ops(n, A):
            rs = np.random.RandomState(11)
            X = rs.randn(20, B, 8, 1) * 1.5 + 2
            n1 = n.raw_update(A(X), p=A(rs.rand(20, B)), lr=0.8)
            return dict(EXXT=n1.EXXT(), EinvSigma=n1.EinvSigma(),
                        ElogdetinvSigma=n1.ElogdetinvSigma(), EXTinvUX=n1.EXTinvUX(),
                        KLqprior=n1.KLqprior(), like=n1.Elog_like(A(X)))

        return {cls: (lambda g, cls=cls: getattr(D, cls).create(
            (8, 1), (B,), scale=0.8, dtype=torch.float64), ops)
            for cls in ("NormalInverseWishart_vector_format",
                        "NormalInverseWishart_vector_format_invSigma")}

    return {**wishart(), **diag(), **mng(), **dirichlets(), **messages(), **niw()}


def node_suite(batch=NODE_BATCH, card=""):
    """Every node ported alongside the tensor HMMs at batch (``batch``,):
    one build (CPU, float64), then one update from fixed statistics and the
    KL and expectations in float32 on the card and in float64 on the CPU.
    Returns name -> the worst relative deviation (each output against its
    largest CPU entry)."""
    worst = {}
    for name, (build, ops) in node_cases(batch).items():
        n64 = build(torch.Generator().manual_seed(0))
        n32 = n64.to("cuda", torch.float32)
        out = ops(n32, lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda"))
        ref = ops(n64, lambda a: torch.as_tensor(a, dtype=torch.float64))
        # an output held at 0 by construction (WishartUnitDet's <logdet
        # Sigma^-1>: its 4 Newton steps leave ~2e-6 in float64) is held to
        # REL_TOL absolute
        errs = {k: rel_err(out[k].double().cpu(), ref[k])[int(ref[k].abs().max() < 1e-3)]
                for k in ref}
        worst[name] = max(errs.values())
        top = max(errs, key=errs.get)
        print(f"  phase 30 {name} batch ({batch},): worst output {top} {errs[top]:.3e}; "
              f"card {card}")
    return worst


def phase_nodes(card):
    """Phase 30: node_suite at batch (1000,): each new node's update, KL and
    expectations, card f32 vs CPU f64 within REL_TOL (WishartEigh and its
    variants on cuSOLVER's batched eigh)."""
    t0 = time.perf_counter()
    reset_counts()
    worst = node_suite(NODE_BATCH, card)
    launches, plain = read_counts()
    print(f"phase 30 {len(worst)} nodes at batch ({NODE_BATCH},): worst {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)}); {time.perf_counter() - t0:.3f} s; card {card}")
    check_launches("node suite", launches, plain, {k: 0 for k in launches})
    bad = {k: v for k, v in worst.items() if not v <= REL_TOL}
    if bad:
        fail(f"node suite: card and CPU differ: {bad}")


def trace_sweeps(card, label, model, args, fit, fold, n=3):
    """Per sweep of ``model.update(*args, iters=n, **fit)`` under the time
    fold ``fold``: the untraced wall clock (median of 5 runs), then one
    traced run: device busy time (the union of kernel intervals), kernel
    time by kind and the three largest other kernels by name, and host and
    device event counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with time_fold(fold):
        model.update(*args, iters=1, **fit)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.update(*args, iters=n, **fit)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.update(*args, iters=n, **fit)
            torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"trace {label}: the profiler saw no device events; card {card}")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    kinds, others = {}, {}
    for e in kernels:
        kind = next((k for k in ("kalman_plane_scan_kernel", "kalman_plane_fixup_kernel",
                                 "logsemiring", "kalman_lane_scan_kernel",
                                 "kalman_lane_fixup_kernel", "weighted_outer")
                     if k in e.name), "other")
        span = e.time_range.end - e.time_range.start
        kinds[kind] = kinds.get(kind, 0.0) + span
        if kind == "other":
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + span
    by_kind = ", ".join(f"{k} {v / n / 1e3:.3f}" for k, v in sorted(kinds.items()))
    top = sorted(others.items(), key=lambda kv: -kv[1])[:3]
    by_kind += "; largest other: " + ", ".join(f"{k} {v / n / 1e3:.3f}" for k, v in top)
    print(f"trace {label}, time fold {fold}, per sweep: wall {np.median(walls):.3f} ms "
          f"(median of 5 x {n} sweeps, range {min(walls):.3f}-{max(walls):.3f}); device "
          f"busy {busy / n / 1e3:.3f} ms; kernels ms: {by_kind}; device events "
          f"{len(kernels) / n:.0f}, host events {(len(events) - len(kernels)) / n:.0f}; "
          f"card {card}")


def phase_trace(card):
    from pyvbmp_tpu_torch.utils.convert import (
        arhmm_from_state, dhmm_from_state, dmbd_from_state, dmbd_state, mixlds_from_state,
    )

    y = (lorenz_data(torch.float32, "cuda"),)
    state = dmbd_state(build_model(torch.Generator().manual_seed(CFG["seed"])))
    trace_sweeps(card, "DMBD-Lorenz", dmbd_from_state(state, "cuda", torch.float32), y, {},
                 "0")
    y = (flocking_data(torch.float32, "cuda"),)
    state = flocking_state(FLOCK["seed"])
    for fold in ("0", "auto"):
        trace_sweeps(card, "DMBD-Flocking", dmbd_from_state(state, "cuda", torch.float32), y,
                     dict(latent_iters=1, lr=1.0), fold)
    y = (torch.from_numpy(mixlds_data()).cuda(),)
    state = mixlds_state0(MIX["seed"])
    for fold in ("0", "1"):
        trace_sweeps(card, "MixLDS", mixlds_from_state(state, "cuda", torch.float32), y, {},
                     fold)
    y = (nlds_data()[0].to("cuda", torch.float32),)
    trace_sweeps(card, "NLDS", nlds_model(torch.Generator().manual_seed(NLDS_EX["seed"]),
                                          torch.float32, "cuda"), y, {}, "0")
    data = to_card((dhmm_inputs(), hmm_data()))
    trace_sweeps(card, "dHMM", dhmm_from_state(dhmm_state0(DHMM_CORE["seed"]), "cuda",
                                               torch.float32), data, {}, "0")
    data = to_card((ar_pairs(HMM_CORE["T"], HMM_CORE["batch"], ARHMM_CFG["data_seed"]),))
    trace_sweeps(card, "ARHMM", arhmm_from_state(arhmm_state0(ARHMM_CFG["seed"]), "cuda",
                                                 torch.float32), data, {}, "0")
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import gmm_from_state

    for name, cfg, y64 in (("life", LIFE, life_data()), ("artificial-life", ALIFE,
                                                          rotor_data())):
        model = DynamicMarkovBlanketDiscovery(
            tuple(y64.shape[-2:]), cfg["role_dims"], cfg["hidden_dims"],
            regression_dim=cfg["regression_dim"], number_of_objects=cfg["number_of_objects"],
            parallel_scan=True, generator=torch.Generator().manual_seed(cfg["seed"]),
            dtype=torch.float32, device="cuda")
        model.obs_model.ptemp = cfg["schedule"][-1][0]
        trace_sweeps(card, f"DMBD-{name}", model, (y64.to("cuda", torch.float32),),
                     dict(lr=cfg["lr"]), "0")
    X64 = gmm_data()
    trace_sweeps(card, "GMM-core", gmm_from_state(gmm_state0(GMM_CORE["seed"], X64), "cuda",
                                                  torch.float32),
                 (X64.to("cuda", torch.float32),), {}, "0")
    from pyvbmp_tpu_torch.utils.convert import lds_from_state, tensor_hmm_from_state

    y = (hmm_data().to("cuda", torch.float32),)
    for _, state in tensor_hmm_states(TENSOR_HMM["seed"]):
        trace_sweeps(card, state["kind"], tensor_hmm_from_state(state, "cuda", torch.float32),
                     y, {}, "0")
    X64 = X64[..., None]
    trace_sweeps(card, "GMM_vector", gmm_from_state(gmm_vector_state0(GMM_CORE["seed"], X64),
                                                    "cuda", torch.float32),
                 (X64.to("cuda", torch.float32),), {}, "0")
    trace_sweeps(card, "LDS-core pad_X obs_model",
                 lds_from_state(lds_core_state0(LDS_CORE["seed"]), "cuda", torch.float32),
                 (lds_core_data().to("cuda", torch.float32),), {}, "0")
    X64, y = two_moons()
    trace_sweeps(card, "two moons", MoonsFit(moons_states(MOONS["seed"]), "cuda", torch.float32),
                 moons_inputs(X64, y, "cuda", torch.float32), {}, "0")


def record_line(name, source, replaces, launches, abs_err, r, library_ms=None):
    bound = r["bound"]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=abs_err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a second csrc directory to time beside ours")
    ap.add_argument("--trace", action="store_true", help="profile the DMBD sweeps")
    args = ap.parse_args()
    t_start = time.perf_counter()
    seconds = {}

    def run(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    card, base = run("1", phase_guard, args.baseline)
    record = run("2", phase_kernels, card, base)
    launches_dmbd = run("3", phase_dmbd, card)
    run("4", phase_compare, card)
    launches_mix = run("5", phase_mixlds, card)
    run("6", phase_mixlds_compare, card)
    scatter = run("7", phase_scatter, card, base)
    data = digits()
    state, elbo, labels, launches_mnlr = run("8", phase_mnlr, card, data)
    run("9", phase_mnlr_compare, card, data, state, elbo, labels)
    run("10", phase_other_arms, card, data)
    folded, one_pass = run("11", phase_fold_kernels, card, base)
    launches_flock = run("12", phase_flocking, card)
    run("13", phase_flocking_compare, card)
    launches_mix_folded = run("14", phase_mixlds_folded, card)
    launches_hmm = run("15", phase_hmm, card)
    launches_cradle = run("16", phase_cradle, card)
    launches_flame = run("17", phase_flame, card)
    run("18", phase_sequential, card)
    launches_nlds = run("19", phase_nlds, card)
    launches_dhmm = run("20", phase_dhmm, card)
    launches_arhmm = run("21", phase_arhmm, card)
    launches_life = run("22", phase_life, card)
    launches_alife = run("23", phase_alife, card)
    launches_unique = run("24", phase_unique_obs, card)
    run("25", phase_gmm, card)
    run("26", phase_tensor_hmm, card)
    run("27", phase_gmm_vector, card)
    launches_lds_obs = run("28", phase_lds_obs, card)
    run("29", phase_moons, card)
    run("30", phase_nodes, card)
    if args.trace:
        run("trace", phase_trace, card)
    if base is not None:
        run("turns", phase_mixlds_turns, card, base)
    from pyvbmp_tpu_torch.ops import scan, weighted_scatter as ws

    kernels = []
    for s in scan.SCANS:
        kernels.append(record_line(
            s.name, s.source, s.replaces,
            launches_dmbd[s.name] + launches_mix[s.name] + launches_flock["0"][s.name]
            + launches_hmm[s.name] + launches_cradle[s.name] + launches_flame[s.name]
            + launches_nlds[s.name] + launches_dhmm[s.name] + launches_arhmm[s.name]
            + launches_life[s.name] + launches_alife[s.name] + launches_unique[s.name]
            + launches_lds_obs[s.name],
            max(record[s.name]["abs"], one_pass[s.name]), record[s.name]))
    for s in scan.FOLDED_SCANS:
        kernels.append(record_line(
            s.name, s.source, s.replaces,
            launches_flock["auto"][s.name] + launches_mix_folded[s.name],
            folded[s.name]["abs"], folded[s.name]))
    w = ws.WEIGHTED_OUTER
    kernels.append(record_line(w.name, w.source, w.replaces, launches_mnlr[w.name],
                               scatter["abs"], scatter, scatter["library_ms"]))
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s (seconds by phase: "
          f"{seconds}); card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
