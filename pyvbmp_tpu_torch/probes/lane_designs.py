#!/usr/bin/env python3
"""Designs of the lane Kalman scan timed in turns against its kernel, on one
NVIDIA GPU.

    python3 pyvbmp_tpu_torch/probes/lane_designs.py

Builds, beside the kernel of csrc/kalman_lane_scan.cu:
- ``split``: one lane's combine over a lead and a follower thread
  (kalman_lane_designs.cu), for the one-pass scan and phase 1 of the fold;
- ``lookback``: the time fold in one launch with a decoupled look-back
  (kalman_lane_designs.cu);
- ``lane4``: the kernel with its per-lane copies (4 bytes a component,
  each thread its own lane) wherever it would share 16-byte chunks over
  the warp, and ``lane4_floor`` the same without the combine;
- ``floor``: the kernel with the combine replaced by a copy of the element
  (its loads and stores alone);
- ``comb_noload``: the kernel without its loads from device memory (its
  combine and stores alone; it combines whatever the ring holds).
The kernel and the first two designs are held to the plain scan at 1e-4
(max relative error, as chip_smoke.py:rel_err) at H = 1, 2, 3, N = 1, 33,
36, 4000 and walks of 1, 2, 7, 9, 17 and 100 rows, folded into 2, 4 and 8
chunks wherever that leaves none empty.  Then every design is timed at T=100, N=4000, H = 1, 2, 3
(and H=2 at N=16000), forward and reverse, one pass and folded (Cp=4,
L=25), by chip_smoke.py:scan_launches (a CUDA graph of 50 launches, each on
its own copy of the inputs and outputs, out of the L2) in turns: the
designs in order, then in reverse order, each the mean of its two turns.
Prints the compiler's register, stack and spill report for each design.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pyvbmp_tpu_torch.ops import _cuda, scan  # noqa: E402

HERE = Path(__file__).resolve().parent
KERNEL = ROOT / "pyvbmp_tpu_torch" / "csrc" / "kalman_lane_scan.cu"
BUILD = ROOT / "pyvbmp_tpu_torch" / "_build" / "probes"
# the kernel's text and what each variant puts in its place
COMBINE = "  return kReverse ? combine<H>(e, carry) : combine<H>(carry, e);"
COPY = "  Potential<H> o = e; o.w += carry.w; return o;"
LOAD = "        if (i < steps) rd.copy(slot<H>(ring, i));"
SHARED = "  if (N % kLanes == 0 && aligned16(src) && aligned16(dst) && aligned16(tot))"
VARIANTS = {"floor": [(COMBINE, COPY)], "comb_noload": [(LOAD, "")],
            "lane4": [(SHARED, "  if (false)")],
            "lane4_floor": [(SHARED, "  if (false)"), (COMBINE, COPY)]}
EDGE_T = (1, 2, 7, 9, 17, 100)
EDGE_N = (1, 33, 36, 4000)


def build(tag, src):
    """``src`` built into a shared library of its own; prints the
    compiler's report for each kernel."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"lane_{tag}.so"
    done = subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(so),
                           str(src)], capture_output=True, text=True)
    report = [line.strip() for line in (done.stdout + done.stderr).splitlines()
              if "Compiling entry" in line or "registers" in line or "spill" in line]
    if done.returncode:
        sys.exit(f"build {tag} failed:\n{(done.stdout + done.stderr)[-4000:]}")
    return tag, ctypes.CDLL(str(so)), report


def variant(tag, subs):
    text = KERNEL.read_text()
    for old, new in subs:
        if old not in text:
            sys.exit(f"variant {tag}: the kernel no longer holds {old!r}")
        text = text.replace(old, new)
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / f"kalman_lane_{tag}.cu"
    src.write_text(text)
    return src


def libraries():
    """{design: an object with the kernel's C entry point, kalman_lane_scan_f32}."""
    sources = {"kernel": KERNEL, "designs": HERE / "kalman_lane_designs.cu",
               **{tag: variant(tag, subs) for tag, subs in VARIANTS.items()}}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources, sources.values()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for tag, lib, report in built:
        print(f"ptxas, {tag}:\n  " + "\n  ".join(report))
        lib.kalman_lane_scan_f32.argtypes = [vp] * 18 + [ci] * 7 + [vp]
        lib.kalman_lane_scan_f32.restype = ci
        if tag != "designs":
            libs[tag] = lib
            continue
        lib.kalman_lane_lookback_f32.argtypes = [vp] * 19 + [ci] * 7 + [vp]
        lib.kalman_lane_lookback_f32.restype = ci
        lib.kalman_lane_split_f32.argtypes = [vp] * 18 + [ci] * 7 + [vp]
        lib.kalman_lane_split_f32.restype = ci
        libs["split"] = types.SimpleNamespace(kalman_lane_scan_f32=lib.kalman_lane_split_f32)
        flags = torch.zeros(8 * 4 * 16000 // 32 + 1, dtype=torch.int32, device="cuda")

        def lookback(*a, entry=lib.kalman_lane_lookback_f32, flags=flags):
            return entry(*a[:18], flags.data_ptr(), *a[18:])

        libs["lookback"] = types.SimpleNamespace(kalman_lane_scan_f32=lookback)
    return libs


def launch(lib, leaves, reverse, C):
    """lib's scan of leaves into fresh outputs, folded into C chunks."""
    T, N = leaves[0].shape[0], leaves[0].shape[-1]
    H = leaves[3].shape[1]
    L = -(-T // C)
    out = [torch.empty_like(x) for x in leaves]
    tot = [x.new_empty((C,) + x.shape[1:]) for x in leaves]
    rc = lib.kalman_lane_scan_f32(*(x.data_ptr() for x in leaves), *(o.data_ptr() for o in out),
                                  *(t.data_ptr() for t in tot), T, H, N, C, L,
                                  T - C * L if reverse else 0, int(reverse),
                                  torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        sys.exit(f"launch failed, cudaError {rc}")
    return out


def check(libs):
    s, rs = scan.KALMAN_LANE, np.random.RandomState(0)
    worst = {"kernel": 0.0, "split": 0.0, "lookback": 0.0}
    for H in (1, 2, 3):
        for N in EDGE_N:
            for T in EDGE_T:
                leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                               for a in cs.lane_elems(rs, T, H, N))
                for reverse in (False, True):
                    ref = s.plain(leaves, reverse)
                    for C in (1, 2, 4, 8):
                        L = -(-T // C)
                        if C > 1 and (C > T or C * L - T >= L):
                            continue
                        for tag in ("kernel", "split") + (("lookback",) if C > 1 else ()):
                            out = launch(libs[tag], leaves, reverse, C)
                            err = max(cs.rel_err(o, r)[0] for o, r in zip(out, ref))
                            worst[tag] = max(worst[tag], err)
                            if not err <= cs.REL_TOL:
                                sys.exit(f"{tag} H={H} N={N} T={T} C={C} reverse={reverse}: "
                                         f"max rel err {err:.3e}")
    print("edge grid, max rel err against the plain scan: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def turns(calls):
    """{design: ms}, each the mean of two turns: the designs in order, then
    in reverse order."""
    times = {}
    for tag in list(calls) + list(calls)[::-1]:
        times.setdefault(tag, []).append(cs.graph_ms(calls[tag], cs.SCAN_REPS))
    return {tag: sum(v) / len(v) for tag, v in times.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    libs = libraries()
    check(libs)
    s, rs = scan.KALMAN_LANE, np.random.RandomState(1)
    for H, N in ((2, 4000), (3, 4000), (1, 4000), (2, 16000)):
        leaves = tuple(torch.as_tensor(a, dtype=torch.float32).contiguous().cuda()
                       for a in cs.lane_elems(rs, 100, H, N))
        bound = cs.bound_ms(*cs.scan_work(s.name, 100, H, N))[0]
        for reverse in (False, True):
            for folded, designs in ((False, ("kernel", "lane4", "split", "floor", "lane4_floor",
                                             "comb_noload")),
                                    (True, ("kernel", "lane4", "split", "lookback"))):
                if folded and N != 4000:
                    continue
                launches = cs.scan_launches(s, leaves, reverse, folded)
                ms = turns({tag: launches(libs[tag]) for tag in designs})
                route = "folded Cp=4 L=25" if folded else "one-pass"
                print(f"lane designs H={H} T=100 N={N} {route} "
                      f"{'reverse' if reverse else 'forward'}: "
                      + ", ".join(f"{tag} {t:.4f} ms ({100 * bound / t:.1f}%)"
                                  for tag, t in ms.items())
                      + f"; bound {bound:.4f} ms; card {card}")


if __name__ == "__main__":
    main()
