"""The card's time fold of the plane Kalman scan (``ops/scan.py:plane_plan``)
and the route each ``TIME_FOLD`` value gives a scan on either device.

``plane_plan`` is a pure function of (T, H, N, sms), so these tests plan at
the SM count of an H100 (132) with no card: the benchmark's Flocking latent
chains fold, every chunk but the chain's last holds L >= ``PLANE_FOLD_MIN_L``
rows, and the folded kernels' launch contract holds forward and reverse;
the narrow rungs, wide batches and short chains run one pass.  The route
tests pass a CUDA device to ``Scan.fold_plan`` with the SM count patched,
so they reach no card either.  On the CPU nothing changes under any switch:
the plain routes and their counters are the JAX package's."""
import math

import numpy as np
import pytest
import torch

from pyvbmp_tpu_torch.ops import scan

SMS = 132  # an H100's SMs
CUDA = torch.device("cuda", 0)
# the benchmark's Flocking cells' latent chains (T, H, N) and their plans
FLOCKING = {(1200, 26, 4): (33, 37), (150, 26, 20): (6, 25)}


def chunks(T, plan, reverse):
    """The rows of each chunk of ``scan.fold_args``' launch, by chunk index."""
    a = scan.fold_args(T, None, reverse, plan)
    C, L, offset = a["chunks"], a["L"], a["offset"]
    return [list(range(max(c * L + offset, 0), min((c + 1) * L + offset, T)))
            for c in range(C)]


@pytest.mark.parametrize("shape", sorted(FLOCKING))
@pytest.mark.parametrize("reverse", [False, True])
def test_plane_plan_folds_the_flocking_chains(shape, reverse):
    T, H, N = shape
    plan = scan.plane_plan(T, H, N, SMS)
    assert plan == FLOCKING[shape]
    Cp, L = plan
    assert 2 <= Cp and Cp * N <= SMS and Cp * Cp <= 5 * T // 4
    rows = chunks(T, plan, reverse)
    assert [t for c in rows for t in c] == list(range(T))  # each row once, in order
    last = 0 if reverse else Cp - 1  # the last chunk in chain order
    assert all(len(c) == L >= scan.PLANE_FOLD_MIN_L for i, c in enumerate(rows) if i != last)
    assert 1 <= len(rows[last]) <= L


@pytest.mark.parametrize("T", [15, 16, 33, 64, 100, 399, 1000, 1200, 4096])
@pytest.mark.parametrize("H", [15, 16, 17, 24, 26, 32])
@pytest.mark.parametrize("N", [1, 4, 20, 65])
def test_plane_plan_contract_on_a_grid(T, H, N):
    """Wherever it plans: chunks of >= PLANE_FOLD_MIN_L rows, no more than
    the card holds or sqrt(5 T / 4), none empty; and it plans wherever the
    chain holds two such chunks and the card two chunks a lane."""
    plan = scan.plane_plan(T, H, N, SMS)
    if T < 2 * scan.PLANE_FOLD_MIN_L or 2 * N >= SMS:
        assert plan is None
        return
    Cp, L = plan
    assert Cp >= 2 and L >= scan.PLANE_FOLD_MIN_L and 0 <= Cp * L - T < L
    assert Cp <= min(SMS // N, math.isqrt(5 * T // 4))
    for reverse in (False, True):
        assert all(len(c) >= 1 for c in chunks(T, plan, reverse))


def test_plane_plan_runs_one_pass_elsewhere():
    # the narrow rungs, four lanes a block: the Lorenz chains (H = 6) and up to H = 14
    assert all(scan.plane_plan(1200, h, 4, SMS) is None for h in range(1, 15))
    # h = 15 runs at rung 16, one lane a block, as h = 16 does
    assert scan.plane_rung(15) == scan.plane_rung(16) == 16
    assert scan.plane_plan(1200, 15, 4, SMS) == scan.plane_plan(1200, 16, 4, SMS) is not None
    # lanes that fill half of the SMs or more
    assert scan.plane_plan(1200, 26, SMS // 2, SMS) is None
    assert scan.plane_plan(1200, 26, SMS // 2 - 1, SMS) is not None
    # chains too short for two chunks of PLANE_FOLD_MIN_L rows
    short = 2 * scan.PLANE_FOLD_MIN_L
    assert scan.plane_plan(short - 1, 26, 4, SMS) is None
    assert scan.plane_plan(short, 26, 4, SMS) == (2, scan.PLANE_FOLD_MIN_L)


def test_plane_rungs_are_the_kernels():
    assert [scan.plane_rung(h) for h in range(1, scan.PLANE_MAX_H + 1)] == (
        [4] * 4 + [6] * 2 + [8] * 2 + [10] * 2 + [12] * 2 + [14] * 2 + [16] * 2 + [24] * 8
        + [32] * 8)
    assert scan.plane_rung(scan.PLANE_MAX_H + 1) is None
    assert scan.plane_plan(1200, scan.PLANE_MAX_H + 1, 4, SMS) is None  # the kernel refuses it


@pytest.mark.parametrize("switch", ["0", "auto", "1"])
def test_fold_plan_by_switch_and_device(switch, monkeypatch):
    """Under "0" a plane scan on a CUDA device takes plane_plan and every
    other scan, and every CPU scan, one pass; "auto" and "1" keep the JAX
    package's plans on both devices."""
    monkeypatch.setattr(scan, "TIME_FOLD", switch)
    monkeypatch.setattr(scan, "_sm_count", lambda index: SMS)
    for T, N, size in [(1200, 4, 26), (150, 20, 26), (150, 240, 26), (399, 100, 6),
                       (100, 64000, 2), (40, 8, 14)]:
        for s in scan.SCANS:
            jax_plan = s.fold_plan(T, N)
            assert s.fold_plan(T, N, size, torch.device("cpu")) == (
                None if switch == "0" else jax_plan)
            on_card = s.fold_plan(T, N, size, CUDA)
            if switch != "0":
                assert on_card == jax_plan
            elif s is scan.KALMAN_PLANE:
                assert on_card == scan.plane_plan(T, size, N, SMS)
            else:
                assert on_card is None
    if switch == "0":
        for shape, plan in FLOCKING.items():
            T, H, N = shape
            assert scan.KALMAN_PLANE.fold_plan(T, N, H, CUDA) == plan


def plane_leaves(rs, T, H, N):
    """Plane-layout pair potentials whose joint precision is SPD, float64."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    dense = (J[..., :H, :H], J[..., :H, H:], J[..., H:, H:], rs.randn(T, N, H),
             rs.randn(T, N, H))
    return tuple(torch.from_numpy(np.moveaxis(x, 1, -1).copy()) for x in dense) + (
        torch.from_numpy(rs.randn(T, N)),)


@pytest.mark.parametrize("switch", ["0", "auto", "1"])
def test_cpu_route_and_counters_by_switch(switch, monkeypatch):
    """A CPU plane scan at a shape the card would fold reads no SM count and
    takes the JAX package's route: one pass under "0" and "auto" (T below
    TIME_FOLD_MIN_T), the folded plain version under "1"."""
    def no_card(index):
        raise AssertionError("a CPU scan read the card's SM count")

    monkeypatch.setattr(scan, "TIME_FOLD", switch)
    monkeypatch.setattr(scan, "_sm_count", no_card)
    s = scan.KALMAN_PLANE
    leaves = plane_leaves(np.random.RandomState(0), 40, 16, 2)
    before = (s.plain_calls, s.folded.plain_calls, s.launches, s.folded.launches)
    out = scan.kalman_plane_scan(leaves)
    folded = switch == "1"
    assert (s.plain_calls, s.folded.plain_calls, s.launches, s.folded.launches) == (
        before[0] + (not folded), before[1] + folded, before[2], before[3])
    ref = s.plain(leaves)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("reverse", [False, True])
def test_folded_plain_under_a_plane_plan(reverse):
    """The folded plain version takes plane_plan's plan (one short chunk)
    and gives the one-pass plain scan's prefixes in float64."""
    plan = scan.plane_plan(55, 16, 2, 8)
    assert plan == (4, 14)
    s = scan.KALMAN_PLANE
    leaves = plane_leaves(np.random.RandomState(1), 55, 16, 2)
    out = s.folded.plain(leaves, reverse, plan=plan)
    ref = s.plain(leaves, reverse)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-9, atol=1e-9)


def test_a_plan_with_an_empty_chunk_is_refused():
    leaves = plane_leaves(np.random.RandomState(2), 20, 16, 1)
    with pytest.raises(ValueError):
        scan.KALMAN_PLANE.folded.plain(leaves, plan=(5, 5))  # 25 rows for 20: one empty
    with pytest.raises(ValueError):
        scan.fold_args(20, 1, False, (1, 20))
