"""The charge of a traced run to the program's spans: every device event,
every idle gap on the device and every CUDA runtime call, put down to the
innermost span of the program that was open on the host when it was caused.

The program opens its spans at the phase boundaries of a sweep
(``pyvbmp_tpu_torch/utils/trace.py``); they reach the profiler's trace as
host events named ``dmbd.*``, ``hmm.*``, ``kalman.*`` and ``scan.*``.  The
rules:

- a device event (a kernel, a copy or a fill) belongs to the innermost span
  open when its launch ran: the runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) with the event's CUDA correlation id;
- an idle gap between device events is charged to the span of the event
  that ends it: the device waited for that event's launch;
- a runtime call belongs to the innermost span open when it started.

The sweep runs on one host thread, so spans and calls are matched by time
alone.  User annotations mirrored on the device's timeline
(``FunctionEvent.is_user_annotation``) are no work and are left out.

``of(ctx)`` adds to a reader's ``ctx`` three keys, once, and returns the
``ctx``, or None where the trace holds no ``dmbd.update`` span or no device
event (a program without spans, or a run on the CPU):

- ``spans``: (name, start s, end s, parent index or None), by start;
- ``device_charge``: (name, start s, end s, span index or None, is a kernel:
  not a copy or fill, as ``run.trace_context`` counts kernels, linked: a
  launch was found) for every device event;
- ``runtime_calls``: (name, start s, end s, span index or None).

The harness's ``trace_context`` does not hand readers the profile, so
``of`` takes it from the frame that called the reader (the local that is a
``torch.profiler.profile``); keys already in ``ctx`` are used as given.
It also adds two lists to ``ctx["breakdown"]``, shaped as its
``idle_gaps``: ``idle_by_span`` and ``device_by_span`` (kernel seconds),
by innermost span, "no span" for the rest, ten at most.
"""
from __future__ import annotations

import sys

SPAN_PREFIXES = ("dmbd.", "hmm.", "kalman.", "scan.")
NO_SPAN = "no span"
# the runtime calls in which the host waits for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
ALLOCATOR = ("cudaMalloc", "cudaFree")
# the phases of a sweep, in the order it runs them (``dmbd.elbo_fetch`` ends
# the ``dmbd.update`` call, after its sweeps)
PHASES = ("dmbd.warmup", "dmbd.role_estep", "dmbd.role_mstep", "dmbd.obs_update",
          "dmbd.latent_estep", "dmbd.elbo", "dmbd.latent_mstep", "dmbd.elbo_fetch")
ESTEP = ("dmbd.role_estep", "dmbd.latent_estep")
MSTEP = ("dmbd.role_mstep", "dmbd.obs_update", "dmbd.latent_mstep")
KEYS = ("spans", "device_charge", "runtime_calls")


def _innermost(spans, times):
    """For each time, the index of the innermost span open at it, or None;
    ``spans`` (name, start, end, ...) by start, properly nested."""
    out = [None] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[i][1]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def from_events(events):
    """The three keys of ``of`` from a profile's events (``FunctionEvent``s
    or anything with their ``name``, ``id``, ``device_type``,
    ``time_range`` and ``is_user_annotation``)."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    raw = sorted(((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in host
                  if e.name.startswith(SPAN_PREFIXES)), key=lambda s: (s[1], -s[2]))
    spans, stack = [], []
    for i, (name, a, b) in enumerate(raw):
        while stack and raw[stack[-1]][2] <= a:
            stack.pop()
        spans.append((name, a, b, stack[-1] if stack else None))
        stack.append(i)
    calls = [e for e in host if e.name.startswith("cu")]
    call_spans = _innermost(spans, [e.time_range.start * 1e-6 for e in calls])
    runtime_calls = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6, s)
                     for e, s in zip(calls, call_spans)]
    launch = {e.id: s for e, s in zip(calls, call_spans)}
    device_charge = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                      launch.get(e.id), not e.name.startswith(("Memcpy", "Memset")),
                      e.id in launch) for e in dev]
    return dict(spans=spans, device_charge=device_charge, runtime_calls=runtime_calls)


def _caller_profile():
    """The profile held by a local of a frame above this one, or None."""
    from torch.autograd.profiler import profile as autograd_profile
    from torch.profiler import profile

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, (profile, autograd_profile)):
                return value
        frame = frame.f_back
    return None


def name_of(ctx, span):
    return NO_SPAN if span is None else ctx["spans"][span][0]


def chain(ctx, span):
    """The names of ``span`` and of every span around it, innermost first."""
    names = []
    while span is not None:
        name, _, _, span = ctx["spans"][span]
        names.append(name)
    return names


def phase(ctx, span):
    """The sweep's phase (``PHASES``) that ``span`` lies in, or None."""
    return next((n for n in chain(ctx, span) if n in PHASES), None)


def idle(ctx):
    """[(seconds, span index or None)]: each idle gap between the first and
    the last device event, with the span of the event that ends it."""
    gaps, cur = [], None
    for _, a, b, span, _, _ in sorted(ctx["device_charge"], key=lambda d: d[1]):
        if cur is not None and a > cur:
            gaps.append((a - cur, span))
        cur = b if cur is None else max(cur, b)
    return gaps


def _top(d):
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _add_breakdown(ctx):
    by_idle, by_dev = {}, {}
    for s, span in idle(ctx):
        k = name_of(ctx, span)
        by_idle[k] = by_idle.get(k, 0.0) + s
    for _, a, b, span, kernel, _ in ctx["device_charge"]:
        if kernel:
            k = name_of(ctx, span)
            by_dev[k] = by_dev.get(k, 0.0) + (b - a)
    breakdown = ctx.setdefault("breakdown", {})
    breakdown["idle_by_span"] = _top(by_idle)
    breakdown["device_by_span"] = _top(by_dev)


def of(ctx):
    """``ctx`` with the charge's keys, or None where there is nothing to
    charge (see the module's docstring)."""
    fresh = not all(k in ctx for k in KEYS)
    if fresh:
        prof = _caller_profile()
        ctx.update(from_events(prof.events() if prof is not None else []))
    if not ctx["device_charge"] or not any(s[0] == "dmbd.update" for s in ctx["spans"]):
        return None
    if fresh:
        _add_breakdown(ctx)
    return ctx


def launches_in(ctx, phases):
    """Kernels a sweep whose launch lies in one of ``phases``."""
    if of(ctx) is None:
        return None
    n = sum(1 for _, _, _, span, kernel, _ in ctx["device_charge"]
            if kernel and phase(ctx, span) in phases)
    return n / ctx["sweeps"]


def calls_in_update(ctx, names):
    """Runtime calls named in ``names`` a sweep, inside ``dmbd.update``."""
    if of(ctx) is None:
        return None
    n = sum(1 for name, _, _, span in ctx["runtime_calls"]
            if name in names and "dmbd.update" in chain(ctx, span))
    return n / ctx["sweeps"]


def table(ctx):
    """{innermost span name: dict(launches, device_ms, idle_ms, syncs,
    allocator, self_ms)}, each a sweep, "no span" included: the per-phase
    table.  ``self_ms`` is the spans' host time less their child spans'."""
    rows = {}

    def row(span):
        return rows.setdefault(name_of(ctx, span), dict(
            launches=0.0, device_ms=0.0, idle_ms=0.0, syncs=0.0, allocator=0.0, self_ms=0.0))

    n = ctx["sweeps"]
    for _, a, b, span, kernel, _ in ctx["device_charge"]:
        if kernel:
            r = row(span)
            r["launches"] += 1 / n
            r["device_ms"] += 1e3 * (b - a) / n
    for s, span in idle(ctx):
        row(span)["idle_ms"] += 1e3 * s / n
    for name, _, _, span in ctx["runtime_calls"]:
        if name in SYNCS:
            row(span)["syncs"] += 1 / n
        elif name in ALLOCATOR:
            row(span)["allocator"] += 1 / n
    for i, (_, a, b, parent) in enumerate(ctx["spans"]):
        row(i)["self_ms"] += 1e3 * (b - a) / n
        if parent is not None:
            row(parent)["self_ms"] -= 1e3 * (b - a) / n
    return rows
