"""The charge of a traced NLDS run to the program's spans, by the rules of
``cardbench/charge.py``: every device event to the innermost span open when
its launch ran, every idle gap to the span of the event that ends it, every
CUDA runtime call to the span it ran in.

The spans taken are the NLDS sweep's (``nlds.*``) and those its smoothers
open inside it (``hmm.*``, ``kalman.*``, ``scan.*``;
``pyvbmp_tpu_torch/utils/trace.py``).  As ``cardbench/mixlds_charge.py``
does for MixLDS, this charge keeps its own key of ``ctx``, ``nlds_charge``,
a dict of ``spans``, ``device_charge``, ``runtime_calls`` and ``sweeps``
that ``charge.name_of``, ``chain``, ``idle`` and ``table`` take as their
``ctx``.

``of(ctx)`` returns that dict, or None where the trace holds no
``nlds.update`` span or no device event (a program without the spans,
another family's cell, or a run on the CPU); it never raises for want of
them.  Where ``charge.py`` and ``mixlds_charge.py`` left them out, it adds
``idle_by_span`` and ``device_by_span`` to ``ctx["breakdown"]``.
"""
from __future__ import annotations

from cardbench import charge

SPAN_PREFIXES = ("nlds.", "hmm.", "kalman.", "scan.")
KEY = "nlds_charge"
UPDATE = "nlds.update"


def from_events(events):
    """``spans``, ``device_charge`` and ``runtime_calls`` as
    ``charge.from_events`` makes them, from the spans of ``SPAN_PREFIXES``."""
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
    call_spans = charge._innermost(spans, [e.time_range.start * 1e-6 for e in calls])
    runtime_calls = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6, s)
                     for e, s in zip(calls, call_spans)]
    launch = {e.id: s for e, s in zip(calls, call_spans)}
    device_charge = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                      launch.get(e.id), not e.name.startswith(("Memcpy", "Memset")),
                      e.id in launch) for e in dev]
    return dict(spans=spans, device_charge=device_charge, runtime_calls=runtime_calls)


def of(ctx):
    """The NLDS charge of ``ctx``'s trace, or None where there is nothing to
    charge (see the module's docstring)."""
    if KEY not in ctx:
        prof = charge._caller_profile()
        ctx[KEY] = dict(from_events(prof.events() if prof is not None else []),
                        sweeps=ctx["sweeps"])
        c = ctx[KEY]
        if c["device_charge"] and any(s[0] == UPDATE for s in c["spans"]):
            breakdown = ctx.setdefault("breakdown", {})
            if "idle_by_span" not in breakdown:
                charge._add_breakdown(dict(c, breakdown=breakdown))
    c = ctx[KEY]
    if not c["device_charge"] or not any(s[0] == UPDATE for s in c["spans"]):
        return None
    return c


def _in(ctx, name):
    """The kernels whose launch lies inside the span ``name``, its child
    spans included: [(start s, end s)]."""
    c = of(ctx)
    if c is None:
        return None
    return [(a, b) for _, a, b, span, kernel, _ in c["device_charge"]
            if kernel and name in charge.chain(c, span)]


def device_ms_in(ctx, name):
    """Device ms a sweep of the kernels launched inside the span ``name``."""
    k = _in(ctx, name)
    return None if k is None else 1e3 * sum(b - a for a, b in k) / ctx[KEY]["sweeps"]


def launches_in(ctx, name):
    """Kernels a sweep launched inside the span ``name``."""
    k = _in(ctx, name)
    return None if k is None else len(k) / ctx[KEY]["sweeps"]


def calls_in_update(ctx, names):
    """Runtime calls named in ``names`` a sweep, inside ``nlds.update``."""
    c = of(ctx)
    if c is None:
        return None
    n = sum(1 for name, _, _, span in c["runtime_calls"]
            if name in names and UPDATE in charge.chain(c, span))
    return n / c["sweeps"]
