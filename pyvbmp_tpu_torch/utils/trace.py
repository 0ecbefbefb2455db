"""Named spans at the phase boundaries of a sweep, for a profiler to see.

``span(name, args=None)`` is a context manager.  While a profiler is active
(``torch.profiler.profile``, or ``torch.autograd.profiler.emit_nvtx`` under
``nsys``) it records a range named ``name`` on the host: in the profiler's
trace beside the torch operators and CUDA runtime calls it encloses, on the
same clock, or as an NVTX range.  ``args`` is a dict of keyword values kept
with the range (shown where the profiler records inputs, ``record_shapes``).
With no profiler active it returns one shared no-op context after a single
check and records nothing, so a sweep pays one check a span.

The range is recorded at function scope, as a torch operator is, and not as
a user annotation (``torch.profiler.record_function``): Kineto mirrors each
user annotation as an event on the device's timeline, which a reading of
the trace would take for a kernel.

Spans of the DMBD sweep (``models/dmbd.py``), innermost last: ``dmbd.update``
> ``dmbd.sweep`` (args: the sweep's index) > ``dmbd.warmup``,
``dmbd.role_estep``, ``dmbd.role_mstep``, ``dmbd.obs_update``,
``dmbd.latent_estep``, ``dmbd.elbo``, ``dmbd.latent_mstep``; then
``dmbd.elbo_fetch`` inside ``dmbd.update``.  Spans of the MixLDS sweep
(``models/mix_lds.py``): ``mixlds.update`` > ``mixlds.sweep`` (args: the
sweep's index) > ``mixlds.lds_estep`` (the observation messages, the
smoother and the sufficient statistics), ``mixlds.responsibilities`` (the
KL terms, the softmax over the systems and the ELBO), ``mixlds.mstep``
(pi, x_{-1}, A and the observation model); then ``mixlds.elbo_fetch``
inside ``mixlds.update``.  Spans of the NLDS sweep (``models/nlds.py``):
``nlds.update`` > ``nlds.sweep`` (args: the sweep's index) >
``nlds.x_estep`` (the potentials mixed under q(s), the observation
messages, the smoother and the moments), ``nlds.mstep`` (x_{-1}, A and B),
``nlds.s_estep`` (the observation and transition logits and the driven
forward-backward), ``nlds.gate`` (the transition MNLR, then pi0),
``nlds.elbo`` (the KL terms); then ``nlds.elbo_fetch`` inside
``nlds.update``.  The smoothers open
``hmm.forward_backward`` (``ops/parallel_hmm.py``) and ``kalman.smoother``
(``ops/parallel_kalman.py``), and each scan ``scan.<route>``
(``ops/scan.py``: ``scan.kalman_plane_scan``,
``scan.logsemiring_scan_folded``, ...).
"""
from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name, args=None):
    """A range named ``name`` while a profiler is active, else a no-op."""
    if not _profiler_enabled():
        return _OFF
    if args is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], dict(args))
