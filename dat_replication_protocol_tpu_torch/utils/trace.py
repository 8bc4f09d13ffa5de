"""Profiler spans around host -> device dispatch boundaries.

The counterpart of ``dat_replication_protocol_tpu/utils/trace.py``:

* :func:`span` — a named range for host phases around the card (digest
  dispatch and collect, CDC dispatch, collect and greedy pass,
  reconciliation hash, sketch, diff, build and peel).  While a
  ``torch.profiler`` capture runs it is a
  ``torch.profiler.record_function`` range, so the phase shows on the
  trace beside the kernels.  With the obs gate on it also records a
  span of the same name into :data:`..obs.tracing.SPANS` with field
  ``src="torch"`` (the reference writes ``src="jax"``).  With neither,
  it returns a shared null context: ``record_function`` calls into the
  dispatcher, so it is bound only when a profiler is on.
* :func:`trace_to` — a ``torch.profiler.profile`` capture whose Chrome
  trace is written into a directory.

``torch`` is imported at the first :func:`span` or :func:`trace_to`
call, not at module import.
"""
# datlint: disable-file=obs-discipline  — this module IS span plumbing:
# it forwards caller-supplied span names into torch.profiler and the obs
# span ring by design; its callers are the greppable sites.

from __future__ import annotations

import contextlib
import os
import sys

from ..obs import tracing as _obs_tracing
from ..obs.metrics import OBS as _OBS


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

# the torch module, bound at the first span() call.  The profiler calls
# stay attribute calls on it (``torch.profiler.record_function``), so a
# reader, and the concurrency analysis, sees library calls, not stored
# callables.
_torch = None


def _bind():
    global _torch
    import torch

    _torch = torch
    return torch


class _JoinedSpan:
    """An obs span and, while a profiler runs, a ``record_function``
    range of the same name."""

    __slots__ = ("_span", "_inner")

    def __init__(self, name: str, inner):
        self._span = _obs_tracing.trace_span(name, src="torch")
        self._inner = inner

    def __enter__(self):
        self._span.__enter__()
        try:
            self._inner.__enter__()
        except BaseException:
            # unwind the obs span: an unpopped id would corrupt the
            # thread's parent stack
            self._span.__exit__(*sys.exc_info())
            raise
        return self

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc) or False
        finally:
            self._span.__exit__(*exc)


def span(name: str):
    """Named profiler range, and an obs span while the gate is on; the
    null span when neither a profiler nor the gate is on."""
    torch = _torch or _bind()
    inner = (torch.profiler.record_function(name)
             if torch.autograd._profiler_enabled() else _NULL)
    if _OBS.on:
        return _JoinedSpan(name, inner)
    return inner


@contextlib.contextmanager
def trace_to(log_dir: str | None, cuda: bool = True):
    """Capture a ``torch.profiler`` trace of the block and write it as
    Chrome trace JSON into ``log_dir`` (no-op if None).  ``cuda`` adds
    the CUDA activity (device kernels and copies); pass False on a host
    without a card.  Yields the profiler; its file is
    ``log_dir/trace.json`` once the block ends."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
