"""Trace annotations for the host phases and the models' layers
(``distmlip_tpu/telemetry/trace.py``), over ``torch.profiler``.

- ``annotate(name)`` — a host phase range: ``torch.profiler.record_function``
  (a ``user_annotation`` on the CPU timeline and, under a CUDA profile, a
  ``gpu_user_annotation`` over the kernels it launched) plus an NVTX range
  on a card. Gated on a module flag: disabled (the default) it returns a
  shared null context manager, so instrumented call sites cost one global
  read.
- ``scope(name)`` — the named scope the models put on each interaction and
  readout block (``"<family>/<layer>"``) and ``parallel/halo.py`` on the
  halo exchange. In JAX a ``named_scope`` is trace-time metadata and free at
  run time; a ``record_function`` is not, so ``scope`` is the shared null
  context unless tracing is on or a ``torch.profiler`` capture is
  recording. Under a profile it is a ``record_function`` range, which is
  what lets ``obs.attribution`` split a step's device time by layer.

``device_trace(logdir)`` captures a ``torch.profiler`` trace with the CPU
and (on a card) CUDA activities AND enables the host annotations for its
duration, then writes the Chrome trace ``logdir/trace.json``: one context
manager produces the fully named timeline ``obs.attribution`` reads.
"""

from __future__ import annotations

import contextlib
import os

import torch

_tracing = False


def set_tracing(on: bool) -> None:
    """Globally enable/disable the host annotations."""
    global _tracing
    _tracing = bool(on)


def tracing_enabled() -> bool:
    return _tracing


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


class _Range:
    """``record_function`` plus an NVTX range when a card is present."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = torch.profiler.record_function(name)
        self._nvtx = False

    def __enter__(self):
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return self._rf.__exit__(*exc)


def annotate(name: str):
    """Host phase range; a shared no-op object when tracing is off."""
    if not _tracing:
        return _NULL
    return _Range(name)


def _profiler_recording() -> bool:
    return torch.autograd._profiler_enabled()


def scope(name: str):
    """Layer scope: a ``record_function`` range while tracing is on or a
    ``torch.profiler`` capture records, else the shared null context."""
    if not (_tracing or _profiler_recording()):
        return _NULL
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` capture (CPU, and CUDA where a card is present)
    with the host annotations on for its duration; the Chrome trace lands
    in ``logdir/trace.json`` (open it in ``ui.perfetto.dev``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = _tracing
    set_tracing(True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        finally:
            set_tracing(was)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
