"""Process-global observability hub + the cheap accessors instrumented
code calls (``distmlip_tpu/obs/runtime.py``).

The serving/fleet/active layers do NOT take tracer/metrics parameters —
instrumentation points ask this module for the installed hub at call
time, so:

- with nothing installed (the default) every instrumented site costs one
  module-global read and a ``None`` check — the hot path is untouched;
- one ``Observability.enable()`` (or ``install(hub)``) lights up every
  layer at once, including objects constructed before the call;
- tests install and uninstall deterministically (``uninstall()`` in a
  ``finally``); the CLI tools do the same.

Nothing here imports torch or any sibling subsystem — this module must be
importable from every instrumented layer without cycles.
"""

from __future__ import annotations

_HUB = None


def install(hub):
    """Install ``hub`` (an :class:`~distmlip_tpu_torch.obs.Observability`) as
    the process-global observability surface; returns it."""
    global _HUB
    _HUB = hub
    return hub


def uninstall(hub=None) -> None:
    """Remove the global hub (or only ``hub``, if it is still the one
    installed — lets an owner tear down without clobbering a successor).
    """
    global _HUB
    if hub is None or _HUB is hub:
        _HUB = None


def hub():
    return _HUB


def tracer():
    """The installed Tracer, or None (the instrumented-site fast path)."""
    h = _HUB
    return None if h is None else h.tracer


def metrics():
    """The installed MetricsRegistry, or None."""
    h = _HUB
    return None if h is None else h.metrics


def slo():
    """The installed SLOMonitor, or None."""
    h = _HUB
    return None if h is None else h.slo


def flight():
    """The installed FlightRecorder, or None."""
    h = _HUB
    return None if h is None else h.flight


def current_ctx():
    """This thread's ambient (trace_id, span_id), or None."""
    h = _HUB
    if h is None or h.tracer is None:
        return None
    return h.tracer.current()


def current_trace_id():
    """This thread's ambient trace id, or None — producers fold it into
    ``telemetry.annotate`` range names so device timelines line up
    with host spans."""
    ctx = current_ctx()
    return None if ctx is None else ctx[0]
