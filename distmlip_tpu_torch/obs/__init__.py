"""Observability: request-scoped tracing, live metrics, SLO flight
recorder (``distmlip_tpu/obs/__init__.py``).

Three planes over one set of instrumentation points (the ``StepRecord``
emission sites — the potential/model hot path is untouched):

- **Records** (:mod:`distmlip_tpu_torch.telemetry`) — the per-step JSONL
  artifact, analyzed offline; records carry ``trace_id``/``span_id`` so
  they correlate with the other planes.
- **Traces** (:mod:`.tracing` / :mod:`.export`) — one span tree per
  REQUEST across every hop of the serving engine (submit → queue → plan →
  pack → dispatch → resolve), with span links from each batch dispatch to
  its member requests. Exported as Perfetto-loadable ``trace_event`` JSON.
- **Metrics** (:mod:`.metrics`) — typed Counter/Gauge/Histogram populated
  live (requests, queue depth, batch occupancy, compiles, HBM headroom),
  served as Prometheus text exposition by :class:`MetricsServer` and
  snapshot-dumpable into JSON.

- **Compiler/device** (:mod:`.profiling` / :mod:`.attribution` /
  :mod:`.roofline`) — the compile log (first dispatches of a new shape
  bucket and ``nvcc`` kernel builds; ``distmlip_compile_seconds`` +
  ``distmlip_compiles_total{site,kind}``), scope-level device-time
  attribution from a ``torch.profiler`` capture, and roofline rows from the
  records.

Plus the incident plane: :class:`~.slo.SLOMonitor` evaluates per-tenant
multi-window burn rates and, on breach (or the first deadline miss), the
:class:`~.flight.FlightRecorder` captures traces + metrics (+ an optional
bounded ``torch.profiler`` capture) into a timestamped incident directory.

Quick start::

    from distmlip_tpu_torch import obs

    hub = obs.Observability.enable(slo=obs.SLOConfig(latency_s=0.5),
                                   flight_dir="incidents/")
    ...  # run engine traffic: spans + metrics flow automatically
    hub.tracer.write("trace.json")        # -> ui.perfetto.dev
    print(hub.metrics.render())           # Prometheus exposition
    obs.uninstall()

Everything here is host-side and stdlib-only (the attribution reads a
Chrome trace file).
"""

from __future__ import annotations

from . import attribution, profiling, roofline, runtime
from .attribution import ScopeBreakdown, attribute
from .export import (critical_path_summary, critical_paths,
                     format_critical_path, load_trace, load_trace_dir,
                     request_trace_summary, to_trace_events, write_trace)
from .flight import FlightRecorder
from .profiling import (CompileEvent, compile_counts, compile_events,
                        record_compile, reset_compile_log)
from .roofline import RooflineRow, format_roofline_table
from .metrics import (LATENCY_BUCKETS, MetricsRegistry, MetricsServer,
                      parse_exposition)
from .runtime import hub, install, uninstall
from .slo import SLOConfig, SLOMonitor
from .tracing import (REQUEST_ROOT_NAMES, TERMINAL_SPAN_NAME, RequestTrace,
                      Span, Tracer)


class Observability:
    """The hub: tracer + metrics + SLO monitor + flight recorder."""

    def __init__(self, tracer=None, metrics=None, slo=None, flight=None):
        self.tracer = tracer
        self.metrics = metrics
        self.slo = slo
        self.flight = flight

    @classmethod
    def enable(cls, *, tracing: bool = True, metrics: bool = True,
               slo=None, flight_dir: str | None = None,
               profile_s: float = 0.0, max_spans: int = 262144,
               last_k_traces: int = 64, min_interval_s: float = 60.0,
               clock=None, register: bool = True) -> "Observability":
        """Build a hub and (by default) install it process-globally.

        ``slo``: an :class:`SLOConfig` (one default policy), a
        ``{tenant: SLOConfig}`` mapping (first entry doubles as the
        default), or None for no SLO monitoring. ``flight_dir`` arms the
        flight recorder; SLO breaches auto-capture into it.
        """
        tr = Tracer(max_spans=max_spans, clock=clock) if tracing else None
        mx = MetricsRegistry() if metrics else None
        mon = None
        if slo is not None:
            if isinstance(slo, dict):
                default = next(iter(slo.values()))
                mon = SLOMonitor(default=default, per_tenant=slo,
                                 clock=clock)
            else:
                mon = SLOMonitor(default=slo, clock=clock)
        fr = None
        if flight_dir is not None:
            fr = FlightRecorder(flight_dir, tracer=tr, metrics=mx,
                                last_k_traces=last_k_traces,
                                profile_s=profile_s,
                                min_interval_s=min_interval_s,
                                clock=clock)
            if mon is not None:
                mon.on_breach = (
                    lambda tenant, info: fr.capture(
                        f"slo burn-rate breach: tenant {tenant!r}",
                        attrs=info))
        h = cls(tr, mx, mon, fr)
        if register:
            install(h)
        return h

    def close(self) -> None:
        """Uninstall (if this hub is the installed one)."""
        uninstall(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def snapshot(self) -> dict:
        out: dict = {}
        if self.tracer is not None:
            out["tracer"] = {
                "spans_finished": self.tracer.spans_finished,
                "spans_dropped": self.tracer.spans_dropped,
            }
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.flight is not None:
            out["flight"] = self.flight.snapshot()
        return out


__all__ = [
    "Observability",
    "Tracer",
    "Span",
    "RequestTrace",
    "REQUEST_ROOT_NAMES",
    "TERMINAL_SPAN_NAME",
    "MetricsRegistry",
    "MetricsServer",
    "LATENCY_BUCKETS",
    "parse_exposition",
    "SLOConfig",
    "SLOMonitor",
    "FlightRecorder",
    "install",
    "uninstall",
    "hub",
    "runtime",
    "to_trace_events",
    "write_trace",
    "load_trace",
    "load_trace_dir",
    "request_trace_summary",
    "critical_paths",
    "critical_path_summary",
    "format_critical_path",
    "profiling",
    "attribution",
    "roofline",
    "CompileEvent",
    "record_compile",
    "compile_events",
    "compile_counts",
    "reset_compile_log",
    "ScopeBreakdown",
    "attribute",
    "RooflineRow",
    "format_roofline_table",
]
