"""SLO-triggered flight recorder: capture the evidence when it matters
(``distmlip_tpu/obs/flight.py``).

When a burn-rate breach (or the first deadline miss / a replica wedge
suspicion) fires on hardware you can't reproduce locally, the thing you
actually want is a bounded snapshot of what the system was doing RIGHT
THEN. ``FlightRecorder.capture(reason)`` writes a timestamped incident
directory containing:

- ``incident.json`` — the reason, wall time, caller attributes, and the
  tracer/metrics bookkeeping counters;
- ``trace.json`` — the last ``last_k_traces`` distinct span trees from
  the tracer's ring buffer, exported as Perfetto-loadable
  ``trace_event`` JSON (open ``ui.perfetto.dev`` and drop the file in);
- ``metrics.prom`` / ``metrics.json`` — the full registry state in both
  exposition and snapshot form;
- ``profile/`` (optional, ``profile_s > 0``) — a BOUNDED
  ``torch.profiler`` trace (CPU and CUDA activities, a Chrome trace)
  captured for ``profile_s`` seconds on a daemon thread, with host
  annotations enabled for the duration so the device timeline carries the
  serving span names.

Captures are rate-limited (``min_interval_s``) so a miss storm produces
one incident, not a disk full of them; suppressed captures are counted.
"""

from __future__ import annotations

import json
import os
import threading
import time


class FlightRecorder:
    """Bounded incident capture over a tracer + metrics registry."""

    def __init__(self, out_dir: str, tracer=None, metrics=None,
                 last_k_traces: int = 64, profile_s: float = 0.0,
                 min_interval_s: float = 60.0, clock=None):
        self.out_dir = str(out_dir)
        self.tracer = tracer
        self.metrics = metrics
        self.last_k_traces = int(last_k_traces)
        self.profile_s = float(profile_s)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._last_capture_t = None
        self._profiling = False
        self.captures = 0
        self.suppressed = 0
        self.incidents: list[str] = []

    # ------------------------------------------------------------------

    def _recent_trace_spans(self) -> list:
        """Spans of the last K distinct traces, walked newest-first over
        the tracer's ring buffer (a span tree is whatever of it the ring
        still holds — bounded by construction)."""
        spans = self.tracer.spans()
        keep: set = set()
        for s in reversed(spans):
            if s.trace_id not in keep:
                if len(keep) >= self.last_k_traces:
                    break
                keep.add(s.trace_id)
        return [s for s in spans if s.trace_id in keep]

    def capture(self, reason: str, attrs: dict | None = None) -> str | None:
        """Write one incident directory; returns its path, or None when
        rate-limited. Never raises into the serving path — any capture
        fault is recorded on the recorder and swallowed."""
        now = self._clock()
        with self._lock:
            if (self._last_capture_t is not None
                    and now - self._last_capture_t < self.min_interval_s):
                self.suppressed += 1
                return None
            self._last_capture_t = now
            self.captures += 1
            seq = self.captures
        try:
            return self._write_incident(reason, attrs, seq)
        except Exception as e:  # noqa: BLE001 - never fail the caller
            import warnings

            warnings.warn(f"flight recorder capture failed ({e}); "
                          f"incident dropped", stacklevel=2)
            return None

    def _write_incident(self, reason, attrs, seq) -> str:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        d = os.path.join(self.out_dir, f"incident-{stamp}-{seq:03d}")
        os.makedirs(d, exist_ok=True)
        meta = {
            "reason": reason,
            "t_wall": time.time(),
            "attrs": dict(attrs or {}),
            "capture_seq": seq,
        }
        if self.tracer is not None:
            meta["spans_finished"] = self.tracer.spans_finished
            meta["spans_dropped"] = self.tracer.spans_dropped
            from .export import write_trace

            write_trace(os.path.join(d, "trace.json"),
                        self._recent_trace_spans(),
                        t_wall0=self.tracer.t_wall0)
        if self.metrics is not None:
            with open(os.path.join(d, "metrics.prom"), "w") as f:
                f.write(self.metrics.render())
            self.metrics.dump_json(os.path.join(d, "metrics.json"))
        with open(os.path.join(d, "incident.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        if self.profile_s > 0:
            self._start_profile(os.path.join(d, "profile"))
        self.incidents.append(d)
        return d

    def _start_profile(self, logdir: str) -> None:
        """Bounded torch.profiler capture on a daemon thread (at most one
        in flight — a second trigger during a capture is skipped; the
        profiler does not nest)."""
        with self._lock:
            if self._profiling:
                return
            self._profiling = True

        def _run():
            try:
                from ..telemetry.trace import device_trace

                with device_trace(logdir):
                    time.sleep(self.profile_s)
            except Exception:  # noqa: BLE001 - best-effort capture
                pass
            finally:
                with self._lock:
                    self._profiling = False

        threading.Thread(target=_run, name="distmlip-flight-profile",
                         daemon=True).start()

    def snapshot(self) -> dict:
        with self._lock:
            return {"captures": self.captures,
                    "suppressed": self.suppressed,
                    "incidents": list(self.incidents)}
