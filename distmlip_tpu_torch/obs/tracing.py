"""Request-scoped distributed tracing for the serving stack
(``distmlip_tpu/obs/tracing.py``).

One request = one trace. The router/engine open a ROOT span at submit
(``fleet.submit`` / ``engine.submit``), every hop the request takes adds
a child span — ``tenancy.admit``, ``router.route``, ``engine.queue``,
``cache.hit``, ``coalesce``, ``router.requeue`` — and the request's
resolution emits exactly one terminal ``future.resolve`` span and closes
the root. Batch-level work (``serve.batch`` with ``scheduler.plan_batch``
/ ``batched.pack`` / ``device.dispatch`` / ``device.compile`` children)
lives in its OWN trace carrying span LINKS back to every member
request's context, the Perfetto/OTel idiom for fan-in: per-request
critical paths are reconstructed by following the links
(:mod:`.export`).

Design constraints, in order:

- **Thread-safe across the scheduler/prefetch/health threads.** A span
  context is an immutable ``(trace_id, span_id)`` tuple; cross-thread
  propagation is EXPLICIT — the submitting thread stores a
  :class:`RequestTrace` handle on the request object, and the scheduler
  thread emits retroactive spans against it (``Tracer.emit`` with caller
  timestamps). Within one thread, ``Tracer.span()`` / ``Tracer.use()``
  chain parents automatically through a ``contextvars`` slot.
- **Lock-cheap.** Open spans are plain objects held by the caller; the
  tracer takes its lock only when a span FINISHES (one bounded-deque
  append per span, a handful of spans per request). Spans are host
  objects; the device timeline is named by ``telemetry.annotate`` ranges.
- **One clock.** All span timestamps come from ``Tracer.now()``
  (``time.perf_counter`` by default, injectable) so retroactive and live
  spans land on one timeline; ``t_wall0`` anchors it to wall time for
  incident stamps.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque

# root span names that mark a trace as a REQUEST trace (vs batch-level
# traces like serve.batch); the completeness gate in export.py keys on
# these
REQUEST_ROOT_NAMES = ("fleet.submit", "engine.submit")
# the one terminal span every complete request trace must contain exactly
# once, whatever path the request took (dispatch, cache hit, coalesce,
# failover re-dispatch, shed, error)
TERMINAL_SPAN_NAME = "future.resolve"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "distmlip_obs_span", default=None)


def _ctx_of(parent):
    """Normalize a Span / (trace_id, span_id) tuple / None to a ctx."""
    if parent is None:
        return None
    if isinstance(parent, Span):
        return (parent.trace_id, parent.span_id)
    return (parent[0], parent[1])


class Span:
    """One span: open until ``t_end`` is set by ``Tracer.end``."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "t_end", "status", "attrs", "links")

    def __init__(self, trace_id, span_id, parent_id, name, t_start,
                 attrs=None, links=()):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = float(t_start)
        self.t_end = None
        self.status = "open"
        self.attrs = dict(attrs) if attrs else None
        self.links = tuple(_ctx_of(l) for l in links)

    @property
    def ctx(self) -> tuple:
        return (self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return (self.t_end - self.t_start) if self.t_end is not None else 0.0

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "t_start": self.t_start, "t_end": self.t_end,
            "status": self.status, "attrs": self.attrs or {},
            "links": [list(l) for l in self.links],
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"status={self.status})")


class RequestTrace:
    """Per-request trace handle carried ACROSS THREADS on the request
    object (``_Request.trace`` / ``_Routed.trace``): the request's span
    context, the open root span when this layer OWNS the trace (None when
    an outer layer — the router above an engine — owns it and will close
    it), and the tracer-clock submit timestamp retroactive spans anchor
    on."""

    __slots__ = ("ctx", "root", "t_submit")

    def __init__(self, ctx, root, t_submit):
        self.ctx = ctx
        self.root = root
        self.t_submit = float(t_submit)

    @property
    def trace_id(self) -> str:
        return self.ctx[0]

    @property
    def span_id(self) -> str:
        return self.ctx[1]


class Tracer:
    """Bounded in-memory span collector.

    Completed spans land in a ``deque(maxlen=max_spans)`` — week-long
    runs trace at constant memory and the flight recorder snapshots the
    most recent window. ``spans_dropped`` counts evictions so a
    completeness gate can tell "incomplete trace" from "evicted trace".
    """

    def __init__(self, max_spans: int = 262144, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self.max_spans = int(max_spans)
        self._spans: deque = deque(maxlen=self.max_spans)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        # id base keeps span ids unique across tracers/processes sharing
        # one artifact (two load-test runs appending to one trace dir)
        self._base = f"{os.getpid() & 0xFFFF:04x}{id(self) & 0xFFF:03x}"
        self.spans_finished = 0
        self.t_wall0 = time.time() - self.now()   # wall anchor for exports

    # ------------------------------------------------------------------
    # core
    # ------------------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def current(self) -> tuple | None:
        """The ambient (trace_id, span_id) context of THIS thread."""
        return _CURRENT.get()

    def begin(self, name: str, parent=None, attrs=None, links=(),
              t_start=None, new_trace: bool = False) -> Span:
        """Open a span. Parent resolution: explicit ``parent`` wins, then
        the thread's ambient context, then a fresh trace (``new_trace``
        forces the fresh trace even when an ambient context exists)."""
        pctx = None if new_trace else (_ctx_of(parent) or _CURRENT.get())
        n = next(self._ids)
        span_id = f"{self._base}.{n:x}"
        trace_id = pctx[0] if pctx is not None else f"T{span_id}"
        return Span(trace_id, span_id, pctx[1] if pctx is not None else "",
                    name, self.now() if t_start is None else t_start,
                    attrs=attrs, links=links)

    def end(self, span: Span, status: str = "ok", t_end=None,
            attrs=None) -> Span:
        """Close a span and commit it to the buffer (idempotent)."""
        if span.t_end is not None:
            return span
        span.t_end = self.now() if t_end is None else float(t_end)
        span.status = status
        if attrs:
            span.attrs = {**(span.attrs or {}), **attrs}
        with self._lock:
            self._spans.append(span)
            self.spans_finished += 1
        return span

    def emit(self, name: str, parent=None, t_start=None, t_end=None,
             status: str = "ok", attrs=None, links=(),
             new_trace: bool = False) -> Span:
        """One-shot closed span with caller-supplied (retroactive)
        timestamps; ``t_start``/``t_end`` default to now (instant span)."""
        now = self.now()
        s = self.begin(name, parent=parent, attrs=attrs, links=links,
                       t_start=now if t_start is None else t_start,
                       new_trace=new_trace)
        return self.end(s, status=status,
                        t_end=now if t_end is None else t_end)

    @contextlib.contextmanager
    def span(self, name: str, parent=None, attrs=None, links=(),
             new_trace: bool = False):
        """Live span context manager; sets the ambient context so nested
        spans (and instrumented callees) chain under it."""
        s = self.begin(name, parent=parent, attrs=attrs, links=links,
                       new_trace=new_trace)
        token = _CURRENT.set(s.ctx)
        try:
            yield s
        except BaseException:
            self.end(s, status="error")
            raise
        else:
            self.end(s)
        finally:
            _CURRENT.reset(token)

    @contextlib.contextmanager
    def use(self, parent):
        """Set the ambient context WITHOUT opening a span (hand a stored
        request/batch context to code that reads ``current()``)."""
        token = _CURRENT.set(_ctx_of(parent))
        try:
            yield
        finally:
            _CURRENT.reset(token)

    # ------------------------------------------------------------------
    # request helpers (the one idiom engine/router instrumentation uses)
    # ------------------------------------------------------------------

    def start_request(self, name: str, attrs=None) -> RequestTrace:
        """Open a request ROOT span in a fresh trace and return the
        cross-thread handle. The caller that resolves the request must
        call :meth:`finish_request` exactly once."""
        root = self.begin(name, attrs=attrs, new_trace=True)
        return RequestTrace(root.ctx, root, root.t_start)

    def adopt_request(self, ctx=None) -> RequestTrace | None:
        """Join an OUTER layer's request trace (root=None: the outer
        layer closes it); ``ctx`` defaults to the ambient context.
        Returns None when there is nothing to join."""
        ctx = _ctx_of(ctx) if ctx is not None else _CURRENT.get()
        if ctx is None:
            return None
        return RequestTrace(ctx, None, self.now())

    def finish_request(self, trace: RequestTrace, status: str = "ok",
                       attrs=None) -> None:
        """Emit the terminal ``future.resolve`` span and close the root
        (no-op for adopted traces — the owner closes those)."""
        if trace is None or trace.root is None:
            return
        now = self.now()
        self.emit(TERMINAL_SPAN_NAME, parent=trace.ctx, t_start=now,
                  t_end=now, status=status, attrs=attrs)
        self.end(trace.root, status=status, t_end=now)

    # ------------------------------------------------------------------
    # introspection / export
    # ------------------------------------------------------------------

    @property
    def spans_dropped(self) -> int:
        with self._lock:
            return self.spans_finished - len(self._spans)

    def spans(self) -> list:
        """Snapshot of the completed-span buffer (oldest first)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.spans_finished = 0

    def trace_events(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (see export.py)."""
        from .export import to_trace_events

        return to_trace_events(self.spans(), t_wall0=self.t_wall0)

    def write(self, path: str) -> str:
        """Write the Perfetto-loadable trace JSON; returns ``path``."""
        from .export import write_trace

        return write_trace(path, self.spans(), t_wall0=self.t_wall0)
