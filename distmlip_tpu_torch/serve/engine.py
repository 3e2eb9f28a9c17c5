"""In-process async inference engine: continuous micro-batching over the
batched multi-structure potential (``distmlip_tpu/serve/engine.py``).

Callers ``submit()`` single structures and get
``concurrent.futures.Future``s back; a background scheduler thread
assembles micro-batches (bucket-aware: ``scheduler.plan_batch`` fills
toward the ``BucketPolicy`` ladder), ordered by priority, then deadline,
then submission, with a max-wait timer so a lone request is never
starved, and runs them through ONE shared ``BatchedPotential``. Structures
past ``max_batch_atoms`` go to a ``DistPotential`` fallback lane.

Robustness contract (``tests/test_torch_serve.py``):

- bounded queue with admission control: ``admission="reject"`` raises
  ``ServeRejected`` when the queue is full, ``"block"`` parks the caller
  until the scheduler frees a slot;
- memory-aware admission: when the potential carries a device memory
  budget (``BatchedPotential.hbm_budget_bytes``) and its bytes model,
  measured on the card, puts a structure ALONE over it on its own measured
  rung, the request is rejected at submit in both admission modes; batch
  assembly fills toward the same budget;
- per-request error isolation: a structure with non-finite positions fails
  its OWN Future before the batch runs; a batch that raises (a build, a
  launch, anything) fails nothing yet: each of its requests is run alone
  through the same potential, so only the faulty one fails. Nothing here
  catches a kernel fault to carry on with the plain path: a request whose
  single run also raises fails with that error;
- results are numpy arrays on the host before any Future resolves (the
  potential copies them off the card on the scheduler thread);
- ``drain()`` dispatches everything queued and returns with the queue
  empty and every Future resolved; ``close()`` drains by default, then
  joins the thread;
- the scheduler thread never dies: every dispatch is wrapped so a fault
  resolves the affected Futures and the loop goes on.

Observability (``distmlip_tpu/serve/engine.py:432-1021``): with a
telemetry hub (``telemetry=``, also attached to the potential) each
dispatched batch emits a ``serve_batch`` record (``serve_fallback`` for the
fallback lane) with the per-request queue waits and latencies, the queue
depth, the batch occupancy and the reject, deadline-miss and shed counts,
beside the potential's own ``batched_calculate`` record. With an ``obs``
hub installed (``obs.Observability.enable()``), every request gets a span
tree (``engine.submit`` root, ``engine.queue``, the batch's
``serve.batch`` trace with ``scheduler.plan_batch``, ``batched.pack`` and
``device.dispatch``/``device.compile`` children linked back to its members,
one ``future.resolve`` terminal), the ``distmlip_serve_*`` metrics move, the
SLO monitor observes each resolved request's latency (tenant ``"engine"``),
and the first deadline miss triggers a flight-recorder capture. The request
context crosses to the scheduler thread on the request object; spans there
are emitted against it.

Fleet hooks (``distmlip_tpu/serve/engine.py:259-345``): ``extract_pending()``
hands every queued, undispatched request to the fleet router for
re-dispatch on another replica (their Futures stay unresolved), and
``health_snapshot()`` gives the replica monitor the queue depth, the
in-flight batches, the scheduler's liveness and the age of its last
dispatch progress (``fleet.ReplicaHealth``).

Not ported: the lane built on a mesh's spatial axis (A7).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import threading
import time
import traceback
import warnings
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from ..obs import runtime as obsrt
from ..telemetry import StepRecord
from .scheduler import plan_batch

ADMISSION_MODES = ("reject", "block")


class ServeRejected(RuntimeError):
    """The request was NOT enqueued: the queue is full under
    admission="reject", or the structure's measured memory footprint alone
    exceeds the batched lane's budget (rejected in both modes)."""


class EngineClosed(RuntimeError):
    """submit() after close(), or a pending request flushed by a
    non-draining close."""


@dataclass(order=True)
class _Request:
    """One queued request. Heap order: priority, then earliest deadline,
    then submission order (FIFO within a class)."""

    priority: int
    deadline_abs: float      # absolute clock time; +inf = no deadline
    seq: int
    atoms: object = field(compare=False)
    properties: tuple | None = field(compare=False, default=None)
    future: Future = field(compare=False, default_factory=Future)
    t_submit: float = field(compare=False, default=0.0)
    n_atoms: int = field(compare=False, default=0)
    # obs.tracing.RequestTrace carried across threads (None without a tracer)
    trace: object = field(compare=False, default=None, repr=False)


@dataclass
class ServeStats:
    """Cumulative engine counters."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled: int = 0
    rejected: int = 0
    deadline_misses: int = 0
    shed_count: int = 0          # deadline-shed at assembly (never ran)
    batches: int = 0
    fallback_requests: int = 0
    scheduler_errors: int = 0    # isolated loop faults (the engine survived)
    # bucket_key -> [batches, sum(batch_occupancy), sum(batch_size)]
    buckets: dict = field(default_factory=dict)

    def note_batch(self, bucket_key: str, occupancy: float, size: int):
        b = self.buckets.setdefault(bucket_key, [0, 0.0, 0])
        b[0] += 1
        b[1] += occupancy
        b[2] += size

    def dominant_bucket(self) -> tuple[str, float] | None:
        """(bucket_key, mean batch-slot occupancy) of the bucket that served
        the most batches."""
        if not self.buckets:
            return None
        key = max(self.buckets, key=lambda k: self.buckets[k][0])
        n, occ_sum, _ = self.buckets[key]
        return key, occ_sum / max(n, 1)

    def snapshot(self) -> dict:
        d = {k: v for k, v in vars(self).items() if k != "buckets"}
        d["buckets"] = {k: {"batches": v[0], "mean_batch_occupancy": v[1] / max(v[0], 1),
                            "requests": v[2]}
                        for k, v in self.buckets.items()}
        return d


def _finite_positions(atoms) -> bool:
    return bool(np.isfinite(np.asarray(atoms.positions)).all())


_NULL_CTX = contextlib.nullcontext()


class ServeEngine:
    """Continuous micro-batching scheduler over a shared BatchedPotential.

    Parameters
    ----------
    potential : the shared ``BatchedPotential`` (its ``calculate`` is
        lock-guarded, so a caller sharing it outside the engine stays safe).
    fallback : optional ``DistPotential`` for structures larger than
        ``max_batch_atoms``; without one such requests fail with ValueError.
    max_batch : micro-batch slot budget (a power of two keeps the packed
        slot bucket stable).
    max_wait_s : longest a request waits for co-batching before an
        underfilled batch goes out, on ``clock``.
    max_queue : admission bound on queued (not yet dispatched) requests.
    admission : "reject" (raise ServeRejected when full) or "block" (park
        the submitter until space frees).
    max_batch_atoms : per-structure size ceiling of the batched lane;
        larger structures go to ``fallback``. None disables routing.
    window : how deep past the queue head assembly may scan.
    shed_deadlines : when on, a queued request whose deadline has passed at
        assembly, or provably cannot be met in the next batch judged by the
        EWMA batch service time, fails with ``ServeRejected`` (counted in
        ``stats.shed_count``); off by default (late results are delivered
        and counted in ``deadline_misses``).
    telemetry : a ``telemetry.Telemetry`` hub or None (module docstring);
        attached to the potential and the fallback too.
    clock : monotonic-seconds callable (tests inject a fake clock).
    start : spawn the scheduler thread now (``start=False`` lets tests
        stage a queue first).
    """

    # the tenant the engine's SLO observations are filed under
    SLO_TENANT = "engine"

    def __init__(self, potential, fallback=None, max_batch: int = 8,
                 max_wait_s: float = 0.02, max_queue: int = 256,
                 admission: str = "reject", max_batch_atoms: int | None = None,
                 window: int = 64, shed_deadlines: bool = False, telemetry=None,
                 clock=None, start: bool = True):
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission {admission!r} not in {ADMISSION_MODES}")
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.telemetry = telemetry
        if telemetry is not None:
            for pot in (potential, fallback):
                if hasattr(pot, "attach_telemetry"):
                    pot.attach_telemetry(telemetry)
        self._step = 0
        self._last_plan_attrs: dict = {}
        self.potential = potential
        self.fallback = fallback
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.admission = admission
        self.max_batch_atoms = int(max_batch_atoms) if max_batch_atoms is not None else None
        self.window = int(window)
        self.shed_deadlines = bool(shed_deadlines)
        # EWMA of per-batch service seconds (None until the first dispatch)
        self._service_ewma: float | None = None
        self._real_clock = clock is None
        self._clock = clock if clock is not None else time.monotonic
        self.stats = ServeStats()
        self._cv = threading.Condition()
        self._pending: list[_Request] = []   # heap
        self._seq = itertools.count()
        self._inflight = 0
        self._draining = 0
        self._closed = False     # submit() gate
        self._closing = False    # scheduler exit signal
        # last time the scheduler finished a dispatch round (or sat with an
        # empty queue): the wedge signal health_snapshot() serves
        self._last_progress = self._clock()
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        if self._closed:
            raise EngineClosed("engine already closed")
        self._thread = threading.Thread(target=self._loop, name="distmlip-serve", daemon=True)
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def compile_count(self) -> int:
        """The shared potential's ``compile_count``: distinct shape buckets
        dispatched."""
        return getattr(self.potential, "compile_count", 0)

    def kick(self) -> None:
        """Wake the scheduler (tests call this after advancing a fake clock
        past the max-wait deadline)."""
        with self._cv:
            self._cv.notify_all()

    def extract_pending(self) -> list:
        """Reclaim every request NOT yet dispatched, for re-dispatch
        elsewhere (the fleet router's failover).

        Pops the whole queue at once and returns the ``_Request`` objects in
        dispatch order (priority, deadline, submission), each with its
        ``atoms``, ``properties``, ``priority``, ``deadline_abs``,
        ``t_submit`` and its UNRESOLVED ``future``. The engine then takes no
        new submission (as if closed); batches in flight still complete and
        resolve their own Futures. Unlike ``close(drain=False)`` nothing
        returned here is failed: the caller owns it."""
        with self._cv:
            self._closed = True     # no new submit races the handoff
            reqs = []
            while self._pending:
                reqs.append(heapq.heappop(self._pending))
            self._cv.notify_all()   # blocked submitters see _closed and raise
        return reqs

    @property
    def scheduler_alive(self) -> bool:
        """The scheduler thread exists and is still serving."""
        t = self._thread
        return t is not None and t.is_alive()

    def health_snapshot(self) -> dict:
        """One consistent health sample for a replica monitor: queue depth,
        batches in flight, liveness, and how long ago (on the engine clock)
        the scheduler last made dispatch progress. A wedged engine shows
        queued or in-flight work with a growing ``last_progress_age_s``
        while ``scheduler_alive`` stays True."""
        with self._cv:
            return {
                "queue_depth": len(self._pending),
                "inflight": self._inflight,
                "scheduler_alive": self.scheduler_alive,
                "last_progress_age_s": self._clock() - self._last_progress,
                "completed": self.stats.completed,
                "failed": self.stats.failed,
            }

    def drain(self, timeout: float | None = None) -> bool:
        """Dispatch everything queued (bypassing max-wait) and wait until the
        queue is empty and no batch is in flight: every submitted Future is
        resolved. Returns False on a (real-time) timeout."""
        with self._cv:
            if self._thread is None:
                return not self._pending
            self._draining += 1
            self._cv.notify_all()
            try:
                return self._cv.wait_for(
                    lambda: not self._pending and self._inflight == 0, timeout=timeout)
            finally:
                self._draining -= 1
                self._cv.notify_all()

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop accepting work and shut the scheduler down. ``drain=True``
        flushes queued work first; ``drain=False`` fails still-queued
        requests with ``EngineClosed``. Idempotent."""
        with self._cv:
            if self._closed and self._thread is None:
                return
            self._closed = True
            if self._thread is None:
                drain = False  # no scheduler to flush the queue
            if not drain:
                while self._pending:
                    req = heapq.heappop(self._pending)
                    if req.future.set_running_or_notify_cancel():
                        self._trace_terminal(req, "error")
                        req.future.set_exception(
                            EngineClosed("engine closed before this request was dispatched"))
                        self.stats.failed += 1
            self._closing = True
            self._cv.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, atoms, properties=None, priority: int = 0,
               deadline: float | None = None) -> Future:
        """Enqueue one structure; returns a Future resolving to the result
        dict ``calculate`` gives (trimmed to ``properties`` plus the
        energy when given). ``priority``: lower dispatches first.
        ``deadline``: seconds from now on the engine clock, for
        earliest-deadline-first order within a priority and for the
        deadline-miss count (late results are still delivered)."""
        now = self._clock()
        req = _Request(
            priority=int(priority),
            deadline_abs=now + float(deadline) if deadline is not None else float("inf"),
            seq=next(self._seq), atoms=atoms,
            properties=tuple(properties) if properties is not None else None,
            t_submit=now, n_atoms=len(atoms))
        mx = obsrt.metrics()
        with self._cv:
            if self._closed:
                raise EngineClosed("submit() on a closed engine")
            try:
                self._check_memory_admission(atoms)
                if len(self._pending) >= self.max_queue and self.admission == "reject":
                    self.stats.rejected += 1
                    raise ServeRejected(
                        f"queue full ({self.max_queue} pending); retry later or "
                        f"construct with admission='block'")
            except ServeRejected:
                if mx is not None:
                    mx.counter("distmlip_serve_rejected_total",
                               "admission-rejected requests").inc()
                raise
            if len(self._pending) >= self.max_queue:
                self._cv.wait_for(lambda: len(self._pending) < self.max_queue or self._closed)
                if self._closed:
                    raise EngineClosed("engine closed while blocked on admission")
            self.stats.submitted += 1
            tr = obsrt.tracer()
            if tr is not None:
                # adopt an ambient (outer-layer) request trace, or open a
                # root of our own for a standalone submission
                req.trace = tr.adopt_request()
                if req.trace is None:
                    req.trace = tr.start_request(
                        "engine.submit", attrs={"n_atoms": req.n_atoms,
                                                "priority": req.priority})
            heapq.heappush(self._pending, req)
            if mx is not None:
                mx.counter("distmlip_serve_submitted_total", "accepted engine submissions").inc()
                mx.gauge("distmlip_serve_queue_depth",
                         "requests queued, not yet dispatched").set(len(self._pending))
            self._cv.notify_all()
        return req.future

    def _memory_budget(self) -> int | None:
        return getattr(self.potential, "hbm_budget_bytes", None)

    def _check_memory_admission(self, atoms) -> None:
        """Reject a structure whose MEASURED solo footprint (its own rung ran
        before) exceeds the batched lane's budget: it can never fit a batch,
        and parking it would hang the submitter. An extrapolated estimate
        admits (it runs as a solo probe that measures the rung). Structures
        routed to the fallback lane are exempt."""
        budget = self._memory_budget()
        if budget is None:
            return
        n = len(atoms)
        if self.max_batch_atoms is not None and n > self.max_batch_atoms:
            return
        exact = getattr(getattr(self.potential, "caps", None), "has_calibrated_rung", None)
        if exact is None or not exact(n, getattr(self.potential, "compute_dtype", "float32")):
            return
        est = self.potential.estimate_batch_bytes(n)
        if est is not None and est > budget:
            self.stats.rejected += 1
            raise ServeRejected(
                f"structure of {n} atoms is measured at {est / 2**20:.1f} MiB peak, over "
                f"the batched lane's {budget / 2**20:.1f} MiB budget; send it to a "
                f"DistPotential (the engine's fallback lane via max_batch_atoms)")

    # ------------------------------------------------------------------
    # scheduler loop
    # ------------------------------------------------------------------

    def _wait_timeout(self, oldest_age: float) -> float:
        """How long the scheduler may sleep before re-checking the max-wait
        deadline: the remaining budget on the real clock, a short poll on
        an injected one."""
        if self._real_clock:
            return max(min(self.max_wait_s - oldest_age, 0.05), 0.001)
        return 0.005

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closing:
                    self._last_progress = self._clock()  # idle = healthy
                    self._cv.wait(timeout=0.05)
                if not self._pending and self._closing:
                    return
                now = self._clock()
                oldest = min(r.t_submit for r in self._pending)
                ready = (len(self._pending) >= self.max_batch or self._draining > 0
                         or self._closing or now - oldest >= self.max_wait_s)
                if not ready:
                    self._cv.wait(timeout=self._wait_timeout(now - oldest))
                    continue
                tr = obsrt.tracer()
                t_plan0 = tr.now() if tr is not None else 0.0
                batch, oversized, overbudget, shed = self._assemble_locked(now)
                plan_win = (t_plan0, tr.now()) if tr is not None else None
                self._inflight += 1
                self._cv.notify_all()   # admission slots freed
            try:
                self._run_dispatch(batch, oversized, overbudget, shed, now, plan_win)
            except Exception:  # noqa: BLE001 - the loop must survive
                self.stats.scheduler_errors += 1
                warnings.warn("serve scheduler dispatch fault (isolated):\n"
                              + traceback.format_exc(), stacklevel=1)
                # a fault outside the per-request isolation must still
                # resolve every Future of the round
                for r in batch + oversized + overbudget + shed:
                    if not r.future.done() and (r.future.running()
                                                or r.future.set_running_or_notify_cancel()):
                        self._fail(r, RuntimeError("serve scheduler dispatch fault; see "
                                                   "the warning"))
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._last_progress = self._clock()
                    self._cv.notify_all()

    def _provably_late(self, req: _Request, now: float) -> bool:
        """The deadline has passed, or the request would miss it even in
        the very next batch (judged by the EWMA batch service time)."""
        if req.deadline_abs == float("inf"):
            return False
        if req.deadline_abs <= now:
            return True
        ewma = self._service_ewma
        return ewma is not None and req.deadline_abs < now + ewma

    def _note_service(self, service_s: float) -> None:
        prev = self._service_ewma
        self._service_ewma = service_s if prev is None else 0.7 * prev + 0.3 * service_s

    def _assemble_locked(self, now: float):
        """Pop the next micro-batch, plus the oversized requests seen while
        scanning, a head over the memory budget on its measured rung, and
        (``shed_deadlines``) requests that cannot meet their deadline.
        Called under the lock; returns ``(batch, oversized, overbudget,
        shed)``."""
        window: list[_Request] = []
        limit = max(self.window, self.max_batch)
        while self._pending and len(window) < limit:
            window.append(heapq.heappop(self._pending))
        oversized, normal, shed = [], [], []
        for r in window:
            if self.shed_deadlines and self._provably_late(r, now):
                shed.append(r)
            elif self.max_batch_atoms is not None and r.n_atoms > self.max_batch_atoms:
                oversized.append(r)
            else:
                normal.append(r)
        batch: list[_Request] = []
        overbudget: list[_Request] = []
        if normal:
            plan = plan_batch([r.n_atoms for r in normal],
                              policy=getattr(self.potential, "caps", None),
                              max_batch=self.max_batch, window=limit,
                              bytes_budget=self._memory_budget(),
                              dtype=getattr(self.potential, "compute_dtype", "float32"))
            chosen = set(plan.take)
            self._last_plan_attrs = {"taken": len(plan.take), "window": len(normal),
                                     "over_budget": bool(plan.over_budget)}
            for i, r in enumerate(normal):
                if i in chosen:
                    (overbudget if plan.over_budget else batch).append(r)
                else:
                    heapq.heappush(self._pending, r)  # keeps its queue position
        return batch, oversized, overbudget, shed

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _run_dispatch(self, batch, oversized, overbudget, shed, t_dispatch,
                      plan_win=None) -> None:
        mx = obsrt.metrics()
        for r in self._start_requests(shed):
            self.stats.shed_count += 1
            if mx is not None:
                mx.counter("distmlip_serve_shed_total", "deadline-shed requests").inc()
            why = ("has already passed" if r.deadline_abs <= t_dispatch
                   else "provably cannot be met at the current queue drain rate")
            self._trace_terminal(r, "shed")
            r.future.set_exception(ServeRejected(
                f"deadline shed: the request's deadline {why} (queue wait "
                f"{t_dispatch - r.t_submit:.3f}s); retry with a looser deadline or more "
                f"capacity"))
        for r in self._start_requests(overbudget):
            self._fail(r, ServeRejected(
                f"structure of {r.n_atoms} atoms is measured over the batched lane's "
                f"memory budget (admitted before its rung was measured); send it to a "
                f"DistPotential instead"))
        for req in oversized:
            self._run_fallback(req, t_dispatch)
        if batch:
            self._run_batch(batch, t_dispatch, plan_win)

    def _start_requests(self, requests) -> list[_Request]:
        """Move Futures to running; drop the ones a caller cancelled."""
        live = []
        for r in requests:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self.stats.cancelled += 1
                self._trace_terminal(r, "cancelled")
        return live

    def _trace_terminal(self, req: _Request, status: str) -> None:
        """Close an engine-owned request trace with its one terminal
        ``future.resolve`` span (a no-op for an adopted trace: its owner
        closes it)."""
        if req.trace is None:
            return
        tr = obsrt.tracer()
        if tr is not None:
            tr.finish_request(req.trace, status=status)

    def _observe_slo(self, req: _Request, t_done: float, ok: bool) -> None:
        mon = obsrt.slo()
        if mon is not None:
            mon.observe(self.SLO_TENANT, t_done - req.t_submit, ok=ok)

    def _resolve(self, req: _Request, result: dict, t_done: float) -> None:
        mx = obsrt.metrics()
        if req.deadline_abs < t_done:
            self.stats.deadline_misses += 1
            fl = obsrt.flight()
            if fl is not None:
                # a deadline miss is an incident (rate-limited inside): the
                # recorder keeps the traces and metrics of the moment
                fl.capture("serve deadline miss", attrs={
                    "queue_wait_s": round(t_done - req.t_submit, 6),
                    "n_atoms": req.n_atoms,
                    "deadline_misses": self.stats.deadline_misses})
            if mx is not None:
                mx.counter("distmlip_serve_deadline_miss_total",
                           "requests resolved past their deadline").inc()
        if req.properties is not None:
            keep = set(req.properties) | {"energy"}
            result = {k: v for k, v in result.items() if k in keep}
        self.stats.completed += 1
        if mx is not None:
            mx.counter("distmlip_serve_completed_total", "requests resolved with a result").inc()
            mx.histogram("distmlip_serve_request_latency_seconds",
                         "submit-to-resolve latency").observe(t_done - req.t_submit)
        self._observe_slo(req, t_done, True)
        self._trace_terminal(req, "ok")
        req.future.set_result(result)

    def _fail(self, req: _Request, exc: BaseException) -> None:
        self.stats.failed += 1
        mx = obsrt.metrics()
        if mx is not None:
            mx.counter("distmlip_serve_failed_total",
                       "requests resolved with an explicit error").inc()
        self._observe_slo(req, self._clock(), False)
        self._trace_terminal(req, "error")
        req.future.set_exception(exc)

    def _run_fallback(self, req: _Request, t_dispatch: float) -> None:
        live = self._start_requests([req])
        if not live:
            return
        req = live[0]
        tr = obsrt.tracer()
        t_dev0 = 0.0
        if tr is not None and req.trace is not None:
            # queue wait and dispatch ride the request's own trace (the
            # fallback lane runs one structure: no batch trace)
            t_dev0 = tr.now()
            tr.emit("engine.queue", parent=req.trace.ctx, t_start=req.trace.t_submit,
                    t_end=t_dev0, attrs={"n_atoms": req.n_atoms, "lane": "fallback"})
        t0 = time.perf_counter()
        pot_stats: dict = {}
        try:
            if self.fallback is None:
                raise ValueError(
                    f"structure with {req.n_atoms} atoms exceeds max_batch_atoms="
                    f"{self.max_batch_atoms} and no fallback DistPotential is configured")
            if not _finite_positions(req.atoms):
                raise ValueError("non-finite positions")
            result = self.fallback.calculate(req.atoms)
            pot_stats = dict(getattr(self.fallback, "last_stats", None) or {})
        except Exception as e:  # noqa: BLE001 - isolate to this request
            self._fail(req, e)
            return
        t_done = self._clock()
        self.stats.fallback_requests += 1
        if tr is not None and req.trace is not None:
            tr.emit("device.dispatch", parent=req.trace.ctx, t_start=t_dev0, t_end=tr.now(),
                    attrs={"lane": "fallback"})
        self._resolve(req, result, t_done)
        self._emit_record("serve_fallback", [req], t_dispatch, t_done,
                          service_s=time.perf_counter() - t0, pot_stats=pot_stats,
                          trace_ctx=req.trace.ctx if req.trace is not None else None)

    def _run_batch(self, batch: list[_Request], t_dispatch: float, plan_win=None) -> None:
        batch = self._start_requests(batch)
        # poison screen: non-finite positions would feed NaN through the
        # neighbor build; fail those Futures here and keep the rest
        good = []
        for r in batch:
            if _finite_positions(r.atoms):
                good.append(r)
            else:
                self._fail(r, ValueError("non-finite positions (NaN/inf) in submitted "
                                         "structure"))
        if not good:
            return
        # tracing: close each member's queue wait and open the batch trace,
        # with span links back to every member request
        tr = obsrt.tracer()
        batch_span = None
        if tr is not None:
            t_q = tr.now()
            links = []
            for r in good:
                if r.trace is not None:
                    tr.emit("engine.queue", parent=r.trace.ctx, t_start=r.trace.t_submit,
                            t_end=t_q, attrs={"n_atoms": r.n_atoms})
                    links.append(r.trace.ctx)
            batch_span = tr.begin("serve.batch", new_trace=True, links=links,
                                  t_start=plan_win[0] if plan_win is not None else t_q,
                                  attrs={"batch_size": len(good)})
            if plan_win is not None:
                tr.emit("scheduler.plan_batch", parent=batch_span, t_start=plan_win[0],
                        t_end=plan_win[1], attrs=self._last_plan_attrs)
        t0 = time.perf_counter()
        cc_before = self.compile_count
        pot_stats: dict = {}
        pot_timings: dict = {}
        t_calc_end = 0.0
        try:
            # last_stats is read in the same critical section as the call,
            # so a caller sharing the potential cannot overwrite it between
            lock = getattr(self.potential, "_lock", None)
            with lock if lock is not None else _NULL_CTX:
                # the batch span is the ambient context: the potential's
                # record carries its ids and its range name the trace id
                with tr.use(batch_span) if tr is not None else _NULL_CTX:
                    results = self.potential.calculate([r.atoms for r in good])
                pot_stats = dict(getattr(self.potential, "last_stats", None) or {})
                pot_timings = dict(getattr(self.potential, "last_timings", None) or {})
            if tr is not None:
                t_calc_end = tr.now()
        except Exception:  # noqa: BLE001 - isolated per request below
            results = None
        if results is None:
            # a batch-level fault: run each request alone, so the faulty
            # one fails its own Future and the rest still get results
            for r in good:
                t_r0 = tr.now() if tr is not None else 0.0
                try:
                    r_result = self.potential.calculate([r.atoms])[0]
                except Exception as e:  # noqa: BLE001
                    exc: BaseException | None = e
                else:
                    exc = None
                if tr is not None and r.trace is not None:
                    tr.emit("device.dispatch", parent=r.trace.ctx, t_start=t_r0,
                            t_end=tr.now(), status="ok" if exc is None else "error",
                            attrs={"retry": True})
                if exc is not None:
                    self._fail(r, exc)
                else:
                    self._resolve(r, r_result, self._clock())
            t_done = self._clock()
        else:
            t_done = self._clock()
            for r, res in zip(good, results):
                self._resolve(r, res, t_done)
        # diffed after any singles retries: a retry's B = 1 bucket is new too
        compiled = self.compile_count > cc_before
        if batch_span is not None:
            if results is not None and pot_timings.get("total_s"):
                # the pack and device windows from the potential's own phase
                # timings, anchored at the end of its calculate (one clock)
                t_c0 = t_calc_end - pot_timings["total_s"]
                pack_s = (pot_timings.get("neighbor_s", 0.0) + pot_timings.get("partition_s", 0.0)
                          + pot_timings.get("rebuild_s", 0.0))
                tr.emit("batched.pack", parent=batch_span, t_start=t_c0, t_end=t_c0 + pack_s,
                        attrs={"bucket_key": pot_stats.get("bucket_key", "")})
                tr.emit("device.compile" if compiled else "device.dispatch", parent=batch_span,
                        t_start=t_c0 + pack_s,
                        t_end=t_c0 + pack_s + pot_timings.get("device_s", 0.0),
                        attrs={"compiled": compiled})
            tr.end(batch_span, status="ok" if results is not None else "error",
                   attrs={"bucket_key": pot_stats.get("bucket_key", "")})
        service = time.perf_counter() - t0
        self._note_service(service)
        self.stats.batches += 1
        if results is not None:
            occupancy = (len(good) / pot_stats["batch_slots"]
                         if pot_stats.get("batch_slots") else 1.0)
            self.stats.note_batch(pot_stats.get("bucket_key", ""), occupancy, len(good))
        else:
            # the batch never ran as one packed program (its requests ran as
            # singles): its bucket and occupancy would mislead
            pot_stats = {}
            occupancy = 0.0
        mx = obsrt.metrics()
        if mx is not None:
            mx.counter("distmlip_serve_batches_total", "dispatched micro-batches").inc()
            mx.histogram("distmlip_serve_service_seconds", "batch service time").observe(service)
            mx.gauge("distmlip_serve_batch_occupancy",
                     "real structures / padded batch slots of the last batch").set(occupancy)
            mx.gauge("distmlip_serve_queue_depth",
                     "requests queued, not yet dispatched").set(self.queue_depth)
            mx.gauge("distmlip_serve_compile_count",
                     "shape buckets dispatched by the shared potential").set(self.compile_count)
            if compiled:
                mx.counter("distmlip_serve_compiles_total",
                           "batches that dispatched a new shape bucket").inc()
        self._emit_record("serve_batch", good, t_dispatch, t_done, service_s=service,
                          pot_stats=pot_stats, batch_occupancy=occupancy,
                          trace_ctx=batch_span.ctx if batch_span is not None else None)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _emit_record(self, kind: str, requests, t_dispatch, t_done, service_s: float,
                     pot_stats: dict | None = None, batch_occupancy: float = 1.0,
                     trace_ctx: tuple | None = None) -> None:
        self._step += 1
        tel = self.telemetry
        if tel is None or not tel.wants_records():
            return
        rec = StepRecord(
            trace_id=trace_ctx[0] if trace_ctx is not None else "",
            span_id=trace_ctx[1] if trace_ctx is not None else "",
            step=self._step, kind=kind,
            timings={"service_s": service_s, "total_s": max(t_done - t_dispatch, service_s)},
            batch_size=len(requests),
            batch_occupancy=batch_occupancy,
            queue_depth=self.queue_depth,
            queue_wait_s=[round(t_dispatch - r.t_submit, 6) for r in requests],
            request_latency_s=[round(t_done - r.t_submit, 6) for r in requests],
            reject_count=self.stats.rejected,
            deadline_miss_count=self.stats.deadline_misses,
            shed_count=self.stats.shed_count,
            structures_per_sec=len(requests) / service_s if service_s > 0 else 0.0,
        )
        for k in ("bucket_key", "node_occupancy", "edge_occupancy", "padding_waste_frac",
                  "n_atoms", "rebuild_count", "rebuild_on_device", "rebuild_overflow_count",
                  "num_partitions", "n_cap", "e_cap", "mesh_shape", "spatial_parts",
                  "batch_parts", "halo_send_per_part", "kernel_mode", "kernel_coverage",
                  "est_peak_bytes", "hbm_headroom_frac"):
            if pot_stats and k in pot_stats:
                setattr(rec, k, pot_stats[k])
        tel.emit(rec)
