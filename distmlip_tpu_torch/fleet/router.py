"""FleetRouter: N serving replicas behind one fair, cached, failover door
(``distmlip_tpu/fleet/router.py``).

One ``ServeEngine`` is a single point of failure and a single queue is a
single victim for any firehose tenant. The router fronts N replicas with:

- **submit(atoms, tenant=, priority=, deadline=, properties=)** — the
  ServeEngine surface plus tenancy. Returns a Future that ALWAYS
  resolves: with a result, or with an explicit per-request error. No
  submitted Future is ever lost, including across replica death.
- **routing** — least-loaded-then-fair: requests queue per tenant under
  stride-scheduled weighted fair queuing (:mod:`.tenancy`), and each
  dispatch goes to the alive replica with the fewest outstanding
  requests (ties broken by total dispatch count, then id). Per-tenant
  token buckets reject over-quota submissions at the door.
- **result cache** — every submission is content-addressed
  (:mod:`.result_cache`); a hit resolves the Future immediately with a
  copy, touching NO replica (the engines' dispatch counters pin this).
  Identical requests already in flight COALESCE onto the running
  computation instead of dispatching twice.
- **failover** — ``fail_over()`` (called by :class:`.replica.
  ReplicaHealth` on a confirmed wedge, or by ``kill_replica()`` in
  chaos drills) marks the replica dead, reclaims its queued requests
  via ``ServeEngine.extract_pending()`` AND its dispatched-but-
  unresolved requests, and re-enqueues them at the head of their
  tenants' queues for dispatch on survivors. A slow original that
  resolves anyway still wins (first resolution takes the Future; the
  duplicate is dropped before dispatch when possible).

Replicas on one card: the in-process replicas share the host's card. Their
device work is serialized per card (``device.device_phase``) so each
replica's measured batch peak is its own, and the router splits the card's
memory budget among them (``calculators.batched.share_device_budget``).
A replica that raises fails its request through the contract above; nothing
here retries on another route.

The cache key's ``precision`` is the replicas' compute dtype
(``BatchedPotential.compute_dtype``), taken from them when not given; a
given one that disagrees, or replicas that disagree, raise. (The JAX
router takes the caller's string as it is.)

Telemetry: one ``StepRecord`` (kind ``fleet_request``) per completed
request carrying ``tenant`` / ``replica_id`` / ``cache_hit``, rendered
by the report's "fleet" section. The AOT executable cache of the JAX
package (``fleet/aot.py``) is not ported (ROADMAP.md A10b): the port's
only compile is the kernels' ``nvcc`` build, cached on disk by
``kernels/build.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

from ..calculators.batched import share_device_budget
from ..obs import runtime as obsrt
from ..serve.engine import EngineClosed, ServeRejected
from ..telemetry import StepRecord
from .replica import Replica
from .result_cache import ResultCache, _copy_result, cache_key
from .tenancy import FairScheduler, TenantConfig

DEFAULT_TENANT = "default"


class FleetError(RuntimeError):
    """Explicit per-request failure after the router exhausted its
    re-dispatch budget (every surviving replica refused or died)."""


class _Routed:
    """One routed request: the caller's Future plus re-dispatch state."""

    __slots__ = ("atoms", "properties", "priority", "deadline_abs",
                 "tenant", "future", "key", "t_submit", "attempts",
                 "current", "replica_id", "done", "waiters", "trace")

    def __init__(self, atoms, properties, priority, deadline_abs, tenant,
                 key, t_submit, trace=None):
        self.atoms = atoms
        self.properties = properties
        self.priority = priority
        self.deadline_abs = deadline_abs
        self.tenant = tenant
        self.future: Future = Future()
        self.key = key
        self.t_submit = t_submit
        self.attempts = 0
        self.current = None          # authoritative engine Future
        self.replica_id = ""
        self.done = False
        # coalesced callers: (future, submit time, RequestTrace | None) —
        # each carries its OWN request trace, resolved when this one is
        self.waiters: list[tuple[Future, float, object]] = []
        self.trace = trace           # obs RequestTrace (router-owned root)


@dataclass
class FleetStats:
    """Cumulative router counters (reads under the router lock)."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    quota_rejected: int = 0
    cache_hits: int = 0
    coalesced: int = 0
    redispatches: int = 0
    failovers: int = 0

    def snapshot(self) -> dict:
        return dict(vars(self))


class FleetRouter:
    """Route submissions across replicas with fairness, caching, failover.

    Parameters
    ----------
    engines : list of ServeEngine (wrapped as in-process replicas with
        ids r0..rN-1) or ready :class:`.replica.Replica` objects.
    tenants : optional {name: TenantConfig} — weights and quotas.
        Unknown tenants are admitted with the default config.
    result_cache : a :class:`ResultCache`, or None to disable caching.
    model_id / precision : fold into the cache key — results from
        different models/dtypes must never alias. ``precision`` defaults to
        the replicas' compute dtype and must equal it when given.
    cache_tol : coordinate bucket width (Å) for structure hashing.
    max_redispatch : failover re-dispatch budget per request before its
        Future fails with :class:`FleetError` (still an EXPLICIT error —
        resolved, never lost).
    max_outstanding : per-replica dispatched-but-unresolved bound (None:
        2x the engine's max_batch, min 8). Backpressure lives HERE: the
        per-tenant queues absorb bursts, so fairness decides dispatch
        order under contention.
    telemetry : optional Telemetry hub for fleet_request records.
    clock : injectable monotonic clock (tests).
    """

    def __init__(self, engines, *, tenants: dict | None = None,
                 result_cache: ResultCache | None = None,
                 model_id: str = "model", precision: str | None = None,
                 cache_tol: float = 1e-5, max_redispatch: int = 3,
                 max_outstanding: int | None = None, telemetry=None,
                 clock=None):
        self._clock = clock or time.monotonic
        self._cv = threading.Condition()
        self.replicas: dict[str, Replica] = {}
        self._caps: dict[str, int] = {}
        for i, item in enumerate(engines):
            rep = item if isinstance(item, Replica) \
                else Replica(item, f"r{i}")
            if rep.replica_id in self.replicas:
                raise ValueError(f"duplicate replica id {rep.replica_id!r}")
            self.replicas[rep.replica_id] = rep
            if max_outstanding is not None:
                cap = int(max_outstanding)
            else:
                cap = max(2 * int(getattr(rep.engine, "max_batch", 4)), 8)
            self._caps[rep.replica_id] = cap
        if not self.replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.cache = result_cache
        self.model_id = str(model_id)
        self.precision = _replica_precision(self.replicas.values(), precision)
        share_device_budget([getattr(r.engine, "potential", None)
                             for r in self.replicas.values()])
        self.cache_tol = float(cache_tol)
        self.max_redispatch = int(max_redispatch)
        self.telemetry = telemetry
        self.stats = FleetStats()
        self._sched = FairScheduler(clock=self._clock)
        for name, cfg in (tenants or {}).items():
            self._sched.configure(name, cfg if isinstance(cfg, TenantConfig)
                                  else TenantConfig(**cfg))
        self._routed_by_future: dict[Future, _Routed] = {}
        self._inflight_by_key: dict[str, _Routed] = {}
        self._closed = False
        self._step_counter = itertools.count(1)
        self._rr = 0    # round-robin tie-break cursor
        mx = obsrt.metrics()
        if mx is not None:
            alive = mx.gauge("distmlip_replica_alive",
                             "replica liveness (1 = serving)",
                             labels=("replica",))
            for rid in self.replicas:
                alive.labels(replica=rid).set(1)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, atoms, properties=None, tenant: str = DEFAULT_TENANT,
               priority: int = 0, deadline: float | None = None) -> Future:
        """Route one structure; the returned Future resolves with the
        same result dict ``ServeEngine.submit`` delivers (or an explicit
        per-request exception). Raises ``ServeRejected`` synchronously
        when the tenant is over its admission quota and ``EngineClosed``
        after ``close()``."""
        now = self._clock()
        tr = obsrt.tracer()
        mx = obsrt.metrics()
        # one ROOT span per submission — cache hits and coalesced
        # duplicates get their own (short) trace too, so span-tree count
        # is conserved: N submissions in, N future.resolve terminals out
        trace = (tr.start_request("fleet.submit",
                                  attrs={"tenant": tenant,
                                         "n_atoms": len(atoms)})
                 if tr is not None else None)
        key = (cache_key(atoms, self.model_id, properties, self.precision,
                         tol=self.cache_tol)
               if self.cache is not None else None)
        # cache lookup outside the router lock (the cache has its own)
        hit = None
        if key is not None and not self._closed:
            hit = self.cache.get(key)
        if hit is not None:
            with self._cv:
                if self._closed:
                    # "rejected" = closed-without-a-Future: the span
                    # gate exempts these roots from the terminal rule
                    self._trace_abort(trace, "rejected")
                    raise EngineClosed("submit() on a closed router")
                self.stats.cache_hits += 1
            if mx is not None:
                self._count_request(mx, tenant)
                mx.counter("distmlip_fleet_cache_hits_total",
                           "submissions served from the result cache"
                           ).inc()
            fut = Future()
            if tr is not None:
                tr.emit("cache.hit", parent=trace.ctx,
                        t_start=trace.t_submit)
                tr.finish_request(trace, "ok")
            fut.set_result(hit)
            self._emit(tenant, "", [0.0], cache_hit=True, trace=trace)
            return fut
        with self._cv:
            if self._closed:
                self._trace_abort(trace, "error")
                raise EngineClosed("submit() on a closed router")
            if key is not None:
                routed = self._inflight_by_key.get(key)
                if routed is not None and not routed.done:
                    # identical request already computing: coalesce
                    fut = Future()
                    routed.waiters.append((fut, now, trace))
                    self.stats.coalesced += 1
                    if mx is not None:
                        self._count_request(mx, tenant)
                        mx.counter(
                            "distmlip_fleet_coalesced_total",
                            "submissions coalesced onto an in-flight "
                            "computation").inc()
                    return fut
            t_adm = tr.now() if tr is not None else 0.0
            if not self._sched.admit(tenant):
                self.stats.quota_rejected += 1
                if mx is not None:
                    mx.counter("distmlip_fleet_quota_rejects_total",
                               "submissions rejected at the tenant "
                               "quota door", labels=("tenant",)
                               ).labels(tenant=tenant).inc()
                if tr is not None:
                    tr.emit("tenancy.admit", parent=trace.ctx,
                            t_start=t_adm, status="rejected",
                            attrs={"tenant": tenant})
                    # rejected at the door: the root closes WITHOUT a
                    # terminal (no Future was ever handed out)
                    tr.end(trace.root, status="rejected")
                raise ServeRejected(
                    f"tenant {tenant!r} is over its admission quota "
                    f"(token bucket empty); retry later")
            if tr is not None:
                tr.emit("tenancy.admit", parent=trace.ctx, t_start=t_adm,
                        attrs={"tenant": tenant})
            routed = _Routed(
                atoms=atoms,
                properties=(tuple(properties) if properties is not None
                            else None),
                priority=int(priority),
                deadline_abs=(now + float(deadline)
                              if deadline is not None else None),
                tenant=tenant, key=key, t_submit=now, trace=trace)
            self.stats.submitted += 1
            if mx is not None:
                self._count_request(mx, tenant)
                mx.gauge("distmlip_tenant_queue_depth",
                         "requests queued per tenant",
                         labels=("tenant",)).labels(tenant=tenant).set(
                             self._sched.queued(tenant) + 1)
            if key is not None:
                self._inflight_by_key[key] = routed
            self._sched.enqueue(tenant, routed)
        self._pump()
        return routed.future

    @staticmethod
    def _count_request(mx, tenant: str) -> None:
        mx.counter("distmlip_fleet_requests_total",
                   "submissions accepted per tenant (routed, cache hits "
                   "and coalesced alike)", labels=("tenant",)
                   ).labels(tenant=tenant).inc()

    @staticmethod
    def _trace_abort(trace, status: str) -> None:
        """Close a root whose submission raised before a Future existed."""
        tr = obsrt.tracer()
        if tr is not None and trace is not None and trace.root is not None:
            tr.end(trace.root, status=status)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _pick_replica_locked(self) -> Replica | None:
        """Least-loaded alive replica with a free outstanding slot."""
        best = None
        candidates = sorted(self.replicas.values(),
                            key=lambda r: r.replica_id)
        n = len(candidates)
        for k in range(n):
            rep = candidates[(self._rr + k) % n]
            if not rep.alive or rep.outstanding >= self._caps[rep.replica_id]:
                continue
            if best is None or (rep.outstanding, rep.dispatched_total) < \
                    (best.outstanding, best.dispatched_total):
                best = rep
        return best

    def _refresh_tenant_gauges_locked(self) -> None:
        """Sync the per-tenant queue-depth gauges with the scheduler
        (called when the pump runs dry — the backlog just changed)."""
        mx = obsrt.metrics()
        if mx is None:
            return
        gauge = mx.gauge("distmlip_tenant_queue_depth",
                         "requests queued per tenant", labels=("tenant",))
        for name, depth in self._sched.queue_depths().items():
            gauge.labels(tenant=name).set(depth)

    def _pump(self) -> None:
        """Dispatch while a replica slot and a fair pick both exist."""
        while True:
            with self._cv:
                rep = self._pick_replica_locked()
                if rep is None:
                    self._refresh_tenant_gauges_locked()
                    return
                nxt = self._sched.pop()
                if nxt is None:
                    self._refresh_tenant_gauges_locked()
                    return
                _tenant, routed = nxt
                if routed.done:
                    continue    # resolved while queued (slow original won)
                rep.outstanding += 1    # reserve before dropping the lock
                self._rr += 1
            self._dispatch(routed, rep)

    def _dispatch(self, routed: _Routed, rep: Replica) -> None:
        deadline = None
        if routed.deadline_abs is not None:
            deadline = max(routed.deadline_abs - self._clock(), 1e-3)
        tr = obsrt.tracer()
        route_span = None
        if tr is not None and routed.trace is not None:
            # retroactive tenant-queue wait: submit -> this dispatch
            # attempt (a failover re-dispatch re-covers from the original
            # submit — the critical-path union handles the overlap)
            tr.emit("router.queue", parent=routed.trace.ctx,
                    t_start=routed.trace.t_submit,
                    attrs={"tenant": routed.tenant,
                           "attempt": routed.attempts})
            route_span = tr.begin(
                "router.route", parent=routed.trace.ctx,
                attrs={"replica": rep.replica_id,
                       "attempt": routed.attempts})
        try:
            if route_span is not None:
                # ambient context hands the request trace to the engine:
                # its engine.queue span parents under this route span
                with tr.use(route_span):
                    fut = rep.engine.submit(
                        routed.atoms, properties=routed.properties,
                        priority=routed.priority, deadline=deadline)
                tr.end(route_span)
            else:
                fut = rep.engine.submit(
                    routed.atoms, properties=routed.properties,
                    priority=routed.priority, deadline=deadline)
        except EngineClosed:
            # the replica died between the pick and the submit: put the
            # request back at the head of its tenant queue and retry on
            # a survivor
            if route_span is not None:
                tr.end(route_span, status="engine_closed")
            with self._cv:
                rep.outstanding -= 1
            self._note_dead(rep, reason="engine closed under dispatch")
            self._requeue(routed)
            return
        except Exception as e:  # noqa: BLE001 - explicit per-request error
            if route_span is not None:
                tr.end(route_span, status="error")
            with self._cv:
                rep.outstanding -= 1
            self._finish(routed, exc=e)
            self._pump()
            return
        with self._cv:
            routed.current = fut
            routed.replica_id = rep.replica_id
            rep.dispatched_total += 1
            self._routed_by_future[fut] = routed
            died_under_us = not rep.alive
        fut.add_done_callback(
            lambda f, r=routed, rp=rep: self._on_engine_done(r, rp, f))
        if died_under_us:
            # the replica was failed over BETWEEN our submit and this
            # bookkeeping: its extract_pending may have reclaimed the
            # engine request before we appeared in the routed map, so
            # nothing would ever resolve this dispatch — reclaim it
            # ourselves (idempotent: guarded on `current`)
            self._reclaim_dispatch(routed, rep, fut)

    def _on_engine_done(self, routed: _Routed, rep: Replica,
                        fut: Future) -> None:
        with self._cv:
            was_tracked = self._routed_by_future.pop(fut, None) is not None
            if was_tracked:
                rep.outstanding = max(rep.outstanding - 1, 0)
            authoritative = routed.current is fut
            self._cv.notify_all()
        exc = None if fut.cancelled() else fut.exception()
        if exc is None and not fut.cancelled():
            # first resolution wins — a reclaimed original beating its
            # re-dispatched copy is a success, not a conflict
            self._finish(routed, result=fut.result())
        elif not authoritative:
            pass    # a failover already re-dispatched this request
        elif isinstance(exc, EngineClosed):
            # replica died with this request queued on it: re-dispatch
            self._note_dead(rep, reason="engine closed mid-request")
            self._requeue(routed)
        elif exc is not None:
            self._finish(routed, exc=exc)
        else:   # cancelled engine future (not a caller-visible state)
            self._requeue(routed)
        self._pump()

    def _reclaim_dispatch(self, routed: _Routed, rep: Replica,
                          fut: Future) -> None:
        """Withdraw one dispatched request from a dead replica (idempotent
        — a no-op unless ``fut`` is still the authoritative dispatch)."""
        with self._cv:
            if routed.done or routed.current is not fut:
                return
            if self._routed_by_future.pop(fut, None) is not None:
                rep.outstanding = max(rep.outstanding - 1, 0)
            routed.current = None
        self._requeue(routed)

    def _requeue(self, routed: _Routed) -> None:
        """Put a reclaimed request back at the head of its tenant queue,
        bounded by the re-dispatch budget."""
        with self._cv:
            if routed.done:
                return
            routed.attempts += 1
            routed.current = None
            routed.replica_id = ""
            alive = any(r.alive for r in self.replicas.values())
            if routed.attempts > self.max_redispatch or not alive:
                budget = (f"re-dispatch budget ({self.max_redispatch}) "
                          f"exhausted" if alive else "no replica alive")
                exc = FleetError(
                    f"request could not be re-dispatched after replica "
                    f"failure: {budget}")
            else:
                self.stats.redispatches += 1
                self._sched.enqueue(routed.tenant, routed, front=True)
                exc = None
        tr = obsrt.tracer()
        if tr is not None and routed.trace is not None:
            tr.emit("router.requeue", parent=routed.trace.ctx,
                    status="ok" if exc is None else "exhausted",
                    attrs={"attempt": routed.attempts})
        mx = obsrt.metrics()
        if mx is not None and exc is None:
            mx.counter("distmlip_fleet_redispatches_total",
                       "failover re-dispatches").inc()
        if exc is not None:
            self._finish(routed, exc=exc)
        else:
            self._pump()

    # ------------------------------------------------------------------
    # completion
    # ------------------------------------------------------------------

    def _finish(self, routed: _Routed, result=None, exc=None) -> None:
        # cache fill BEFORE the done transition (and outside the router
        # lock — ResultCache has its own): a submit racing this window
        # gets a hit instead of missing both the cache and coalescing
        if exc is None and routed.key is not None and not routed.done:
            self.cache.put(routed.key, result)
        with self._cv:
            if routed.done:
                return
            routed.done = True
            if routed.key is not None and \
                    self._inflight_by_key.get(routed.key) is routed:
                del self._inflight_by_key[routed.key]
            waiters = list(routed.waiters)
            if exc is None:
                self.stats.completed += 1 + len(waiters)
            else:
                self.stats.failed += 1 + len(waiters)
            now = self._clock()
            lats = [now - routed.t_submit] + [now - t for _, t, _w in
                                             waiters]
            self._cv.notify_all()
        status = "ok" if exc is None else "error"
        # terminal spans BEFORE resolution: a caller returning from
        # Future.result() must already see its complete span tree
        tr = obsrt.tracer()
        if tr is not None:
            if routed.trace is not None:
                tr.finish_request(routed.trace, status,
                                  attrs={"replica": routed.replica_id})
            for _fut, _t, wtrace in waiters:
                if wtrace is not None:
                    tr.emit("coalesce", parent=wtrace.ctx,
                            t_start=wtrace.t_submit,
                            links=((routed.trace.ctx,)
                                   if routed.trace is not None else ()))
                    tr.finish_request(wtrace, status)
        mon = obsrt.slo()
        if mon is not None:
            for x in lats:
                mon.observe(routed.tenant, x, ok=exc is None)
        mx = obsrt.metrics()
        if mx is not None:
            name = ("distmlip_fleet_completed_total" if exc is None
                    else "distmlip_fleet_failed_total")
            mx.counter(name, "resolved fleet requests per tenant",
                       labels=("tenant",)).labels(
                           tenant=routed.tenant).inc(1 + len(waiters))
            hist = mx.histogram("distmlip_fleet_request_latency_seconds",
                                "submit-to-resolve latency per tenant",
                                labels=("tenant",)).labels(
                                    tenant=routed.tenant)
            for x in lats:
                hist.observe(x)
        # resolution + telemetry outside the lock: done-callbacks and
        # sink writes must not serialize every replica's completions
        if exc is None:
            routed.future.set_result(result)
            for fut, _t, _w in waiters:
                # each coalesced caller gets its OWN copy: one caller
                # mutating a forces array must not corrupt another's
                fut.set_result(_copy_result(result))
        else:
            routed.future.set_exception(exc)
            for fut, _t, _w in waiters:
                fut.set_exception(exc)
        self._emit(routed.tenant, routed.replica_id, lats, cache_hit=False,
                   trace=routed.trace)

    # ------------------------------------------------------------------
    # failover / chaos
    # ------------------------------------------------------------------

    def _note_dead(self, rep: Replica, reason: str = "") -> None:
        with self._cv:
            if not rep.alive:
                return
            rep.alive = False
            self.stats.failovers += 1
            self._cv.notify_all()
        self._obs_failover(rep.replica_id, reason)

    @staticmethod
    def _obs_failover(replica_id: str, reason: str) -> None:
        mx = obsrt.metrics()
        if mx is not None:
            mx.counter("distmlip_fleet_failovers_total",
                       "replicas failed over").inc()
            mx.gauge("distmlip_replica_alive",
                     "replica liveness (1 = serving)",
                     labels=("replica",)).labels(replica=replica_id).set(0)
        fl = obsrt.flight()
        if fl is not None:
            fl.capture(f"replica {replica_id} failed over: "
                       f"{reason or 'unspecified'}",
                       attrs={"replica": replica_id})

    def fail_over(self, replica_id: str, reason: str = "",
                  reclaim_inflight: bool = True) -> int:
        """Mark a replica dead and move its work to survivors.

        Reclaims (1) every request still QUEUED on the replica's engine
        (``extract_pending`` — Futures unresolved by contract) and (2),
        with ``reclaim_inflight``, every request DISPATCHED to it but
        not yet resolved — a wedged engine may never resolve them, and a
        merely-slow one that does resolve later still wins the Future
        (the duplicate is dropped). Returns the number of requests
        re-enqueued; their Futures stay live throughout."""
        with self._cv:
            rep = self.replicas.get(replica_id)
            if rep is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            if not rep.alive:
                return 0
            rep.alive = False
            self.stats.failovers += 1
        self._obs_failover(replica_id, reason)
        # (1) requests still queued on the engine: their Futures are
        # unresolved by extract_pending's contract, so reclaiming is the
        # ONLY way they ever resolve
        reclaim: list[tuple[_Routed, Future]] = []
        for req in rep.engine.extract_pending():
            with self._cv:
                routed = self._routed_by_future.get(req.future)
            if routed is not None:
                reclaim.append((routed, req.future))
        # (2) requests dispatched to the replica and not yet resolved: a
        # wedged engine may never resolve them; a merely-slow one that
        # does still wins the Future (first resolution takes it)
        if reclaim_inflight:
            seen = {id(r) for r, _ in reclaim}
            with self._cv:
                reclaim.extend(
                    (r, f) for f, r in list(self._routed_by_future.items())
                    if r.replica_id == replica_id and not r.done
                    and r.current is f and id(r) not in seen)
        # head-of-queue requeue in REVERSE so the original dispatch order
        # is preserved at the front of each tenant queue
        n = 0
        for routed, fut in reversed(reclaim):
            before = routed.done
            self._reclaim_dispatch(routed, rep, fut)
            n += int(not before)
        self._pump()
        return n

    def kill_replica(self, replica_id: str,
                     timeout: float | None = 30.0) -> int:
        """Chaos drill: the replica is lost mid-flight.

        Fails the replica over (queued + dispatched requests move to
        survivors), then force-closes its engine without draining. An
        in-process engine's in-flight batch still completes — if it
        resolves before the re-dispatched copy, that result wins and the
        copy is dropped. Returns the number of requests re-enqueued."""
        n = self.fail_over(replica_id, reason="chaos: replica killed")
        self.replicas[replica_id].engine.close(drain=False, timeout=timeout)
        return n

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def backlog(self) -> int:
        with self._cv:
            return self._sched.backlog()

    @property
    def outstanding(self) -> int:
        with self._cv:
            return sum(r.outstanding for r in self.replicas.values())

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until every accepted request has resolved (router queues
        empty, no dispatched request outstanding). False on timeout."""
        for rep in self.replicas.values():
            if rep.alive:
                rep.engine.kick()
        with self._cv:
            return self._cv.wait_for(
                lambda: self._sched.backlog() == 0
                and not self._routed_by_future
                and all(r.outstanding == 0
                        for r in self.replicas.values()),
                timeout=timeout)

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        """Stop accepting work; optionally drain; close every engine."""
        with self._cv:
            if self._closed:
                closed_already = True
            else:
                closed_already = False
                self._closed = True
        if drain and not closed_already:
            self.drain(timeout=timeout)
        if closed_already:
            return
        # fail anything still queued (drain=False, or drain timed out)
        while True:
            with self._cv:
                nxt = self._sched.pop()
            if nxt is None:
                break
            self._finish(nxt[1], exc=EngineClosed(
                "router closed before this request was dispatched"))
        for rep in self.replicas.values():
            rep.engine.close(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # introspection / telemetry
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative fleet state: router counters, per-tenant scheduler
        stats, per-replica dispatch/load, cache stats."""
        with self._cv:
            out = {
                "stats": self.stats.snapshot(),
                "tenants": self._sched.stats(),
                "replicas": {
                    rid: {"alive": rep.alive,
                          "outstanding": rep.outstanding,
                          "dispatched_total": rep.dispatched_total,
                          "compile_count": getattr(
                              rep.engine, "compile_count", 0)}
                    for rid, rep in self.replicas.items()},
            }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def _emit(self, tenant: str, replica_id: str,
              latencies: list[float], cache_hit: bool,
              trace=None) -> None:
        """Emit one fleet_request record. Called OUTSIDE the router lock
        (sink writes must not serialize completions); the step counter is
        its own atomic source. ``aot_rehydrated`` is deliberately NOT set
        here — per-request attribution from the potential's mutable
        ``last_dispatch_aot`` races the next dispatch; the engine's
        ``serve_batch`` and the potential's ``batched_calculate`` records
        carry the flag snapshotted at dispatch time, and the report
        counts those."""
        tel = self.telemetry
        if tel is None or not tel.wants_records():
            return
        rec = StepRecord(
            step=next(self._step_counter), kind="fleet_request",
            timings={"total_s": max(latencies)},
            trace_id=trace.trace_id if trace is not None else "",
            span_id=trace.span_id if trace is not None else "",
            tenant=tenant, replica_id=replica_id, cache_hit=cache_hit,
            batch_size=len(latencies),
            request_latency_s=[round(x, 6) for x in latencies],
            extra={"failover_count": self.stats.failovers,
                   "cache_hit_count": self.stats.cache_hits,
                   "coalesced_count": self.stats.coalesced,
                   "redispatch_count": self.stats.redispatches,
                   "cache_evictions": (self.cache.evictions
                                       if self.cache is not None else 0)},
        )
        tel.emit(rec)


def _replica_precision(replicas, precision) -> str:
    """The cache key's precision: the replicas' compute dtype. Raises when
    replicas disagree, or when ``precision`` is given and differs."""
    dtypes = {getattr(r.engine.potential, "compute_dtype")
              for r in replicas
              if hasattr(getattr(r.engine, "potential", None), "compute_dtype")}
    if len(dtypes) > 1:
        raise ValueError(f"replicas compute in different dtypes {sorted(dtypes)}: one "
                         f"router's result cache cannot key them under one precision")
    if not dtypes:
        return str(precision) if precision is not None else "float32"
    (dtype,) = dtypes
    if precision is not None and str(precision) != dtype:
        raise ValueError(f"precision={precision!r} but the replicas compute in {dtype!r}; "
                         f"the cache key must name what the replicas compute")
    return dtype


def make_fleet(n_replicas: int, potential_factory, *, engine_kwargs=None,
               aot_cache_dir: str | None = None, **router_kwargs
               ) -> FleetRouter:
    """Convenience constructor for an IN-PROCESS fleet (tests, demos,
    single-host serving): ``potential_factory(i)`` builds replica ``i``'s
    ``BatchedPotential`` (each replica needs its OWN: its own skin cache
    and bucket set, its own scheduler thread), and ``engine_kwargs`` feed
    each ``ServeEngine``. ``aot_cache_dir`` raises: the AOT executable
    cache is not ported (ROADMAP.md A10b)."""
    from ..serve import ServeEngine

    if aot_cache_dir is not None:
        raise NotImplementedError(
            "make_fleet(aot_cache_dir=...): the AOT executable cache is not ported "
            "(ROADMAP.md A10b); the port's kernels are built once by nvcc and cached "
            "on disk (kernels/build.py), and there is no per-bucket executable to persist")
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    engines = [ServeEngine(potential_factory(i), **dict(engine_kwargs or {}))
               for i in range(n_replicas)]
    return FleetRouter(engines, **router_kwargs)
