"""Serving replicas and the wedge-detecting health monitor
(``distmlip_tpu/fleet/replica.py``).

A :class:`Replica` wraps one :class:`~distmlip_tpu_torch.serve.ServeEngine`
(its own ``BatchedPotential``, its own scheduler thread) with the state the
router needs: an id, an alive flag, and the dispatch bookkeeping for
least-loaded routing. In the port the in-process replicas of one host share
its card (each replica's device work takes the card's phase lock,
``device.device_phase``); in the JAX package each owns a chip.

:class:`ReplicaHealth` watches every replica with the suspicion discipline
of :class:`~distmlip_tpu_torch.utils.health.ReprobePolicy`: a replica whose
scheduler thread died, or which holds queued or in-flight work without
dispatch progress for ``stall_budget_s``, is SUSPECT; bounded re-probes
with backoff either observe recovery or confirm the wedge, and then the
monitor fails the replica over through the router, which reclaims its
queued requests and re-dispatches them on survivors: the wedge costs
latency, never Futures.
"""

from __future__ import annotations

import threading
import time

from ..obs import runtime as obsrt
from ..utils.health import ReprobePolicy


class Replica:
    """One engine behind the router."""

    def __init__(self, engine, replica_id: str):
        self.engine = engine
        self.replica_id = str(replica_id)
        self.alive = True
        # router-side dispatch bookkeeping (guarded by the ROUTER lock)
        self.outstanding = 0
        self.dispatched_total = 0

    def health_snapshot(self) -> dict:
        snap_fn = getattr(self.engine, "health_snapshot", None)
        if snap_fn is None:
            return {"scheduler_alive": True, "queue_depth": 0,
                    "inflight": 0, "last_progress_age_s": 0.0}
        return snap_fn()

    def healthy(self, stall_budget_s: float) -> bool:
        """Liveness + progress: the scheduler thread is serving, and any
        held work has seen dispatch progress within the stall budget."""
        if not self.alive:
            return False
        snap = self.health_snapshot()
        if not snap["scheduler_alive"]:
            return False
        busy = snap["queue_depth"] > 0 or snap["inflight"] > 0
        return not (busy and snap["last_progress_age_s"] > stall_budget_s)


class ReplicaHealth:
    """Poll replicas; confirm wedges via bounded re-probe; fail over.

    ``router`` must expose ``replicas`` (id -> Replica) and
    ``fail_over(replica_id, reason=...)``. ``poll_once()`` is the
    deterministic test surface; ``start()`` runs it on a daemon thread
    every ``interval_s``. ``clock`` is injectable (tests share a fake
    clock with the engines so stall ages and backoff windows advance
    together).

    ``stall_budget_s`` (default 300 s) MUST exceed the fleet's worst
    cold start: a replica building its kernels (``nvcc`` on a cold build
    cache) or running its first batch makes no dispatch progress and is
    indistinguishable from a wedge by this probe. As a backstop, the monitor never auto-fails-over
    the LAST alive replica (killing it converts "slow" into a total
    self-inflicted outage; a confirmed wedge there is reported as
    ``"wedged"`` for the operator, and ``router.fail_over`` remains
    available as an explicit action)."""

    def __init__(self, router, interval_s: float = 1.0,
                 stall_budget_s: float = 300.0, max_reprobes: int = 1,
                 backoff_s: float = 1.0, clock=None, start: bool = False):
        self.router = router
        self.interval_s = float(interval_s)
        self.stall_budget_s = float(stall_budget_s)
        self.max_reprobes = int(max_reprobes)
        self.backoff_s = float(backoff_s)
        self._clock = clock or time.monotonic
        self._policies: dict[str, ReprobePolicy] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.failovers = 0
        if start:
            self.start()

    def _policy(self, replica_id: str) -> ReprobePolicy:
        pol = self._policies.get(replica_id)
        if pol is None:
            pol = ReprobePolicy(max_reprobes=self.max_reprobes,
                                backoff_s=self.backoff_s, clock=self._clock)
            self._policies[replica_id] = pol
        return pol

    def poll_once(self) -> dict:
        """One probe sweep; returns {replica_id: "healthy" | "suspect" |
        "wedged" | "dead"} (dead = already failed over / killed)."""
        verdicts = {}
        for rid, replica in list(self.router.replicas.items()):
            if not replica.alive:
                verdicts[rid] = "dead"
                continue
            verdict = self._policy(rid).observe(
                replica.healthy(self.stall_budget_s))
            verdicts[rid] = verdict
            if verdict in ("suspect", "wedged"):
                # first wedge SUSPICION is already flight-recorder
                # material: by the time the wedge is confirmed and the
                # failover reclaims the queue, the interesting state
                # (span trees of the stalled requests, queue-depth
                # gauges) is gone. Rate-limited inside the recorder.
                fl = obsrt.flight()
                if fl is not None:
                    fl.capture(
                        f"replica {rid} {verdict}: no dispatch progress "
                        f"within {self.stall_budget_s:.0f}s",
                        attrs={"replica": rid,
                               **replica.health_snapshot()})
            if verdict == "wedged":
                alive_others = any(
                    r.alive for other_id, r in self.router.replicas.items()
                    if other_id != rid)
                if not alive_others:
                    continue    # never auto-kill the last alive replica
                self.failovers += 1
                self.router.fail_over(
                    rid, reason=(f"health monitor: no dispatch progress "
                                 f"within {self.stall_budget_s:.0f}s after "
                                 f"{self.max_reprobes} re-probe(s)"))
        return verdicts

    # ---- background thread ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="distmlip-fleet-health", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the monitor must survive
                pass

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
