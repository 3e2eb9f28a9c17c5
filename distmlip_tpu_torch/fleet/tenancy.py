"""Per-tenant admission quotas and weighted fair scheduling
(``distmlip_tpu/fleet/tenancy.py``; host-only, the same sequences).

Two pure, thread-unsafe-by-design primitives (the router serializes
access under its own lock; tests drive them directly with fake clocks):

- :class:`TokenBucket` — the admission quota. A tenant's submissions
  spend tokens that refill at ``rate_hz`` up to ``burst``; an empty
  bucket means the submit is REJECTED at the router door
  (``ServeRejected``), so one screening firehose exhausts its own quota
  instead of the fleet's queues. ``rate_hz=None`` disables the quota
  (interactive tenants are typically unmetered and protected by
  fairness, not by a cap).

- :class:`FairScheduler` — weighted fair queuing over per-tenant FIFO
  queues via stride scheduling: each tenant carries a virtual ``pass``
  value advanced by ``1/weight`` per dispatched request, and ``pop()``
  always serves the backlogged tenant with the smallest pass. A
  weight-3 tenant therefore gets 3x the dispatch slots of a weight-1
  tenant under contention, and ANY backlogged tenant is served within
  one full rotation — no starvation, regardless of how deep another
  tenant's backlog is. An idle tenant's pass is clamped forward on its
  next enqueue so sleeping never banks credit.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass


@dataclass
class TenantConfig:
    """Declarative per-tenant policy (router ``tenants=`` mapping).

    ``weight``: fair-share weight under contention (default 1.0).
    ``rate_hz``: token-bucket refill rate in requests/sec; None = no
    quota. ``burst``: bucket capacity (default: 2 s worth of rate,
    minimum 1)."""

    weight: float = 1.0
    rate_hz: float | None = None
    burst: float | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.rate_hz is not None and self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0, got {self.rate_hz}")


class TokenBucket:
    """Classic token bucket on an injectable monotonic clock."""

    def __init__(self, rate_hz: float, burst: float | None = None,
                 clock=None):
        if rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")
        self.rate_hz = float(rate_hz)
        self.burst = float(burst) if burst is not None \
            else max(2.0 * rate_hz, 1.0)
        self._clock = clock or time.monotonic
        self.tokens = self.burst
        self._t_last = self._clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t_last) * self.rate_hz)
        self._t_last = now

    def take(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available; False = over quota."""
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class _TenantState:
    __slots__ = ("name", "weight", "bucket", "queue", "pass_value",
                 "submitted", "dispatched", "quota_rejects")

    def __init__(self, name: str, config: TenantConfig, clock):
        self.name = name
        self.weight = float(config.weight)
        self.bucket = (TokenBucket(config.rate_hz, config.burst, clock=clock)
                       if config.rate_hz is not None else None)
        self.queue: deque = deque()
        self.pass_value = 0.0
        self.submitted = 0
        self.dispatched = 0
        self.quota_rejects = 0


class FairScheduler:
    """Stride-scheduled weighted fair queuing over named tenant queues."""

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self._tenants: dict[str, _TenantState] = {}
        self._global_pass = 0.0

    def tenant(self, name: str,
               config: TenantConfig | None = None) -> _TenantState:
        """Get-or-create a tenant (unknown tenants get default policy)."""
        st = self._tenants.get(name)
        if st is None:
            st = _TenantState(name, config or TenantConfig(), self._clock)
            # late joiners start at the current virtual time, not at 0 —
            # otherwise a new tenant would monopolize dispatch until its
            # pass catches up with the long-running tenants'
            st.pass_value = self._global_pass
            self._tenants[name] = st
        return st

    def configure(self, name: str, config: TenantConfig) -> None:
        st = self.tenant(name, config)
        st.weight = float(config.weight)
        st.bucket = (TokenBucket(config.rate_hz, config.burst,
                                 clock=self._clock)
                     if config.rate_hz is not None else None)

    def admit(self, name: str) -> bool:
        """Charge the tenant's quota for one submission; False = over."""
        st = self.tenant(name)
        if st.bucket is not None and not st.bucket.take(1.0):
            st.quota_rejects += 1
            return False
        st.submitted += 1
        return True

    def enqueue(self, name: str, item, front: bool = False) -> None:
        """Queue an admitted item. ``front=True`` re-queues a reclaimed
        (failover) item at the head WITHOUT a fresh pass charge — a
        request should not lose its place because its replica died."""
        st = self.tenant(name)
        if front:
            st.queue.appendleft(item)
            # refund the stride the original dispatch charged
            st.pass_value = max(st.pass_value - 1.0 / st.weight,
                                self._global_pass - 1.0 / st.weight)
        else:
            if not st.queue:
                # waking from idle: clamp forward so sleeping banks nothing
                st.pass_value = max(st.pass_value, self._global_pass)
            st.queue.append(item)

    def pop(self):
        """``(tenant_name, item)`` of the next fair dispatch, or None.

        Serves the backlogged tenant with the smallest pass value
        (ties: name order, deterministic) and advances its pass by
        ``1/weight``."""
        best = None
        for st in self._tenants.values():
            if not st.queue:
                continue
            if best is None or (st.pass_value, st.name) < (best.pass_value,
                                                           best.name):
                best = st
        if best is None:
            return None
        item = best.queue.popleft()
        best.pass_value += 1.0 / best.weight
        best.dispatched += 1
        self._global_pass = max(self._global_pass, best.pass_value)
        return best.name, item

    def backlog(self) -> int:
        return sum(len(st.queue) for st in self._tenants.values())

    def queued(self, name: str) -> int:
        st = self._tenants.get(name)
        return len(st.queue) if st is not None else 0

    def queue_depths(self) -> dict[str, int]:
        """Per-tenant backlog snapshot (the router's live queue-depth
        gauges read this under its own lock)."""
        return {name: len(st.queue)
                for name, st in self._tenants.items()}

    def stats(self) -> dict:
        return {name: {"weight": st.weight,
                       "submitted": st.submitted,
                       "dispatched": st.dispatched,
                       "queued": len(st.queue),
                       "quota_rejects": st.quota_rejects}
                for name, st in self._tenants.items()}
