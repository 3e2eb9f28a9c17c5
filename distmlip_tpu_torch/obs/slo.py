"""Per-tenant latency SLOs with multi-window burn-rate evaluation
(``distmlip_tpu/obs/slo.py``).

The standard SRE alerting shape: an SLO of "``objective`` of requests
complete under ``latency_s``" leaves an error budget of ``1 -
objective``; the *burn rate* over a window is the observed bad-request
fraction divided by that budget (burn 1.0 = exactly spending the budget,
14.4 = spending a 30-day budget in 2 days). A breach fires only when
BOTH a fast window (catches sharp regressions quickly) and a slow window
(rejects blips) exceed their thresholds — the classic multi-window
multi-burn-rate rule, which is what keeps a single slow request from
paging.

On breach the monitor calls ``on_breach(tenant, info)`` — wired by
:class:`~distmlip_tpu_torch.obs.Observability` to the flight recorder, so a
p99 regression on hardware you can't reproduce locally leaves behind a
trace + metrics incident instead of a mystery. Breaches are
cooldown-limited per tenant.

Everything is clock-injectable and lock-guarded (observations arrive
from router completion callbacks on many threads); per-tenant state is a
pruned deque bounded by the slow window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class SLOConfig:
    """One tenant's latency SLO + burn-rate alerting policy."""

    latency_s: float = 1.0        # a request over this is "bad"
    objective: float = 0.99       # target good fraction
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.4       # breach thresholds (burn-rate units)
    slow_burn: float = 6.0
    min_requests: int = 12        # no verdicts on tiny samples
    cooldown_s: float = 300.0     # min seconds between breach firings

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


class _TenantSLO:
    __slots__ = ("config", "events", "good", "bad", "breaches",
                 "last_breach_t")

    def __init__(self, config: SLOConfig):
        self.config = config
        self.events: deque = deque()    # (t, bad: bool)
        self.good = 0
        self.bad = 0
        self.breaches = 0
        self.last_breach_t = None


class SLOMonitor:
    """Observe per-request latencies; evaluate burn rates; fire breaches."""

    def __init__(self, default: SLOConfig | None = None,
                 per_tenant: dict | None = None, clock=None,
                 on_breach=None):
        self.default = default or SLOConfig()
        self.per_tenant = dict(per_tenant or {})
        self._clock = clock or time.monotonic
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantSLO] = {}

    def _state(self, tenant: str) -> _TenantSLO:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantSLO(self.per_tenant.get(tenant, self.default))
            self._tenants[tenant] = st
        return st

    def observe(self, tenant: str, latency_s: float,
                ok: bool = True) -> None:
        """Record one completed request; evaluates (and possibly fires)
        only on BAD events — good traffic costs one deque append."""
        now = self._clock()
        fire = None
        with self._lock:
            st = self._state(tenant)
            bad = (not ok) or latency_s > st.config.latency_s
            st.events.append((now, bad))
            if bad:
                st.bad += 1
            else:
                st.good += 1
            self._prune(st, now)
            if bad:
                fire = self._evaluate_locked(st, tenant, now)
        if fire is not None and self.on_breach is not None:
            self.on_breach(tenant, fire)

    @staticmethod
    def _prune(st: _TenantSLO, now: float) -> None:
        horizon = now - st.config.slow_window_s
        ev = st.events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def _window_burn(self, st: _TenantSLO, now: float,
                     window_s: float) -> tuple[float, int]:
        t0 = now - window_s
        n = bad = 0
        for t, b in reversed(st.events):
            if t < t0:
                break
            n += 1
            bad += int(b)
        if n == 0:
            return 0.0, 0
        return (bad / n) / st.config.error_budget, n

    def burn_rates(self, tenant: str) -> dict:
        """Current {fast, slow} burn rates (+ window sample counts)."""
        now = self._clock()
        with self._lock:
            st = self._state(tenant)
            self._prune(st, now)
            fast, n_fast = self._window_burn(st, now,
                                             st.config.fast_window_s)
            slow, n_slow = self._window_burn(st, now,
                                             st.config.slow_window_s)
        return {"fast": fast, "slow": slow,
                "fast_n": n_fast, "slow_n": n_slow}

    def _evaluate_locked(self, st: _TenantSLO, tenant: str,
                         now: float) -> dict | None:
        cfg = st.config
        fast, n_fast = self._window_burn(st, now, cfg.fast_window_s)
        slow, n_slow = self._window_burn(st, now, cfg.slow_window_s)
        if n_slow < cfg.min_requests:
            return None
        if fast < cfg.fast_burn or slow < cfg.slow_burn:
            return None
        if (st.last_breach_t is not None
                and now - st.last_breach_t < cfg.cooldown_s):
            return None
        st.breaches += 1
        st.last_breach_t = now
        return {
            "tenant": tenant,
            "fast_burn": round(fast, 3), "slow_burn": round(slow, 3),
            "fast_n": n_fast, "slow_n": n_slow,
            "latency_slo_s": cfg.latency_s,
            "objective": cfg.objective,
            "breach_count": st.breaches,
        }

    def snapshot(self) -> dict:
        with self._lock:
            tenants = list(self._tenants.items())
        out = {}
        for name, st in tenants:
            out[name] = {
                "good": st.good, "bad": st.bad, "breaches": st.breaches,
                **self.burn_rates(name),
            }
        return out
