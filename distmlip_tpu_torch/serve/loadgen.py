"""Load generation against a ServeEngine: closed- and open-loop drivers
(``distmlip_tpu/serve/loadgen.py``).

- **closed loop** (``run_closed_loop``): ``concurrency`` workers each keep
  exactly one request outstanding (submit, wait, repeat): best-case
  service latency and saturation throughput at a fixed concurrency;
- **open loop** (``run_open_loop``): requests arrive on their own schedule
  (Poisson by default, or all at once with ``rate_hz <= 0``) regardless of
  completions, as user traffic does; queue waits show in the latency tail.

Both return a ``LoadReport``: p50/p95/p99 latency, structures/s and the
engine's stats snapshot.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .engine import ServeRejected


def percentile(sorted_xs: list[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY SORTED sample list
    (``distmlip_tpu/telemetry/record.py:265``)."""
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    return sorted_xs[min(n - 1, int(q * (n - 1) + 0.5))]


@dataclass
class LoadReport:
    """Outcome of one load-generation run."""

    mode: str = "closed"
    n_requests: int = 0
    n_ok: int = 0
    n_failed: int = 0
    n_rejected: int = 0
    wall_s: float = 0.0
    latencies_s: list[float] = field(default_factory=list)
    engine_stats: dict = field(default_factory=dict)

    @property
    def structures_per_sec(self) -> float:
        return self.n_ok / self.wall_s if self.wall_s > 0 else 0.0

    def latency_percentiles(self) -> dict:
        xs = sorted(self.latencies_s)
        return {"p50_s": percentile(xs, 0.50), "p95_s": percentile(xs, 0.95),
                "p99_s": percentile(xs, 0.99), "max_s": xs[-1] if xs else 0.0}

    def summary(self) -> dict:
        p = self.latency_percentiles()
        return {
            "mode": self.mode, "requests": self.n_requests, "ok": self.n_ok,
            "failed": self.n_failed, "rejected": self.n_rejected,
            "wall_s": round(self.wall_s, 4),
            "structures_per_sec": round(self.structures_per_sec, 2),
            "latency_p50_ms": round(1e3 * p["p50_s"], 2),
            "latency_p95_ms": round(1e3 * p["p95_s"], 2),
            "latency_p99_ms": round(1e3 * p["p99_s"], 2),
        }


def run_closed_loop(engine, structures, n_requests: int, concurrency: int = 4,
                    priority_fn=None) -> LoadReport:
    """``concurrency`` workers round-robin over ``structures``, each with one
    request outstanding, until ``n_requests`` have been issued."""
    rep = LoadReport(mode="closed", n_requests=int(n_requests))
    counter = {"next": 0}
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = counter["next"]
                if i >= n_requests:
                    return
                counter["next"] = i + 1
            prio = priority_fn(i) if priority_fn else 0
            t0 = time.perf_counter()
            try:
                engine.submit(structures[i % len(structures)], priority=prio).result()
            except ServeRejected:
                with lock:
                    rep.n_rejected += 1
                continue
            except Exception:  # noqa: BLE001 - per-request failure counted
                with lock:
                    rep.n_failed += 1
                continue
            with lock:
                rep.n_ok += 1
                rep.latencies_s.append(time.perf_counter() - t0)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, int(concurrency)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.drain()
    rep.wall_s = time.perf_counter() - t_start
    rep.engine_stats = engine.stats.snapshot()
    return rep


def run_open_loop(engine, structures, n_requests: int, rate_hz: float, rng=None,
                  poisson: bool = True) -> LoadReport:
    """Submit on an arrival schedule independent of completions: mean rate
    ``rate_hz``, exponential gaps when ``poisson`` (else a fixed period);
    ``rate_hz <= 0`` submits everything at once (burst)."""
    rng = rng or np.random.default_rng(0)
    rep = LoadReport(mode="open", n_requests=int(n_requests))
    lat_lock = threading.Lock()
    submit_times: list[float] = []
    futures = []

    def on_done(t_sub):
        # the completion time is taken when the Future resolves (on the
        # scheduler thread), not when the driver harvests it
        def cb(fut):
            t_done = time.perf_counter()
            if fut.exception() is None:
                with lat_lock:
                    rep.latencies_s.append(t_done - t_sub)
        return cb

    t_start = time.perf_counter()
    for i in range(n_requests):
        if rate_hz > 0 and i > 0:
            gap = rng.exponential(1.0 / rate_hz) if poisson else 1.0 / rate_hz
            # an absolute schedule: a slow submit does not stretch the rate
            target = submit_times[-1] + gap
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
        t_sub = time.perf_counter()
        try:
            fut = engine.submit(structures[i % len(structures)])
            fut.add_done_callback(on_done(t_sub))
            futures.append(fut)
        except ServeRejected:
            rep.n_rejected += 1
        submit_times.append(t_sub)
    for fut in futures:
        try:
            fut.result()
        except Exception:  # noqa: BLE001 - per-request failure counted
            rep.n_failed += 1
            continue
        rep.n_ok += 1
    rep.wall_s = time.perf_counter() - t_start
    rep.engine_stats = engine.stats.snapshot()
    return rep
