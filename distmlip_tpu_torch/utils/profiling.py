"""Legacy profiling shims (``distmlip_tpu/utils/profiling.py``) —
superseded by ``distmlip_tpu_torch.telemetry``.

``StepTimer`` is subsumed by ``telemetry.AggregatingSink`` (same
aggregation, plus percentiles, occupancy, halo volumes, and the shared
``StepRecord`` schema), and ``device_trace`` lives in ``telemetry.trace``,
where it also enables the host annotations. Both stay importable from here;
new code should attach a ``telemetry.Telemetry`` hub to ``DistPotential``
instead of reading ``last_timings``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from ..telemetry.trace import device_trace  # noqa: F401 - re-export

__all__ = ["StepTimer", "device_trace"]


class StepTimer:
    """Aggregates named phase timings across steps; prints a summary.

    .. deprecated:: use ``telemetry.AggregatingSink`` (accepts the same
        ``add(timings)`` dict surface and full StepRecords).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, timings: dict[str, float]):
        for k, v in timings.items():
            self.totals[k] += v
            self.counts[k] += 1

    def summary(self) -> str:
        lines = ["phase                    total_s   mean_ms  calls"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            n = max(self.counts[k], 1)
            lines.append(
                f"{k:<24} {self.totals[k]:8.3f} {1e3 * self.totals[k] / n:9.2f} {n:6d}"
            )
        return "\n".join(lines)
