"""Pluggable telemetry sinks and the Telemetry hub
(``distmlip_tpu/telemetry/sinks.py``).

A sink receives every ``StepRecord`` a producer emits. Three in-repo sinks
cover the paper-analysis workflow end to end:

- ``AggregatingSink`` — in-memory per-phase totals/percentile buffers; the
  successor of ``utils.profiling.StepTimer`` (same summary table, plus
  occupancy/halo columns).
- ``JsonlSink`` — one JSON object per line; the artifact
  ``python -m distmlip_tpu_torch.telemetry.report`` aggregates offline.
- ``StderrSummarySink`` — periodic one-line progress for interactive runs.

``Telemetry`` is the hub a producer holds: ``emit()`` fans a record out to
every sink. A disabled hub (or one with no sinks) is a cheap no-op — the
producers guard record CONSTRUCTION on ``wants_records()`` so the disabled
path does no per-step work at all.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict

from .record import StepRecord, format_phase_table, phase_stats_from_samples


class TelemetrySink:
    """Base sink: override ``emit``; ``close`` flushes/releases resources."""

    def emit(self, record: StepRecord) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class AggregatingSink(TelemetrySink):
    """In-memory per-phase aggregation (StepTimer's successor).

    Keeps totals/counts per phase plus a bounded per-phase sample buffer so
    ``summary()`` can print percentiles; also tracks occupancy extremes and
    rebuild/compile counts across the run.

    Memory is O(max_samples) per phase, not O(steps): past the cap the
    buffer is decimated 2:1 and subsequent samples are kept with the same
    stride, so week-long MD runs aggregate at constant memory and the
    percentiles stay a uniform (approximate) sample of the whole run.
    """

    def __init__(self, max_samples: int = 8192):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.max_samples = max(2, int(max_samples))
        self._stride: dict[str, int] = defaultdict(lambda: 1)
        self.n_records = 0
        self.rebuilds = 0
        self.prefetch_adopted = 0
        self.compiles = 0
        self.min_node_occupancy = None
        self.min_edge_occupancy = None
        self.max_halo_imbalance = 0.0

    def emit(self, record: StepRecord) -> None:
        self.n_records += 1
        for k, v in record.timings.items():
            self.totals[k] += float(v)
            self.counts[k] += 1
            if (self.counts[k] - 1) % self._stride[k] == 0:
                buf = self.samples[k]
                buf.append(float(v))
                if len(buf) >= self.max_samples:
                    del buf[::2]
                    self._stride[k] *= 2
        self.rebuilds += int(record.rebuild)
        self.prefetch_adopted += int(record.prefetch_adopted)
        self.compiles += int(record.compiled)
        if record.node_occupancy:
            m = self.min_node_occupancy
            self.min_node_occupancy = (record.node_occupancy if m is None
                                       else min(m, record.node_occupancy))
        if record.edge_occupancy:
            m = self.min_edge_occupancy
            self.min_edge_occupancy = (record.edge_occupancy if m is None
                                       else min(m, record.edge_occupancy))
        if record.halo_send_per_part:  # matches report.py: no halo, no stat
            self.max_halo_imbalance = max(self.max_halo_imbalance,
                                          record.halo_imbalance())

    # StepTimer-compatible surface so existing call sites can migrate by
    # swapping the object
    def add(self, timings: dict[str, float]) -> None:
        self.emit(StepRecord(timings=dict(timings)))

    def phase_stats(self, name: str) -> dict:
        # true total/count (samples may be a decimated subset)
        return phase_stats_from_samples(
            self.samples.get(name, []), total_s=self.totals.get(name, 0.0),
            count=self.counts.get(name, 0))

    def summary(self) -> str:
        lines = [format_phase_table(
            {k: self.phase_stats(k) for k in self.totals})]
        if self.n_records:
            occ_n = self.min_node_occupancy
            occ_e = self.min_edge_occupancy
            lines.append(
                f"records={self.n_records} rebuilds={self.rebuilds} "
                f"prefetch_adopted={self.prefetch_adopted} "
                f"compiles={self.compiles}"
                + (f" min_node_occ={occ_n:.2f}" if occ_n is not None else "")
                + (f" min_edge_occ={occ_e:.2f}" if occ_e is not None else "")
                + (f" max_halo_imbalance={self.max_halo_imbalance:.2f}"
                   if self.max_halo_imbalance else ""))
        return "\n".join(lines)


class JsonlSink(TelemetrySink):
    """Write records to a JSONL file, one object per line.

    Lines are flushed per record so a killed run (the round-5 wedge class
    of failure) still leaves every completed step on disk. Default mode
    "w" starts a fresh artifact — one file is one run, which is what the
    report's medians/anomaly thresholds assume; pass mode="a" to append
    deliberately (e.g. resuming a run into the same file).

    Thread-safe: the serving engine's scheduler thread and caller threads
    emit into one sink concurrently, so each record is serialized OUTSIDE
    the lock and written as one line-atomic ``write`` under it — lines
    never interleave and ``close()`` flushes whatever was emitted.

    Size-bounded rotation: with ``max_bytes`` set, a write that carries
    the file past the bound closes it and atomically renames it to
    ``<path>.1`` (existing rotated files shift ``.1 -> .2 -> ...``; at
    most ``keep`` rotated files survive, the oldest is dropped), then
    reopens ``path`` fresh — a long ``--fleet`` soak holds at most
    ``(keep + 1) * max_bytes`` on disk instead of one unbounded file.
    Rotation never splits a record: the bound is checked AFTER each
    line-atomic write. ``stats()`` reports lines/bytes/rotations.
    """

    def __init__(self, path: str, mode: str = "w",
                 max_bytes: int | None = None, keep: int = 3):
        if mode not in ("w", "a", "x"):
            raise ValueError(f"mode {mode!r} not in ('w', 'a', 'x')")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.path = str(path)
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self.keep = max(1, int(keep))
        self.rotations = 0
        self.lines = 0
        self._lock = threading.Lock()
        self._f = open(self.path, mode, buffering=1)

    def emit(self, record: StepRecord) -> None:
        line = record.to_json() + "\n"   # serialize outside the lock
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self.lines += 1
            if (self.max_bytes is not None
                    and self._f.tell() >= self.max_bytes):
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        import os

        self._f.flush()
        self._f.close()
        # shift .1 -> .2 -> ... (the old .keep is overwritten = dropped)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "w", buffering=1)
        self.rotations += 1

    def rotated_paths(self) -> list[str]:
        """Existing rotated artifacts, newest first (.1, .2, ...)."""
        import os

        out = []
        for i in range(1, self.keep + 1):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "lines": self.lines,
                    "rotations": self.rotations,
                    "bytes_current": (self._f.tell()
                                      if not self._f.closed else 0),
                    "max_bytes": self.max_bytes, "keep": self.keep}

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class StderrSummarySink(TelemetrySink):
    """One compact stderr line every ``every`` records (and on close)."""

    def __init__(self, every: int = 50, stream=None):
        self.every = max(1, int(every))
        self.stream = stream if stream is not None else sys.stderr
        self._n = 0
        self._t0 = time.time()
        self._last: StepRecord | None = None

    def _line(self, rec: StepRecord) -> str:
        t = rec.timings
        parts = [f"step={rec.step}", f"kind={rec.kind}"]
        for k in ("neighbor_s", "partition_s", "device_s"):
            if k in t:
                parts.append(f"{k.removesuffix('_s')}={1e3 * t[k]:.1f}ms")
        if rec.node_occupancy:
            parts.append(f"node_occ={rec.node_occupancy:.2f}")
        if rec.rebuild:
            parts.append("rebuild")
        if rec.compiled:
            parts.append("compiled")
        return "# telemetry " + " ".join(parts)

    def emit(self, record: StepRecord) -> None:
        self._n += 1
        self._last = record
        if self._n % self.every == 0:
            print(self._line(record), file=self.stream, flush=True)

    def close(self) -> None:
        if self._last is not None and self._n % self.every != 0:
            print(self._line(self._last), file=self.stream, flush=True)


class Telemetry:
    """The hub producers emit into; fans records out to all sinks.

    ``enabled=False`` (or zero sinks) short-circuits everything —
    ``wants_records()`` is the producers' guard so the per-step record is
    never even constructed on the disabled path.
    """

    def __init__(self, sinks=(), enabled: bool = True):
        self.sinks: list[TelemetrySink] = list(sinks)
        self.enabled = bool(enabled)

    def wants_records(self) -> bool:
        return self.enabled and bool(self.sinks)

    def add_sink(self, sink: TelemetrySink) -> TelemetrySink:
        self.sinks.append(sink)
        return sink

    def emit(self, record: StepRecord) -> None:
        if not self.wants_records():
            return
        for s in self.sinks:
            # telemetry must never fail a step: a sink error (disk full,
            # closed stream) is warned once per sink and the sink dropped,
            # never propagated into the production run
            try:
                s.emit(record)
            except Exception as e:  # noqa: BLE001 - isolate any sink fault
                import warnings

                warnings.warn(
                    f"telemetry sink {type(s).__name__} failed ({e}); "
                    f"dropping it", stacklevel=2)
                self.sinks = [x for x in self.sinks if x is not s]

    def close(self) -> None:
        """Close every sink and disable the hub: a producer still holding
        this hub (e.g. a DistPotential reused after the run) emits nothing
        instead of writing to closed sinks."""
        for s in self.sinks:
            s.close()
        self.enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
