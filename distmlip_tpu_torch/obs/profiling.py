"""Compile telemetry: one event per compile, fresh vs AOT-rehydrated
(``distmlip_tpu/obs/profiling.py``).

The fourth observability plane's front door. Eager PyTorch compiles no
program, so a "fresh" event in the port is the first dispatch of a new
shape kind or bucket (the ``compile_count`` that ``BatchedPotential`` and
``Trainer`` keep, and ``DistPotential``'s first step at a capacity bucket);
its wall time is that dispatch's, first-use work included. A hand-written
kernel's ``nvcc`` build at first use (``kernels/build.py``) is logged too,
under site ``kernel_build``. Each calls :func:`record_compile` with the
measured wall time, the bucket key that triggered it, and the ``kind``:

- ``"fresh"`` — a first dispatch or a kernel build (the work was done now);
- ``"aot"``   — a rehydrate from an ahead-of-time cache; unused until the
  fleet's AOT cache is ported (ROADMAP.md A10).

Events land in a bounded process-global :class:`CompileLog` (cheap, lock
+ deque; always on) and — when an observability hub is installed — in
the metrics registry as ``distmlip_compile_seconds{site,kind}`` and
``distmlip_compiles_total{site,kind}``. With nothing installed a call
costs one deque append; the potential/model hot path never calls this
(compiles are rare by construction).

Nothing here imports torch — importable from every instrumented layer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from . import runtime as obsrt

__all__ = [
    "COMPILE_BUCKETS",
    "CompileEvent",
    "compile_counts",
    "compile_events",
    "record_compile",
    "reset_compile_log",
]

# histogram buckets for compile wall time: 1 ms .. ~17 min, log scale
# (bucket compiles run ~100ms..minutes; AOT rehydrates ~1-100 ms)
COMPILE_BUCKETS = tuple(1e-3 * 2**i for i in range(21))

KIND_FRESH = "fresh"
KIND_AOT = "aot"


@dataclass
class CompileEvent:
    """One compile (or AOT rehydrate) observed anywhere in the process."""

    site: str            # "batched_bucket" | "dist_potential" | "train_step" | "kernel_build" | ...
    kind: str            # "fresh" | "aot"
    wall_s: float        # measured trace+lower+compile (or rehydrate) wall time
    bucket_key: str = ""
    executable_bytes: int = 0   # serialized executable size when known (AOT path)
    t_wall: float = field(default_factory=time.time)

    def as_dict(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "wall_s": round(self.wall_s, 6),
            "bucket_key": self.bucket_key,
            "executable_bytes": self.executable_bytes,
            "t_wall": self.t_wall,
        }


class CompileLog:
    """Bounded, thread-safe in-process event log (newest-last)."""

    def __init__(self, maxlen: int = 4096):
        self._events: deque[CompileEvent] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def append(self, ev: CompileEvent) -> None:
        with self._lock:
            self._events.append(ev)

    def events(self) -> list[CompileEvent]:
        with self._lock:
            return list(self._events)

    def counts(self) -> dict[str, int]:
        """{kind: n} over the retained window."""
        out: dict[str, int] = {}
        with self._lock:
            for ev in self._events:
                out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_LOG = CompileLog()


def record_compile(site: str, kind: str, wall_s: float, bucket_key: str = "",
                   executable_bytes: int = 0) -> CompileEvent:
    """Record one compile event; feeds the global log + metrics registry.

    Never raises into the caller — a broken metrics backend must not
    fail a compile that already succeeded.
    """
    ev = CompileEvent(site=site, kind=kind, wall_s=float(wall_s),
                      bucket_key=str(bucket_key),
                      executable_bytes=int(executable_bytes))
    _LOG.append(ev)
    reg = obsrt.metrics()
    if reg is not None:
        try:
            reg.histogram(
                "distmlip_compile_seconds",
                "Wall time of compiles by site and kind (fresh|aot)",
                labels=("site", "kind"),
                buckets=COMPILE_BUCKETS).labels(
                    site=site, kind=kind).observe(ev.wall_s)
            reg.counter(
                "distmlip_compiles_total",
                "Compile events by site and kind (fresh|aot)",
                labels=("site", "kind")).labels(
                    site=site, kind=kind).inc()
        except Exception:  # noqa: BLE001 - metrics must not break compiles
            pass
    return ev


def compile_events() -> list[CompileEvent]:
    """Every retained event, oldest first."""
    return _LOG.events()


def compile_counts() -> dict[str, int]:
    """{kind: count} over the retained window — the fresh-vs-aot split."""
    return _LOG.counts()


def reset_compile_log() -> None:
    """Tests / fresh measurement windows."""
    _LOG.clear()
