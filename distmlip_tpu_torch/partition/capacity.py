"""Capacity bucketing: sticky padded sizes for graphs that change every step.

Edge counts drift every MD step. Rounding every capacity up to a bucket
keeps tensor shapes (and with them the memory allocator's block sizes and
the chunk count of the edge loop) stable until a count outgrows its bucket.

``CapacityPolicy`` (sticky): caps only grow, per process — right for a long
MD/relax run of ONE system. The geometric ``BucketPolicy`` of the serving
stack is queued in ROADMAP.md with the batched engine.
"""

from __future__ import annotations

import threading


def round_capacity(n: int, slack: float = 1.2, multiple: int = 128) -> int:
    """Round ``n * slack`` up to a multiple of ``multiple`` (default 128)."""
    if n <= 0:
        return multiple
    target = int(n * slack) + 1
    return ((target + multiple - 1) // multiple) * multiple


class CapacityPolicy:
    """Sticky capacities: grow in buckets, never shrink (per process).

    Thread-safe: an unlocked read-modify-write could store a SMALLER cap
    than a concurrent build already used."""

    def __init__(self, slack: float = 1.2, multiple: int = 128):
        self.slack = slack
        self.multiple = multiple
        self._caps: dict[str, int] = {}
        self._lock = threading.Lock()

    def get(self, name: str, needed: int) -> int:
        with self._lock:
            cap = self._caps.get(name, 0)
            if needed > cap:
                cap = max(round_capacity(needed, self.slack, self.multiple),
                          cap)
                self._caps[name] = cap
            return cap
