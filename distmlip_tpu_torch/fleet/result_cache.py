"""Content-addressed result cache: duplicate traffic never touches a card
(``distmlip_tpu/fleet/result_cache.py``).

Screening workloads are duplicate-heavy — the same relaxed candidates come
back through different pipelines, the same benchmark structures are
re-submitted by every tenant — and an MLIP result is a pure function of
``(structure, model, requested properties, precision)``. So the fleet
router fronts every dispatch with this cache:

- **structure hashing** (:func:`structure_key`): canonical-order,
  tolerance-bucketed. Positions are wrapped into the cell along periodic
  axes (a wrapped copy of a structure is the SAME structure), quantized
  onto a ``tol``-sized grid (coordinates within the same bucket hash
  equal; exact bucket-boundary straddles legitimately differ — the
  quantization is ``round(x / tol)``, documented and pinned by tests),
  and atoms are sorted by (species, quantized coordinates) so input
  order never matters. The cell, pbc flags and scalar ``atoms.info``
  conditioning (UMA charge/spin/dataset change the energy!) fold into
  the digest.
- **full cache key** (:func:`cache_key`): structure digest x model id x
  canonical requested-properties tuple x precision. An energy-only entry
  therefore can NEVER serve a forces request — different key, clean miss.
- **LRU byte bound**: entries cost their numpy payload bytes; inserts
  evict least-recently-used entries until the bound holds. Oversized
  single results are simply not cached.
- **copy-on-return**: ``get``/``put`` deep-copy array payloads, so a
  caller mutating a returned forces array can never corrupt the cached
  entry (or another caller's view of it).

Thread-safe (one lock; the router's dispatch callbacks and submit path
share it). Hit/miss/eviction counters ride ``stats()`` and the fleet
telemetry records.

The keys are the JAX package's, string for string, on the same ``Atoms``
(``info`` included), so either package's cache key names the same entry.
Results hold numpy arrays on the host: ``put`` refuses a torch tensor (a
cached device tensor would pin card memory and alias the replica's work).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

FULL_PROPERTIES = "full"


def _quantize(x: np.ndarray, tol: float) -> np.ndarray:
    return np.round(np.asarray(x, dtype=np.float64) / tol).astype(np.int64)


def structure_key(atoms, tol: float = 1e-5) -> str:
    """Canonical-order, tolerance-bucketed content hash of a structure.

    ``tol`` is the coordinate bucket width in Å (cell entries use the
    same grid). Invariant under atom reordering and under wrapping
    positions by whole lattice vectors along periodic axes; sensitive to
    species, cell, pbc, and any scalar ``atoms.info`` entries (model
    conditioning)."""
    pos = np.asarray(atoms.positions, dtype=np.float64)
    cell = np.asarray(atoms.cell, dtype=np.float64)
    pbc = np.asarray(atoms.pbc, dtype=bool)
    numbers = np.asarray(atoms.numbers, dtype=np.int64)
    if pbc.any() and abs(np.linalg.det(cell)) > 1e-12:
        # wrap along the periodic axes only: fractional coords mod 1 for
        # pbc axes, untouched otherwise — then back to Cartesian so the
        # tolerance grid is isotropic in Å regardless of cell shape
        frac = pos @ np.linalg.inv(cell)
        frac[:, pbc] -= np.floor(frac[:, pbc])
        # numeric wrap hygiene: 1.0 - eps floors to 0 after quantization
        # only if we re-quantize in Cartesian space (done below)
        pos = frac @ cell
    qpos = _quantize(pos, tol)
    qcell = _quantize(cell, tol)
    order = np.lexsort((qpos[:, 2], qpos[:, 1], qpos[:, 0], numbers))
    h = hashlib.sha256()
    h.update(np.int64(len(numbers)).tobytes())
    h.update(numbers[order].tobytes())
    h.update(qpos[order].tobytes())
    h.update(qcell.tobytes())
    h.update(pbc.astype(np.int8).tobytes())
    info = getattr(atoms, "info", None) or {}
    for k in sorted(info):
        v = info[k]
        if isinstance(v, (str, int, float, bool, np.integer, np.floating)):
            h.update(f"{k}={v!r};".encode())
    return h.hexdigest()


def canonical_properties(properties) -> str:
    """Stable id of the requested property set (None = the full result
    dict): sorted, deduplicated, 'energy' always included (the engine
    always returns it)."""
    if properties is None:
        return FULL_PROPERTIES
    return ",".join(sorted(set(properties) | {"energy"}))


def cache_key(atoms, model_id: str, properties=None,
              precision: str = "float32", tol: float = 1e-5) -> str:
    """The full content address: (structure, model, properties, precision).

    Property sets are part of the KEY, so an entry computed for one set
    never serves a request for another (an energy-only entry must not
    answer a forces request with a dict that lacks forces)."""
    return (f"{structure_key(atoms, tol=tol)}|{model_id}|"
            f"{canonical_properties(properties)}|{precision}")


def _check_host_result(result: dict) -> None:
    for k, v in result.items():
        if type(v).__module__.startswith("torch"):
            raise TypeError(f"ResultCache holds host results: {k!r} is a "
                            f"{type(v).__name__}; copy it to numpy first")


def _copy_result(result: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in result.items()}


def _result_bytes(result: dict) -> int:
    n = 128  # dict + key overhead
    for v in result.values():
        n += v.nbytes if isinstance(v, np.ndarray) else 32
    return n


class ResultCache:
    """LRU result cache with a byte bound and copy-on-return semantics.

    ``max_bytes`` bounds the summed numpy payload of the live entries
    (default 256 MiB); inserts evict from the least-recently-used end.
    ``get``/``put`` both copy array payloads — the cache's arrays are
    never aliased by any caller."""

    def __init__(self, max_bytes: int = 256 * 2**20):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}     # insertion order = LRU order
        self._bytes: dict[str, int] = {}
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.skipped_oversize = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str):
        """The cached result (a fresh copy) or None. Counts hit/miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            # LRU touch: move to the most-recent end
            del self._entries[key]
            self._entries[key] = entry
            self.hits += 1
            return _copy_result(entry)

    def put(self, key: str, result: dict) -> bool:
        """Store a copy of ``result``; returns False when it alone exceeds
        the byte bound (not cached). Replacing an existing key refreshes
        its LRU position. Raises TypeError on a torch tensor value."""
        _check_host_result(result)
        nbytes = _result_bytes(result)
        if nbytes > self.max_bytes:
            with self._lock:
                self.skipped_oversize += 1
            return False
        entry = _copy_result(result)
        with self._lock:
            if key in self._entries:
                self.total_bytes -= self._bytes.pop(key)
                del self._entries[key]
            while self.total_bytes + nbytes > self.max_bytes and self._entries:
                old_key = next(iter(self._entries))
                del self._entries[old_key]
                self.total_bytes -= self._bytes.pop(old_key)
                self.evictions += 1
            self._entries[key] = entry
            self._bytes[key] = nbytes
            self.total_bytes += nbytes
        return True

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions,
                "skipped_oversize": self.skipped_oversize,
            }
