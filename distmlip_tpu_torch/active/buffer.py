"""Replay buffer: high-variance served structures become training data
(``distmlip_tpu/active/buffer.py``).

The buffer is the pipe between the serving path and the trainer: every
escalated, high-variance structure lands here together with its served
label (ensemble/committee energy + forces), and ``to_samples()`` hands
the whole buffer to the trainer as
:class:`~distmlip_tpu_torch.train.data.Sample`s unchanged. Host-only.

Contracts:

- **dedup** — entries are keyed by the SAME canonical tolerance-bucketed
  structure hash the fleet's content-addressed result cache uses
  (:func:`distmlip_tpu_torch.fleet.result_cache.structure_key`), so a popular
  structure escalated a thousand times is ONE training sample; a
  re-added key refreshes the label and keeps the max variance seen.
- **priority eviction** — over ``capacity``, the LOWEST-variance entry
  is evicted first (the buffer keeps what the model is most unsure
  about); an insert below the current floor is itself the eviction
  victim and never displaces a more uncertain entry.
- **persistent spill** — with ``directory`` set, every add/evict is an
  atomic npz write (tmp + rename) plus an append to a JSONL op log;
  construction replays the log, so a preempted fine-tune host resumes
  with the exact buffer it lost. Memory-only without a directory. The
  spill layout is the JAX package's, file for file, so a spill written by
  either package loads in the other.

Thread-safe (one lock): the ActiveLoop's escalation pump and a trainer
snapshotting ``to_samples()`` may run concurrently.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from dataclasses import dataclass

import numpy as np

from ..calculators.atoms import Atoms
from ..fleet.result_cache import structure_key

LOG_NAME = "buffer_log.jsonl"


@dataclass
class BufferEntry:
    """One deduplicated labeled structure."""

    key: str
    atoms: Atoms
    energy: float
    forces: np.ndarray
    variance: float
    stress: np.ndarray | None = None
    seq: int = 0                 # insertion order (FIFO tie-break)


class ReplayBuffer:
    """Dedup'd, variance-prioritized, optionally persistent sample store."""

    def __init__(self, capacity: int = 512, tol: float = 1e-5,
                 directory: str | None = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.tol = float(tol)
        self.directory = directory
        self._lock = threading.Lock()
        self._entries: dict[str, BufferEntry] = {}
        self._seq = 0
        self.added = 0
        self.dedup_hits = 0
        self.evictions = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._replay_log()

    # ------------------------------------------------------------------
    # core
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def depth(self) -> int:
        return len(self)

    def add(self, atoms, energy: float, forces, variance: float = 0.0,
            stress=None) -> str | None:
        """Insert (or refresh) one labeled structure; returns its key, or
        None when the insert was immediately evicted (buffer full of
        higher-variance entries)."""
        key = structure_key(atoms, tol=self.tol)
        entry = BufferEntry(
            key=key, atoms=atoms.copy(), energy=float(energy),
            forces=np.asarray(forces, dtype=np.float64).copy(),
            variance=float(variance),
            stress=(np.asarray(stress, dtype=np.float64).copy()
                    if stress is not None else None))
        with self._lock:
            prior = self._entries.get(key)
            if prior is not None:
                # dedup: refresh the label, keep the max variance seen
                entry.variance = max(entry.variance, prior.variance)
                entry.seq = prior.seq
                self._entries[key] = entry
                self.dedup_hits += 1
                self._persist_add(entry)
                return key
            entry.seq = self._seq
            self._seq += 1
            self._entries[key] = entry
            self.added += 1
            self._persist_add(entry)
            evicted = self._evict_over_capacity_locked()
        return None if key in evicted else key

    def _evict_over_capacity_locked(self) -> set:
        evicted = set()
        while len(self._entries) > self.capacity:
            victim = min(self._entries.values(),
                         key=lambda e: (e.variance, e.seq))
            del self._entries[victim.key]
            evicted.add(victim.key)
            self.evictions += 1
            self._persist_evict(victim.key)
        return evicted

    def variances(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(e.variance
                                   for e in self._entries.values()))

    def to_samples(self) -> list:
        """The buffer as training data, highest variance first (so a
        step-bounded fine-tune sees the most uncertain structures even
        when it doesn't consume the whole buffer)."""
        from ..train.data import Sample

        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: (-e.variance, e.seq))
        return [Sample(e.atoms, e.energy,
                       np.asarray(e.forces, np.float32), e.stress)
                for e in entries]

    def stats(self) -> dict:
        with self._lock:
            vs = [e.variance for e in self._entries.values()]
            return {
                "depth": len(self._entries),
                "capacity": self.capacity,
                "added": self.added,
                "dedup_hits": self.dedup_hits,
                "evictions": self.evictions,
                "variance_max": max(vs) if vs else 0.0,
                "variance_min": min(vs) if vs else 0.0,
            }

    # ------------------------------------------------------------------
    # persistence (atomic npz per entry + append-only JSONL op log)
    # ------------------------------------------------------------------

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key[:24]}.npz")

    def _persist_add(self, entry: BufferEntry) -> None:
        if self.directory is None:
            return
        payload = {
            "positions": entry.atoms.positions,
            "numbers": entry.atoms.numbers,
            "cell": entry.atoms.cell,
            "pbc": entry.atoms.pbc,
            "energy": np.float64(entry.energy),
            "forces": entry.forces,
            "variance": np.float64(entry.variance),
        }
        if entry.stress is not None:
            payload["stress"] = entry.stress
        path = self._entry_path(entry.key)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._log({"op": "add", "key": entry.key,
                   "file": os.path.basename(path),
                   "variance": entry.variance,
                   "info": {k: v for k, v in entry.atoms.info.items()
                            if isinstance(v, (str, int, float, bool))}})

    def _persist_evict(self, key: str) -> None:
        if self.directory is None:
            return
        try:
            os.unlink(self._entry_path(key))
        except OSError:
            pass
        self._log({"op": "evict", "key": key})

    def _log(self, record: dict) -> None:
        with open(os.path.join(self.directory, LOG_NAME), "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")

    def _replay_log(self) -> None:
        """Rebuild the in-memory state by replaying the op log (corrupt /
        truncated lines and missing npz files are skipped — a killed
        writer must never wedge the resume)."""
        path = os.path.join(self.directory, LOG_NAME)
        try:
            lines = open(path).read().splitlines()
        except OSError:
            return
        live: dict[str, dict] = {}
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("op") == "add":
                live[rec["key"]] = rec
            elif rec.get("op") == "evict":
                live.pop(rec.get("key"), None)
        for key, rec in live.items():
            try:
                with np.load(self._entry_path(key)) as z:
                    atoms = Atoms(numbers=z["numbers"],
                                  positions=z["positions"],
                                  cell=z["cell"], pbc=z["pbc"],
                                  info=rec.get("info") or {})
                    entry = BufferEntry(
                        key=key, atoms=atoms,
                        energy=float(z["energy"]),
                        forces=np.asarray(z["forces"]),
                        variance=float(z["variance"]),
                        stress=(np.asarray(z["stress"])
                                if "stress" in z.files else None),
                        seq=self._seq)
            except (OSError, KeyError, ValueError):
                continue
            self._seq += 1
            self._entries[key] = entry
            self.added += 1
