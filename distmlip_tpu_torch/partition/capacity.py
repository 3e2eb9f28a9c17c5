"""Capacity bucketing: padded sizes for graphs that change every step.

Edge counts drift every MD step. Rounding every capacity up to a bucket
keeps tensor shapes (and with them the memory allocator's block sizes and
the chunk count of the edge loop) stable until a count outgrows its bucket.

Two policies coexist (``distmlip_tpu/partition/capacity.py``):

- ``CapacityPolicy`` (sticky): caps only grow, per process — right for a
  long MD/relax run of ONE system. Each capacity has a name: ``nodes``,
  and ``edges`` for an unsplit edge layout, or ``edges_interior`` and
  ``edges_frontier`` for the two segments of a split one (P > 1), each the
  largest count over the partitions; ``halo`` and ``bond_halo`` for the
  per-shift halo tables; ``bonds``, ``lines`` and ``bond_map`` for the
  bond graph.
- ``BucketPolicy`` (geometric, stateless): every request maps to the
  nearest rung of a fixed geometric ladder (``growth`` steps, default
  ~sqrt(2)). Right for a serving stream of many different systems: a
  batch's shapes depend only on its own sizes, so a stream drawn from a
  bounded size range touches at most ``ceil(log_growth(spread))`` distinct
  shapes per dimension. The batched engine (``calculators/batched.py``)
  and the serving scheduler (``serve/scheduler.py``) pack through it.
  ``FixedCaps`` freezes precomputed capacities (worst case over a known
  population, ``fixed_caps_for_batches``).
"""

from __future__ import annotations

import math
import threading


def round_capacity(n: int, slack: float = 1.2, multiple: int = 128) -> int:
    """Round ``n * slack`` up to a multiple of ``multiple`` (default 128)."""
    if n <= 0:
        return multiple
    target = int(n * slack) + 1
    return ((target + multiple - 1) // multiple) * multiple


def geometric_bucket(n: int, base: int = 128, growth: float = 2.0 ** 0.5,
                     multiple: int = 128) -> int:
    """Smallest ladder rung ``base * growth**k`` (k >= 0) holding ``n``,
    rounded up to ``multiple``.

    Rounding may collapse adjacent rungs onto one value (which only shrinks
    the bucket set), so the distinct buckets over a size range [lo, hi] are
    at most ``ceil(log_growth(hi / max(lo, base))) + 1``.
    """
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    if n <= base:
        rung = base
    else:
        k = math.ceil(math.log(n / base) / math.log(growth) - 1e-9)
        rung = base * growth ** k
        # float rounding may land one rung short for exact powers
        if rung < n - 1e-6:
            rung = base * growth ** (k + 1)
    return ((int(math.ceil(rung)) + multiple - 1) // multiple) * multiple


class FixedCaps:
    """Capacity policy that returns PRECOMPUTED values, ignoring ``needed``
    (it raises when ``needed`` exceeds the frozen value). Unknown names go
    to the wrapped ``fallback`` policy and are then frozen too."""

    def __init__(self, caps: dict[str, int], fallback=None):
        self._caps = dict(caps)
        self._fallback = fallback

    def get(self, name: str, needed: int) -> int:
        cap = self._caps.get(name)
        if cap is None:
            if self._fallback is None:
                raise KeyError(
                    f"FixedCaps has no precomputed capacity {name!r} "
                    f"(have {sorted(self._caps)}) and no fallback policy")
            cap = self._fallback.get(name, needed)
            self._caps[name] = cap
        if needed > cap:
            raise ValueError(
                f"FixedCaps[{name!r}] = {cap} cannot hold {needed} — the "
                f"precomputed maximum was wrong")
        return cap

    def as_dict(self) -> dict[str, int]:
        """The precomputed capacities (a copy)."""
        return dict(self._caps)


def fixed_caps_for_batches(per_structure_needs, batch_size: int,
                           policy=None) -> FixedCaps:
    """Worst-case capacities for batches of ``batch_size`` drawn from a
    known population: per capacity name, the sum of the top
    ``batch_size`` needs, quantized once through ``policy`` (default a
    fresh ``BucketPolicy``) and frozen, so every pack lands on one shape."""
    if not per_structure_needs:
        raise ValueError("fixed_caps_for_batches needs at least one "
                         "structure's capacity needs")
    batch_size = max(int(batch_size), 1)
    policy = policy or BucketPolicy()
    names = set()
    for need in per_structure_needs:
        names.update(need)
    caps = {}
    for name in sorted(names):
        vals = sorted((int(n.get(name, 0)) for n in per_structure_needs),
                      reverse=True)
        worst = sum(vals[:batch_size])
        caps[name] = policy.get(name, worst) if worst else 0
    return FixedCaps(caps, fallback=policy)


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


class BucketPolicy:
    """Stateless geometric capacity ladder (module docstring).

    ``get`` is a pure function of ``needed``, so identical request sizes
    always give identical shapes. Small dimensions (batch slots) use
    :meth:`get_small`, the next power of two.

    The policy also carries the bytes model of the memory-aware batching:
    :meth:`calibrate_bytes` records a measured device peak per node rung
    (``BatchedPotential`` feeds it each CUDA calculate's own peak over
    what was allocated when it started), and
    :meth:`estimate_batch_bytes`
    answers what a batch of N atoms would cost, for the scheduler's bytes
    budget (``serve.scheduler.plan_batch``). Shapes stay history-free; only
    the bytes estimates learn. The bytes model is kept per compute dtype
    (``dtype``, the model's ``cfg.dtype``): a bfloat16 model's peaks are
    not a float32 one's, and one policy may serve both.
    """

    def __init__(self, base: int = 128, growth: float = 2.0 ** 0.5,
                 multiple: int = 128):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.base = int(base)
        self.growth = float(growth)
        self.multiple = int(multiple)
        self._bytes_by_cap: dict[tuple, int] = {}  # (dtype, node rung) -> peak
        self._bytes_lock = threading.Lock()

    def get(self, name: str, needed: int) -> int:
        return geometric_bucket(needed, self.base, self.growth, self.multiple)

    # ---- bytes model (memory-aware batching) ----

    def calibrate_bytes(self, node_cap: int, peak_bytes: int, dtype: str = "float32") -> None:
        """Record a measured device peak for a batch whose node rung is
        ``node_cap`` under compute dtype ``dtype``; keeps the WORST peak
        per rung."""
        node_cap, peak_bytes = int(node_cap), int(peak_bytes)
        if node_cap <= 0 or peak_bytes <= 0:
            return
        with self._bytes_lock:
            prev = self._bytes_by_cap.get((dtype, node_cap), 0)
            if peak_bytes > prev:
                self._bytes_by_cap[(dtype, node_cap)] = peak_bytes

    def _rungs(self, dtype: str) -> dict:
        return {c: b for (d, c), b in self._bytes_by_cap.items() if d == dtype}

    def has_calibrated_rung(self, total_atoms: int, dtype: str = "float32") -> bool:
        """Whether ``total_atoms``'s own node rung has a MEASURED peak (not
        an extrapolation) under ``dtype``. Hard admission decisions key on
        this: rejecting on a guess could keep a rung from ever being
        measured."""
        cap = self.get("nodes", max(int(total_atoms), 1))
        with self._bytes_lock:
            return (dtype, cap) in self._bytes_by_cap

    def estimate_batch_bytes(self, total_atoms: int, dtype: str = "float32") -> int | None:
        """Estimated device peak of a batch of ``total_atoms`` atoms.

        The measured peak of its rung when that rung ran before (never
        below a peak measured at a smaller rung); otherwise an estimate
        that errs up: with two or more measured rungs an affine fit
        ``resident + k * cap`` through the extreme rungs, with one a
        linear scaling floored at the observed peak. None before any
        measurement under ``dtype`` (callers then skip the budget check)."""
        cap = self.get("nodes", max(int(total_atoms), 1))
        with self._bytes_lock:
            rungs = self._rungs(dtype)
            exact = rungs.get(cap)
            if exact is not None:
                return max(b for c, b in rungs.items() if c <= cap)
            if not rungs:
                return None
            pts = sorted(rungs.items())
            floor = min(b for _, b in pts)
            if len(pts) >= 2:
                (c_lo, b_lo), (c_hi, b_hi) = pts[0], pts[-1]
                k = max((b_hi - b_lo) / max(c_hi - c_lo, 1), 0.0)
                resident = max(b_lo - k * c_lo, 0.0)
                est = int(resident + k * cap) + 1
                observed = [b for c, b in pts if c <= cap]
                return max(est, *observed) if observed else est
            coeff = max(b / c for c, b in pts)
        return max(int(cap * coeff) + 1, floor)

    def get_small(self, needed: int) -> int:
        """Bucket for small count dimensions (batch slots): the next power
        of two."""
        n = max(int(needed), 1)
        return 1 << (n - 1).bit_length()

    def max_rungs(self, lo: int, hi: int) -> int:
        """Upper bound on the distinct rungs sizes in ``[lo, hi]`` touch."""
        lo = max(int(lo), 1)
        hi = max(int(hi), lo)
        spread = hi / max(lo, self.base)
        if spread <= 1.0:
            return 1
        return int(math.ceil(math.log(spread) / math.log(self.growth))) + 1

    def ladder_bound(self, lo_total: int, hi_total: int,
                     max_batch: int) -> int:
        """Bound on the distinct buckets a serving stream whose batch atom
        totals span ``[lo_total, hi_total]`` can dispatch: the node and edge
        ladders' rungs (+2 for edges tracking atoms within a constant
        factor), crossed with the batch-slot powers of two in play."""
        rungs = self.max_rungs(lo_total, hi_total)
        b_slots = len({self.get_small(b)
                       for b in range(1, max(int(max_batch), 1) + 1)})
        return (2 * rungs + 2) * b_slots
