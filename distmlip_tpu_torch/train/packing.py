"""Cost-model batch packing: census, capacity tiers, edge-balanced bins
(``distmlip_tpu/train/packing.py``, host numpy copied function for
function, so every tier assignment, capacity and epoch plan equals the
JAX package's bit for bit).

Training throughput on skewed graph-size distributions is set by how the
data is distributed: one frozen worst-case capacity pays the tail's
padding on every step. This module is the planning half of the fix
(``train/data.PackedBatchLoader`` consumes it):

- **cost census** — per-structure cost from the analytic FLOP model
  (:mod:`distmlip_tpu_torch.utils.flops`): edges are the unit of work of a
  message-passing potential, so every decision keys on edge-dominated cost;
- **capacity tiers** (:func:`assign_tiers`) — exact dynamic programming on
  the padded-cost objective ``sum(len(tier) * max_cost(tier))`` over the
  sorted costs, 2-3 tiers, each with its own frozen capacities;
- **edge-balanced bin packing** (:func:`plan_epoch`) — deterministic,
  seed-stable rounds of longest-processing-time assignment into equal-slot
  micro-batches; ``(seed, epoch)`` fixes the plan (the resume contract);
- **predicted waste** (:func:`predicted_plan_waste`) — through the shared
  ``partition.slot_waste_frac``.

No torch and no device: plans are pure functions of ``(needs, seed,
epoch)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..partition import BucketPolicy, FixedCaps, slot_waste_frac
from ..utils.flops import model_flop_estimate

# the padded dimensions whose slots carry per-row compute — identical to
# the packed_stats slot census (nodes + edges + line-graph edges); bond
# nodes and bond maps are index plumbing, not compute rows
COST_KEYS = ("nodes", "edges", "lines")


def default_cost(need: dict) -> float:
    """Structure cost when no model is in hand: edges (and line-graph
    edges — the angle convolutions run per line) carry the work; nodes
    ride with a small weight so even an edge-free structure costs > 0."""
    return (float(need.get("edges", 0)) + float(need.get("lines", 0))
            + 0.1 * float(need.get("nodes", 0)))


def model_cost_fn(model):
    """Per-structure cost function from the analytic FLOP model: the cost
    of one potential step of ``model`` on the structure's graph shape.
    Falls back to :func:`default_cost` for unknown model families (the
    estimate reads 0 there — a constant-zero cost would erase the
    histogram the tiers are built from)."""

    def cost(need: dict) -> float:
        f = model_flop_estimate(model, float(need.get("nodes", 0)),
                                float(need.get("edges", 0)),
                                float(need.get("lines", 0)))
        return f if f > 0.0 else default_cost(need)

    return cost


def structure_costs(needs, cost_fn=None) -> np.ndarray:
    """(N,) float64 cost of each structure (``cost_fn`` default:
    :func:`default_cost`)."""
    cost_fn = cost_fn or default_cost
    return np.array([cost_fn(n) for n in needs], dtype=np.float64)


@dataclass(frozen=True)
class CostCensus:
    """The dataset's cost histogram, computed once at load time."""

    costs: np.ndarray            # (N,) per-structure cost
    needs: tuple                 # the per-structure capacity-needs dicts

    @classmethod
    def from_needs(cls, needs, cost_fn=None) -> "CostCensus":
        return cls(costs=structure_costs(needs, cost_fn),
                   needs=tuple(needs))

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        return {f"p{int(100 * q)}": float(np.quantile(self.costs, q))
                for q in qs}

    def skew(self) -> float:
        """max/mean cost — 1.0 means uniform sizes (tiering buys
        nothing), large means long-tail (tiering is the whole game)."""
        m = float(self.costs.mean()) if len(self.costs) else 0.0
        return float(self.costs.max()) / m if m > 0 else 1.0

    def histogram(self, bins: int = 12):
        """Log-spaced histogram ``(counts, edges)`` over the cost range
        (linear when the range is degenerate)."""
        lo, hi = float(self.costs.min()), float(self.costs.max())
        if lo <= 0 or hi <= lo:
            return np.histogram(self.costs, bins=bins)
        edges = np.geomspace(lo, hi, bins + 1)
        return np.histogram(self.costs, bins=edges)

    def render(self, bins: int = 12, width: int = 40) -> str:
        """ASCII histogram for the audit tool / reports."""
        counts, edges = self.histogram(bins)
        peak = max(int(counts.max()), 1)
        lines = [f"cost census: n={len(self.costs)} "
                 f"mean={self.costs.mean():.3g} max={self.costs.max():.3g} "
                 f"skew={self.skew():.2f}x "
                 + " ".join(f"{k}={v:.3g}"
                            for k, v in self.percentiles().items())]
        for i, cnt in enumerate(counts):
            bar = "#" * max(int(round(width * cnt / peak)), 1 if cnt else 0)
            lines.append(f"  [{edges[i]:>10.3g}, {edges[i + 1]:>10.3g})"
                         f" {int(cnt):>6d} {bar}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# capacity tiers: deterministic 1-D segmentation of the cost histogram
# ---------------------------------------------------------------------------

_MAX_DP_CANDIDATES = 256


def assign_tiers(costs, num_tiers: int, min_members: int = 1):
    """Segment the cost distribution into at most ``num_tiers`` contiguous
    tiers (0 = cheapest) minimizing the padded-cost objective
    ``sum(len(tier) * max_cost(tier))`` — the analytic stand-in for "FLOPs
    a tier's frozen executable spends per epoch" when every member pads to
    the tier's worst case.

    Exact DP over sorted-cost boundaries; boundaries never split an
    equal-cost run (no waste gain), and every tier must hold at least
    ``min_members`` structures (pass ``micro_batch_size * accum_steps`` so
    each tier can fill a whole accumulation window — this is also what
    keeps a single giant outlier from claiming a tier of its own and then
    being dropped as an unfillable tail). Ties prefer FEWER tiers (each
    tier is one frozen executable).

    Returns ``(tier_of, thresholds)``: ``tier_of[i]`` is structure i's
    tier, ``thresholds[t]`` the max cost of tier t.
    """
    costs = np.asarray(costs, dtype=np.float64)
    n = len(costs)
    if n == 0:
        raise ValueError("assign_tiers needs at least one structure")
    min_members = max(int(min_members), 1)
    T = max(min(int(num_tiers), n // min_members), 1)
    order = np.argsort(costs, kind="stable")
    cs = costs[order]

    # candidate segment ends (exclusive prefix lengths): equal-cost run
    # boundaries, quantile-subsampled so the DP stays O(T * C^2) bounded
    ends = np.flatnonzero(np.diff(cs) > 0) + 1
    ends = np.concatenate([ends, [n]]).astype(np.int64)
    if len(ends) > _MAX_DP_CANDIDATES:
        pick = np.linspace(0, len(ends) - 2,
                           _MAX_DP_CANDIDATES - 1).round().astype(np.int64)
        ends = np.unique(np.concatenate([ends[pick], [n]]))
    C = len(ends)

    def seg_cost(a: int, b: int) -> float:
        # prefix [a, b) of the sorted costs, padded to its own max
        return (b - a) * cs[b - 1]

    INF = float("inf")
    # dp[t][j]: min padded cost covering prefix ends[j] with t+1 segments
    dp = np.full((T, C), INF)
    parent = np.full((T, C), -1, dtype=np.int64)
    for j in range(C):
        if ends[j] >= min_members:
            dp[0, j] = seg_cost(0, int(ends[j]))
    for t in range(1, T):
        for j in range(C):
            b = int(ends[j])
            best, arg = INF, -1
            for i in range(j):
                a = int(ends[i])
                if b - a < min_members or dp[t - 1, i] == INF:
                    continue
                cand = dp[t - 1, i] + seg_cost(a, b)
                if cand < best:
                    best, arg = cand, i
            dp[t, j], parent[t, j] = best, arg

    # smallest tier count achieving the optimum (ties -> fewer compiles)
    last = C - 1
    finals = dp[:, last]
    t_star = int(np.flatnonzero(finals <= finals.min() + 1e-9)[0])
    bounds = [int(ends[last])]
    j = last
    for t in range(t_star, 0, -1):
        j = int(parent[t, j])
        bounds.append(int(ends[j]))
    bounds = bounds[::-1]  # ascending exclusive prefix ends, one per tier

    tier_sorted = np.empty(n, dtype=np.int64)
    start = 0
    thresholds = []
    for t, end in enumerate(bounds):
        tier_sorted[start:end] = t
        thresholds.append(float(cs[end - 1]))
        start = end
    tier_of = np.empty(n, dtype=np.int64)
    tier_of[order] = tier_sorted
    return tier_of, thresholds


def tier_caps(needs, tier_of, micro_batch_size: int, batch_parts: int = 1,
              policy=None, *, accum_steps: int = 1, costs=None) -> dict:
    """Frozen :class:`~distmlip_tpu_torch.partition.FixedCaps` per tier, sized
    to the ROUND-PACKING bound rather than the combinatorial top-B worst
    case.

    The epoch packer (:func:`plan_epoch` via :func:`_balance_bins`) hands
    items to bins in strict cost-rank rounds: round ``r`` distributes the
    kept set's cost ranks ``[r * n_bins, (r+1) * n_bins)`` one per bin.
    For ANY epoch's kept subset, the item at kept-rank ``k`` has at least
    ``k`` kept structures at or above its cost, so its cost is bounded by
    the tier's (k+1)-th largest cost VALUE, and its per-name need by
    ``M_name[k]`` — the max need over all tier members whose cost is <=
    that value (tie-collapsed so equal-cost reorderings cannot cheat the
    bound). A bin therefore never needs more than
    ``sum_r M_name[r * n_bins]`` per name (and a batch ROW never more
    than the first ``per_shard`` terms, since a row's j-th largest item
    has bin rank >= j). That bound tracks the tier's cost QUANTILES, not
    its single worst member — with the top-B worst case, the balanced
    bins the packer actually builds would pad to a capacity no epoch can
    reach, and the measured waste showed exactly that.

    ``n_bins`` per tier is fixed (static membership), so the caps hold
    for every epoch of the run; ``FixedCaps`` still hard-fails loudly if
    the invariant were ever violated.
    """
    needs = list(needs)
    tier_arr = np.asarray(tier_of)
    if costs is None:
        costs = structure_costs(needs)
    costs = np.asarray(costs, dtype=np.float64)
    policy = policy or BucketPolicy()
    B = int(micro_batch_size)
    A = max(int(accum_steps), 1)
    per_shard = -(-B // max(int(batch_parts), 1))
    names = set()
    for need in needs:
        names.update(need)
    caps = {}
    for t in sorted(set(int(x) for x in tier_arr)):
        idx = np.flatnonzero(tier_arr == t)
        order = idx[np.argsort(-costs[idx], kind="stable")]
        n_t = len(order)
        n_bins = (n_t // (B * A)) * A
        if n_bins == 0:  # defensive: assign_tiers' min-members floor
            n_bins = 1
        v = costs[order]
        # first index of each equal-cost run (ties collapse upward)
        starts = np.searchsorted(-v, -v, side="left")
        caps_t = {}
        for name in sorted(names):
            vals = np.array([int(needs[i].get(name, 0)) for i in order],
                            dtype=np.int64)
            if not vals.any():
                caps_t[name] = 0
                continue
            sm = np.maximum.accumulate(vals[::-1])[::-1]
            m_bound = sm[starts]
            worst = int(sum(m_bound[min(r * n_bins, n_t - 1)]
                            for r in range(per_shard)))
            caps_t[name] = policy.get(name, worst)
        caps[t] = FixedCaps(caps_t, fallback=policy)
    return caps


# ---------------------------------------------------------------------------
# edge-balanced bin packing: the deterministic per-epoch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MacroStep:
    """One optimizer step of the plan: ``accum_steps`` micro-batches of
    ``micro_batch_size`` structure indices each, all from ONE tier (the
    scan axis stacks them — every micro-batch of a window must share the
    tier's frozen shapes)."""

    tier: int
    micro: tuple  # A tuples of B structure indices


def _balance_bins(members, costs, n_bins: int):
    """Round-based longest-processing-time assignment: round ``r`` hands
    the next ``n_bins`` members (cost ranks ``[r * n_bins,
    (r+1) * n_bins)`` — ``members`` is pre-sorted by descending cost) one
    per bin, heaviest item to the currently cheapest bin. Two properties
    the rest of the pipeline depends on: total cost per bin balances to
    the classic LPT bound, and a bin's round-``r`` item ALWAYS has cost
    rank >= ``r * n_bins`` — the invariant :func:`tier_caps` turns into a
    provable per-epoch capacity bound. Deterministic: ties break on bin
    index."""
    bins = [[] for _ in range(n_bins)]
    totals = np.zeros(n_bins)
    for r0 in range(0, len(members), n_bins):
        chunk = members[r0:r0 + n_bins]
        order = np.argsort(totals, kind="stable")
        for s, b in zip(chunk, order):
            bins[int(b)].append(int(s))
            totals[int(b)] += float(costs[s])
    return bins


def _balance_rows(members, costs, batch_parts: int):
    """Order a micro-batch's members so the mesh packer's contiguous
    shard assignment (structure i -> shard i // ceil(B / batch_parts))
    lands balanced EDGE totals on every batch row — no device idles
    waiting for the heaviest row. (Any row grouping respects the
    tier_caps row bound — a row's j-th largest item has bin rank >= j —
    so balancing is free to optimize for wall clock alone.)"""
    if batch_parts <= 1:
        return list(members)
    order = sorted(members, key=lambda s: (-costs[s], s))
    rows = _balance_bins(order, costs, batch_parts)
    # full rows first: the mesh packer slices contiguous per_shard chunks,
    # so only the TRAILING shard may run short (B % batch_parts != 0)
    rows.sort(key=len, reverse=True)
    return [s for row in rows for s in row]


def plan_epoch(costs, tier_of, *, seed: int, epoch: int,
               micro_batch_size: int, accum_steps: int = 1,
               batch_parts: int = 1, shuffle: bool = True):
    """The deterministic packing plan of one epoch: a pure function of
    ``(costs, tier_of, seed, epoch)`` — what makes the tiered loader's
    cursor resumable — returning a list of :class:`MacroStep`.

    Per tier: a seeded per-epoch permutation picks WHICH structures fill
    this epoch's windows (the dropped tail rotates across epochs, exactly
    like the naive loader's shuffled tail) and breaks equal-cost ties;
    first-fit-decreasing on cost then balances total edges across the
    tier's micro-batches, and within each micro-batch across mesh batch
    rows. Windows of ``accum_steps`` micro-batches stay within one tier
    (one executable per window); the cross-tier step order is a seeded
    interleave so both tiers compile early and resume crosses tier
    boundaries routinely rather than only at epoch edges.
    """
    costs = np.asarray(costs, dtype=np.float64)
    tier_of = np.asarray(tier_of)
    B = int(micro_batch_size)
    A = max(int(accum_steps), 1)
    Bp = max(int(batch_parts), 1)
    windows = []
    for t in sorted(set(int(x) for x in tier_of)):
        idx = np.flatnonzero(tier_of == t)
        rng = np.random.default_rng([int(seed), int(epoch), 211, int(t)])
        if shuffle:
            idx = idx[rng.permutation(len(idx))]
        n_win = len(idx) // (B * A)
        if n_win == 0:
            continue
        keep = idx[:n_win * B * A]
        # decreasing cost; stable sort keeps the shuffled equal-cost order
        keep = keep[np.argsort(-costs[keep], kind="stable")]
        bins = _balance_bins(keep, costs, n_win * A)
        bins = [_balance_rows(b, costs, Bp) for b in bins]
        for w in range(n_win):
            windows.append(MacroStep(
                tier=t,
                micro=tuple(tuple(b) for b in bins[w * A:(w + 1) * A])))
    if shuffle and len(windows) > 1:
        rng = np.random.default_rng([int(seed), int(epoch), 431])
        windows = [windows[i] for i in rng.permutation(len(windows))]
    return windows


def plan_epoch_naive(n: int, *, seed: int, epoch: int,
                     micro_batch_size: int, accum_steps: int = 1,
                     shuffle: bool = True):
    """The single-cap loader's implicit plan (contiguous permutation
    slices, one tier), in :class:`MacroStep` form — lets the audit tool
    predict naive waste through the same machinery it predicts packed
    waste with."""
    from .data import epoch_permutation

    B, A = int(micro_batch_size), max(int(accum_steps), 1)
    order = (epoch_permutation(n, seed, epoch) if shuffle
             else np.arange(n))
    steps = n // (B * A)
    out = []
    for s in range(steps):
        start = s * B * A
        out.append(MacroStep(tier=0, micro=tuple(
            tuple(int(i) for i in order[start + a * B:start + (a + 1) * B])
            for a in range(A))))
    return out


# ---------------------------------------------------------------------------
# predicted waste: the shared slot-waste definition, analytically
# ---------------------------------------------------------------------------


def _caps_dict(caps) -> dict:
    return caps.as_dict() if hasattr(caps, "as_dict") else dict(caps)


def micro_live_slots(needs, members, caps, batch_parts: int = 1):
    """(live, slots) of one micro-batch packed at ``caps`` — the same
    node/edge/line census ``packed_stats`` takes on the built graph, so
    ``slot_waste_frac(live, slots)`` here IS the built pack's
    ``padding_waste_frac``."""
    cd = _caps_dict(caps)
    P = max(int(batch_parts), 1)
    slots = P * (int(cd.get("nodes", 0)) + int(cd.get("edges", 0))
                 + int(cd.get("lines", 0)))
    live = sum(int(needs[s].get(k, 0)) for s in members for k in COST_KEYS)
    return live, slots


def predicted_plan_waste(needs, plan, caps_by_tier, batch_parts: int = 1):
    """Mean predicted ``padding_waste_frac`` over a plan's micro-batches
    (via the shared :func:`~distmlip_tpu_torch.partition.slot_waste_frac`).
    ``caps_by_tier``: {tier: FixedCaps-or-dict}."""
    wastes = []
    for step in plan:
        caps = caps_by_tier[step.tier]
        for members in step.micro:
            live, slots = micro_live_slots(needs, members, caps,
                                           batch_parts)
            wastes.append(slot_waste_frac(live, slots))
    return float(np.mean(wastes)) if wastes else 0.0


def plan_edge_balance(costs, plan) -> float:
    """Worst (min over tiers) mean/max balance of micro-batch cost totals
    within each tier across the whole plan — a tier shares one frozen
    executable, so its heaviest micro-batch is the one every lighter
    sibling's padding pays for. 1.0 means every micro-batch of a tier
    carries equal edge work; the audit-tool counterpart of the loader's
    per-step ``edge_balance`` meta."""
    costs = np.asarray(costs, dtype=np.float64)
    per_tier: dict = {}
    for step in plan:
        for m in step.micro:
            per_tier.setdefault(step.tier, []).append(
                float(costs[list(m)].sum()))
    worst = 1.0
    for tots in per_tier.values():
        if max(tots) > 0:
            worst = min(worst, (sum(tots) / len(tots)) / max(tots))
    return worst
