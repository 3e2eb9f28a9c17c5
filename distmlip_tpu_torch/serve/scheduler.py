"""Micro-batch assembly planning for the serving engine
(``distmlip_tpu/serve/scheduler.py``).

Pure host-side logic (no threads, no torch): given the sizes of the queued
requests in dispatch order, pick the subset that forms the next
micro-batch. The planner is bucket-aware: it fills toward the
``BucketPolicy`` capacity ladder (``partition/capacity.py``) so the packed
graph lands on a well-occupied rung. Every admission either stays inside
the current rung (raising occupancy) or climbs to a rung where occupancy is
at least as good, so scheduler-driven traffic stays within the ladder's
bucket bound (``BucketPolicy.max_rungs``).
"""

from __future__ import annotations

import functools

from dataclasses import dataclass, field

from ..partition.capacity import BucketPolicy


@dataclass
class BatchPlan:
    """Outcome of one assembly pass over the queue head.

    ``take`` holds queue indices (into the order the planner saw) chosen
    for this micro-batch; indices not taken stay queued in their original
    order. ``skipped`` are indices the planner examined but left behind
    because admitting them would have degraded rung occupancy.
    """

    take: list[int] = field(default_factory=list)
    skipped: list[int] = field(default_factory=list)
    total_atoms: int = 0
    node_cap: int = 0
    est_bytes: int | None = None   # planner's estimate for the chosen batch
    # the HEAD request ALONE is over the bytes budget on its own
    # MEASURED rung: the plan is head-only and must NOT be dispatched —
    # the engine fails the request instead (this closes the
    # pre-calibration admission race: a request admitted before the
    # bytes model existed can become an over-budget head later). A head
    # over budget on an EXTRAPOLATED estimate is also head-only but NOT
    # flagged: it dispatches as a solo probe whose first run calibrates
    # the rung with the truth.
    over_budget: bool = False

    @property
    def occupancy(self) -> float:
        return self.total_atoms / self.node_cap if self.node_cap else 0.0


def plan_batch(
    sizes,
    policy: BucketPolicy | None = None,
    max_batch: int = 8,
    window: int = 64,
    bytes_budget: int | None = None,
    dtype: str = "float32",
) -> BatchPlan:
    """Greedy bucket-aware micro-batch selection.

    ``sizes``: per-request atom counts in dispatch (priority/deadline)
    order. The head request is always taken — the max-wait timer already
    decided a batch must go out, so the oldest/most-urgent request is
    never starved by the occupancy rule (a head request too big for the
    BYTES budget never reaches the planner: engine admission rejects it
    at submit). Subsequent requests (scanned up to ``window`` deep) are
    admitted while the batch stays under ``max_batch`` slots and the
    admission keeps rung occupancy nondecreasing:

    - same node-capacity rung: always admit (occupancy strictly rises);
    - next rung: admit if ``new_total/new_cap >= total/cap`` (climbing
      does not dilute the rung);
    - a rung-degrading candidate is skipped ONLY when the batch is at a
      power-of-two slot count — the packed ``batch_size`` dimension rounds
      to the next power of two, so stopping there wastes no batch slots.
      Off a power-of-two boundary, the candidate is admitted anyway:
      finishing the slot bucket beats the node-rung padding it costs
      (batch-slot occupancy is the serving throughput lever; node padding
      only costs masked lanes).

    Skipped requests keep their queue position and seed (or join) the next
    batch, so a huge request mixed into a small-request stream waits at
    most until it reaches the queue head — then it is the seed and gets
    its own appropriately-sized rung.

    ``bytes_budget`` (memory-aware autobatching): the device memory
    budget in bytes. Every admission is additionally checked against the
    policy's calibrated bytes model
    (``BucketPolicy.estimate_batch_bytes``) — a candidate whose admission
    would push the batch estimate past the budget is skipped, whatever
    the slot/occupancy rules say, so the planner NEVER assembles a
    multi-request batch estimated over budget. A HEAD whose solo
    estimate already exceeds the budget yields a head-only plan flagged
    ``over_budget=True`` — the caller must fail that request, not
    dispatch it (engine admission normally rejects such requests at
    submit, but a request admitted BEFORE the model calibrated can
    become an over-budget head later). Until the model has any
    calibration the check is a no-op — the first batch through a fresh
    engine calibrates it. ``dtype`` selects the bytes model of that compute
    dtype (the potential's ``compute_dtype``).
    """
    policy = policy or BucketPolicy()
    plan = BatchPlan()
    if not len(sizes):
        return plan
    est = getattr(policy, "estimate_batch_bytes", None)
    if bytes_budget is None:
        est = None
    elif est is not None:
        est = functools.partial(est, dtype=dtype)
    total = int(sizes[0])
    cap = policy.get("nodes", total)
    plan.take.append(0)
    if est is not None:
        e0 = est(total)
        if e0 is not None and e0 > bytes_budget:
            plan.total_atoms, plan.node_cap = total, cap
            plan.est_bytes = e0
            # head-only either way, but only a MEASURED rung justifies
            # failing the request: an extrapolated guess ships as a solo
            # probe — its first run calibrates the rung with the truth
            # (rejecting on guesses would livelock the lane: see
            # BucketPolicy.has_calibrated_rung)
            exact = getattr(policy, "has_calibrated_rung", None)
            plan.over_budget = bool(exact and exact(total, dtype))
            return plan
    for i in range(1, min(len(sizes), window)):
        n = len(plan.take)
        if n >= max_batch:
            break
        new_total = total + int(sizes[i])
        new_cap = policy.get("nodes", new_total)
        if est is not None:
            e = est(new_total)
            if e is not None and e > bytes_budget:
                # admitting this request would blow the memory budget — the
                # slot/occupancy rules never override the bytes gate
                plan.skipped.append(i)
                continue
        rung_ok = new_cap == cap or new_total * cap >= total * new_cap
        at_slot_boundary = n & (n - 1) == 0   # 1, 2, 4, 8, ...
        if rung_ok or not at_slot_boundary:
            plan.take.append(i)
            total, cap = new_total, new_cap
        else:
            plan.skipped.append(i)
    plan.total_atoms = total
    plan.node_cap = cap
    if est is not None:
        plan.est_bytes = est(total)
    return plan
