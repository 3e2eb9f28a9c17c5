"""ActiveLoop: the closed serve -> buffer -> train -> validate -> swap loop
(``distmlip_tpu/active/loop.py``).

One controller object ties the subsystem together over a live serving
surface (a :class:`~distmlip_tpu_torch.serve.ServeEngine` or a
:class:`~distmlip_tpu_torch.fleet.FleetRouter`):

- ``submit()`` forwards to the serving surface unchanged (same Future
  contract) and, per the :class:`~.uncertainty.EscalationPolicy` (or an
  explicit ``escalate=`` override), queues the structure for ensemble
  re-evaluation;
- ``pump()`` drains the escalation queue in packed batches through the
  :class:`~.uncertainty.EnsembleBatchedPotential` — one packed graph
  per batch, every member over it — and routes high-variance structures with their served
  labels into the :class:`~.buffer.ReplayBuffer`;
- ``maybe_finetune()`` consults the :class:`~.trigger.FineTuneTrigger`;
  when due, runs the gated :func:`~.trigger.run_finetune` job and, if
  the candidate beats the live weights on holdout, hot-swaps it into
  the serving surface AND the ensemble's primary member
  (:mod:`~.hotswap` — no new serving bucket, zero dropped requests, cache
  keys rolled forward);
- ``tick()`` = pump + maybe_finetune, the one call a driver loop needs.

Everything is synchronous and clock-injectable: tests drive the loop
deterministically, production drivers call ``tick()`` from their own
cadence (a cron thread, the serving idle loop, a sidecar).

Telemetry: ``active_escalate`` / ``active_finetune`` / ``active_swap``
StepRecords (swap count, buffer depth, variance percentiles, escalation
rate riding ``extra``) rendered by the report's "active learning" section.

Sampling draws ``np.random.default_rng(seed).random()`` once per submit, in
the JAX package's order, so the escalation decisions for a seed are the
same in both packages.

One card for everything (the port's fleet shares it): the loop splits the
card's room between the serving potentials and the ensemble lane
(``calculators.batched.share_device_budget``), and the built-in fine-tune
plans its step against what those budgets leave
(``calculators.batched.device_room_left``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..calculators.batched import device_room_left, share_device_budget
from ..obs import runtime as obsrt
from ..telemetry import StepRecord
from .buffer import ReplayBuffer
from .hotswap import hot_swap, params_digest
from .trigger import FineTuneTrigger, run_finetune
from .uncertainty import EscalationPolicy, variance_score


@dataclass
class ActiveStats:
    """Cumulative loop counters (reads under the loop lock)."""

    submitted: int = 0
    escalated: int = 0
    escalation_dropped: int = 0   # queue overflow (max_pending)
    evaluated: int = 0            # structures re-evaluated under the ensemble
    buffered: int = 0
    finetunes: int = 0
    shipped: int = 0
    rejected_models: int = 0      # candidates the holdout gate refused
    swaps: int = 0

    def snapshot(self) -> dict:
        return dict(vars(self))


class ActiveLoop:
    """Uncertainty-routed active-learning controller.

    Parameters
    ----------
    serving : ServeEngine or FleetRouter — where traffic goes. May share
        its potential with ``ensemble`` (the single-host shape: the
        engine serves the ensemble's primary member) or not (a fleet
        with a standalone evaluator).
    ensemble : EnsembleBatchedPotential — the uncertainty lane; member 0
        is the live serving weights.
    buffer : ReplayBuffer (a fresh in-memory one by default).
    policy : EscalationPolicy — sampling rate + buffer admission floors.
    trigger : FineTuneTrigger (default: fires on 16 fresh buffer
        entries).
    finetune : callable(samples, params) -> FineTuneReport overriding the
        built-in job, or None to use :func:`~.trigger.run_finetune` with
        ``finetune_kwargs`` (``loader_kwargs`` etc.).
    label : "committee" (default — label with the mean of the
        NON-primary members, the right teacher when the primary is the
        model being corrected) or "mean" (full ensemble mean).
    escalation_batch : max structures per escalation batch (one packed
        graph; default 8).
    seed / clock : deterministic sampling + injectable time.
    """

    def __init__(self, serving, ensemble, buffer: ReplayBuffer | None = None,
                 *, policy: EscalationPolicy | None = None,
                 trigger: FineTuneTrigger | None = None,
                 finetune=None, finetune_kwargs: dict | None = None,
                 label: str = "committee", escalation_batch: int = 8,
                 telemetry=None, clock=None, seed: int = 0):
        if label not in ("committee", "mean"):
            raise ValueError(f"label must be 'committee' or 'mean', "
                             f"got {label!r}")
        self.serving = serving
        self.ensemble = ensemble
        self.buffer = buffer if buffer is not None else ReplayBuffer()
        self.policy = policy or EscalationPolicy()
        self._clock = clock or time.monotonic
        self.trigger = trigger or FineTuneTrigger(clock=self._clock)
        self._finetune = finetune
        self.finetune_kwargs = dict(finetune_kwargs or {})
        self.label = label
        self.escalation_batch = max(int(escalation_batch), 1)
        self.telemetry = telemetry
        self.stats = ActiveStats()
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._pending: list = []     # structures awaiting ensemble eval
        self._step = itertools.count(1)
        share_device_budget(self._card_users())

    def _card_users(self) -> list:
        """The serving potentials (every replica's, or the engine's) and the
        ensemble lane."""
        replicas = getattr(self.serving, "replicas", None)
        engines = ([r.engine for r in replicas.values()] if replicas is not None
                   else [self.serving])
        return [getattr(e, "potential", None) for e in engines] + [self.ensemble]

    # ------------------------------------------------------------------
    # serving path
    # ------------------------------------------------------------------

    def submit(self, atoms, escalate: bool | None = None, **kwargs):
        """Forward to the serving surface; returns its Future unchanged.
        ``escalate`` overrides the sampling policy for this request."""
        fut = self.serving.submit(atoms, **kwargs)
        decide = (bool(escalate) if escalate is not None
                  else bool(self._rng.random() < self.policy.sample_rate))
        with self._lock:
            self.stats.submitted += 1
            if decide:
                self.stats.escalated += 1
                self._pending.append(atoms.copy())
                while len(self._pending) > self.policy.max_pending:
                    self._pending.pop(0)
                    self.stats.escalation_dropped += 1
        if decide:
            mx = obsrt.metrics()
            if mx is not None:
                mx.counter("distmlip_active_escalations_total",
                           "requests routed to ensemble evaluation").inc()
        return fut

    @property
    def pending_escalations(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------------
    # escalation pump
    # ------------------------------------------------------------------

    def pump(self, max_batches: int | None = None) -> int:
        """Drain queued escalations through the ensemble in packed
        batches; returns the number of structures evaluated."""
        done = 0
        batches = 0
        while max_batches is None or batches < max_batches:
            with self._lock:
                if not self._pending:
                    break
                batch = self._pending[:self.escalation_batch]
                del self._pending[:len(batch)]
            done += self._evaluate_batch(batch)
            batches += 1
        return done

    def _evaluate_batch(self, batch) -> int:
        tr = obsrt.tracer()
        # its own (batch-level) trace; the ensemble's record stamps these
        # ids via the ambient context
        with (tr.span("active.escalate", new_trace=True,
                      attrs={"batch_size": len(batch)})
              if tr is not None else contextlib.nullcontext()):
            results = self.ensemble.calculate_with_variance(batch)
        scores = []
        added = 0
        for atoms, res in zip(batch, results):
            score = variance_score(res)
            scores.append(score)
            self.trigger.observe_variance(score)
            if self.policy.admits(res["energy_var"],
                                  float(np.asarray(
                                      res["forces_var"]).max(initial=0.0))):
                if self.label == "committee":
                    energy, forces = (res["committee_energy"],
                                      res["committee_forces"])
                else:
                    energy, forces = res["energy"], res["forces"]
                self.buffer.add(atoms, energy, forces, variance=score)
                added += 1
        with self._lock:
            self.stats.evaluated += len(batch)
            self.stats.buffered += added
        mx = obsrt.metrics()
        if mx is not None:
            mx.counter("distmlip_active_evaluated_total",
                       "structures re-evaluated under the ensemble").inc(
                           len(batch))
            mx.gauge("distmlip_active_buffer_size",
                     "replay-buffer depth").set(len(self.buffer))
        self._emit("active_escalate", batch_size=len(batch), extra={
            "variances": [round(float(s), 9) for s in scores],
            "buffer_added": added,
            "buffer_depth": len(self.buffer),
            "escalated_total": self.stats.escalated,
            "submitted_total": self.stats.submitted,
            "drift_ratio": self.trigger.drift_ratio(),
        })
        return len(batch)

    # ------------------------------------------------------------------
    # fine-tune + swap
    # ------------------------------------------------------------------

    def maybe_finetune(self) -> dict | None:
        """Run the gated fine-tune when the trigger says so. Returns a
        report dict (``shipped`` tells whether a swap happened), or None
        when not due."""
        depth = len(self.buffer)
        reason = self.trigger.due(depth)
        if reason is None:
            return None
        return self.finetune_now(reason=reason)

    def finetune_now(self, reason: str = "forced") -> dict:
        """Unconditionally fine-tune from the current buffer, gate on
        holdout, and hot-swap on improvement."""
        depth = len(self.buffer)
        samples = self.buffer.to_samples()
        self.trigger.note_fired(depth)
        with self._lock:
            self.stats.finetunes += 1
        if self._finetune is not None:
            report = self._finetune(samples, self.ensemble.params)
        else:
            kwargs = dict(self.finetune_kwargs)
            if "hbm_budget_bytes" not in kwargs:
                kwargs["hbm_budget_bytes"] = device_room_left(
                    kwargs.get("device") or self.ensemble.device, self._card_users())
            report = run_finetune(self.ensemble.model, self.ensemble.params,
                                  samples, telemetry=self.telemetry, **kwargs)
        report.reason = reason
        out = {k: v for k, v in vars(report).items() if k != "params"}
        if report.shipped and report.params is not None:
            with self._lock:
                self.stats.shipped += 1
            swap = self.swap_now(report.params)
            out["swap"] = swap
        else:
            with self._lock:
                self.stats.rejected_models += 1
        self._emit("active_finetune", extra={
            "reason": reason, "shipped": bool(report.shipped),
            "val_before": report.val_before, "val_after": report.val_after,
            "finetune_steps": report.steps, "buffer_depth": depth,
            "finetunes_total": self.stats.finetunes,
        })
        return out

    def swap_now(self, new_params) -> dict:
        """Hot-swap ``new_params`` into the serving surface and the
        ensemble's primary member. No new serving bucket (asserted inside
        :mod:`~.hotswap`), zero dropped requests, result cache keys rolled
        forward on a router."""
        tr = obsrt.tracer()
        with (tr.span("active.hotswap", new_trace=True)
              if tr is not None else contextlib.nullcontext()):
            swap = hot_swap(self.serving, new_params)
        # a standalone evaluator (not the engine's own potential) needs
        # its primary rolled too; set_primary is idempotent when the
        # engine swap already installed the weights
        self.ensemble.set_primary(new_params)
        with self._lock:
            self.stats.swaps += 1
        mx = obsrt.metrics()
        if mx is not None:
            mx.counter("distmlip_active_swaps_total",
                       "hot swaps shipped").inc()
        self._emit("active_swap", extra={
            "swap_count": self.stats.swaps,
            "model_digest": params_digest(new_params),
            "model_id": swap.get("model_id", ""),
            "buffer_depth": len(self.buffer),
        })
        return swap

    # ------------------------------------------------------------------
    # driver surface
    # ------------------------------------------------------------------

    def tick(self) -> dict:
        """One controller beat: drain escalations, fine-tune if due."""
        evaluated = self.pump()
        report = self.maybe_finetune()
        return {"evaluated": evaluated, "finetune": report,
                "buffer_depth": len(self.buffer)}

    def snapshot(self) -> dict:
        with self._lock:
            out = {"stats": self.stats.snapshot(),
                   "pending_escalations": len(self._pending)}
        out["buffer"] = self.buffer.stats()
        out["drift_ratio"] = self.trigger.drift_ratio()
        return out

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _emit(self, kind: str, batch_size: int = 0,
              extra: dict | None = None) -> None:
        tel = self.telemetry
        if tel is None or not tel.wants_records():
            return
        tel.emit(StepRecord(
            step=next(self._step), kind=kind, batch_size=batch_size,
            member_count=self.ensemble.member_count,
            extra=dict(extra or {})))
