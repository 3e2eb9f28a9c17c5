"""Fine-tune triggering + the gated, preemption-safe fine-tune job
(``distmlip_tpu/active/trigger.py``).

:class:`FineTuneTrigger` decides WHEN the loop fine-tunes — any of three
threshold policies firing is enough:

- **buffer size** — the replay buffer reached ``min_buffer`` fresh
  (not-yet-trained-on) entries;
- **variance drift** — the recent mean escalation variance exceeds
  ``variance_drift`` x the run's baseline (the first observation
  window), i.e. the live traffic drifted away from what the model
  knows;
- **wall-clock cadence** — ``interval_s`` elapsed since the last
  fine-tune (on the injectable clock).

``cooldown_s`` spaces fine-tunes regardless of which policy fires.

:func:`run_finetune` is the job itself: split the buffer into
train/holdout, run the port's :class:`~distmlip_tpu_torch.train.loop.Trainer`
(``torch.optim.Adam`` by default, where the JAX package uses ``optax.adam``)
on the card through
the existing ``PackedBatchLoader``/checkpoint machinery (pass
``checkpoint_dir`` and an interrupted job resumes from its newest
checkpoint — the Trainer's bitwise-resume contract makes preemption
free), and GATE on held-out improvement: the candidate (EMA) weights
ship only if their holdout loss beats the CURRENT weights' holdout loss
— a worse model never ships. On a card that serving replicas share, the
trainer is built and torn down under the card's phase lock
(``device.device_phase``, which its steps and evals take as well), so its
allocations never land in a replica's measured batch peak; its memory gate
plans against ``hbm_budget_bytes``, which :class:`~.loop.ActiveLoop` sets
to the card less the serving potentials' budgets
(``calculators.batched.device_room_left``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class TriggerPolicy:
    """Thresholds for :class:`FineTuneTrigger` (0/None disables each)."""

    min_buffer: int = 16           # fresh buffered structures to fire on
    interval_s: float = 0.0        # wall-clock cadence (0: disabled)
    variance_drift: float = 0.0    # recent/baseline variance ratio (0: off)
    drift_window: int = 16         # observations per drift window
    cooldown_s: float = 0.0        # min spacing between fine-tunes


class FineTuneTrigger:
    """Threshold machine over buffer depth / variance drift / wall clock."""

    def __init__(self, policy: TriggerPolicy | None = None, clock=None):
        self.policy = policy or TriggerPolicy()
        self._clock = clock or time.monotonic
        self._recent = deque(maxlen=max(self.policy.drift_window, 1))
        self._baseline: float | None = None
        self._last_fired: float | None = None
        # the interval cadence anchors at CONSTRUCTION, not at "never":
        # a fresh trigger fires its first interval fine-tune interval_s
        # after startup, not on the first tick
        self._interval_anchor = self._clock()
        self._consumed_depth = 0      # buffer entries already trained on
        self.fired = 0

    def observe_variance(self, score: float) -> None:
        """Feed one escalation's variance score into the drift tracker.
        The FIRST full window becomes the baseline; later windows are
        compared against it."""
        self._recent.append(float(score))
        if (self._baseline is None
                and len(self._recent) == self._recent.maxlen):
            self._baseline = sum(self._recent) / len(self._recent)
            self._recent.clear()

    def drift_ratio(self) -> float:
        """Recent mean variance / baseline (0.0 until a baseline and a
        fresh observation exist)."""
        if not self._baseline or not self._recent:
            return 0.0
        return (sum(self._recent) / len(self._recent)) / self._baseline

    def due(self, buffer_depth: int) -> str | None:
        """The reason a fine-tune should run now, or None. Never fires
        on an empty buffer — there is nothing to train on."""
        now = self._clock()
        p = self.policy
        if buffer_depth < 1:
            return None
        if (p.cooldown_s > 0.0 and self._last_fired is not None
                and now - self._last_fired < p.cooldown_s):
            return None
        fresh = buffer_depth - self._consumed_depth
        if p.min_buffer > 0 and fresh >= p.min_buffer:
            return f"buffer_size ({fresh} fresh >= {p.min_buffer})"
        if p.variance_drift > 0.0:
            ratio = self.drift_ratio()
            if ratio >= p.variance_drift:
                return (f"variance_drift ({ratio:.2f}x baseline >= "
                        f"{p.variance_drift:.2f}x)")
        if p.interval_s > 0.0:
            since = now - (self._last_fired if self._last_fired is not None
                           else self._interval_anchor)
            if since >= p.interval_s:
                return f"interval ({p.interval_s:.0f}s cadence)"
        return None

    def note_fired(self, buffer_depth: int) -> None:
        self._last_fired = self._clock()
        self._consumed_depth = int(buffer_depth)
        self.fired += 1


@dataclass
class FineTuneReport:
    """What one fine-tune job did. ``params`` is None when the holdout
    gate rejected the candidate (the live model stays)."""

    params: object = None
    shipped: bool = False
    val_before: float = float("nan")
    val_after: float = float("nan")
    steps: int = 0
    n_train: int = 0
    n_holdout: int = 0
    resumed_step: int = 0
    reason: str = ""
    history: list = field(default_factory=list)


def holdout_split(samples, holdout_frac: float = 0.25,
                  min_holdout: int = 1):
    """Deterministic train/holdout split of a buffer snapshot: every
    ``round(1/holdout_frac)``-th sample (by buffer priority order) is
    held out, so both sides span the variance range."""
    n = len(samples)
    k = max(int(round(n * holdout_frac)), min_holdout)
    if n < 2 or k >= n:
        return list(samples), list(samples[:max(n, 1)])
    stride = max(n // k, 2)
    hold_idx = set(range(0, n, stride))
    holdout = [s for i, s in enumerate(samples) if i in hold_idx]
    train = [s for i, s in enumerate(samples) if i not in hold_idx]
    return train, holdout


def run_finetune(model, params, samples, *, optimizer=None,
                 steps: int = 50, holdout_frac: float = 0.25,
                 learning_rate: float = 1e-3, min_improvement: float = 0.0,
                 checkpoint_dir: str | None = None,
                 config=None, micro_batch_size=None,
                 loader_kwargs: dict | None = None,
                 telemetry=None, device=None,
                 hbm_budget_bytes: int | None = None) -> FineTuneReport:
    """One gated fine-tune of ``params`` on buffered samples.

    Builds a Trainer over the train split (``loader_kwargs`` carries the
    model-specific plumbing — ``species_fn``, ``use_bond_graph``/
    ``bond_cutoff``), resumes from ``checkpoint_dir`` when an
    interrupted job left a checkpoint there, runs ``steps`` optimizer
    steps, and evaluates holdout loss before/after on the weights that
    would ship (EMA when enabled). The candidate ships only when
    ``val_after < val_before * (1 - min_improvement)``.

    ``params``: a tree of tensors or numpy arrays. ``optimizer``: a factory
    ``params -> torch.optim.Optimizer`` (default Adam at
    ``learning_rate``). ``device``: where the job runs; default the device
    of ``params``' tensors, else CUDA. ``hbm_budget_bytes``: the Trainer's
    memory budget (default the card's memory); on a card that serving
    replicas share, leave out their budgets. The shipped ``params`` are the
    trainer's fp32 master (or EMA) leaves on that device, detached."""
    import functools

    import torch

    from ..device import device_phase, resolve_device
    from ..train import TrainConfig, Trainer
    from ..train.checkpoint import latest_checkpoint
    from ..train.step import tree_map
    from .hotswap import tree_leaves

    if device is None:
        dev = next((x.device for x in tree_leaves(params) if isinstance(x, torch.Tensor)),
                   None)
        device = resolve_device(dev)
    device = resolve_device(device)
    train_set, holdout = holdout_split(samples, holdout_frac)
    lk = dict(loader_kwargs or {})
    # default: NO EMA — an active-learning fine-tune is short (tens of
    # steps), and an EMA over so few steps is still mostly the initial
    # (drifted) weights; pass a config with ema_decay > 0 for long jobs
    cfg = config or TrainConfig(ema_decay=0.0)
    if micro_batch_size is None:
        micro_batch_size = max(min(len(train_set) // cfg.accum_steps, 4), 1)
    with device_phase(device):
        trainer = Trainer(
            model.energy_fn, params,
            optimizer or functools.partial(torch.optim.Adam, lr=learning_rate),
            train_set, float(model.cfg.cutoff),
            micro_batch_size=micro_batch_size, config=cfg,
            val_samples=holdout, checkpoint_dir=checkpoint_dir,
            checkpoint_every=max(steps // 2, 1) if checkpoint_dir else 0,
            telemetry=telemetry, loader_kwargs=lk, device=device,
            hbm_budget_bytes=hbm_budget_bytes)
    try:
        # the gate's baseline is the LIVE serving weights — evaluated
        # BEFORE any checkpoint restore, so a resumed job that was
        # mid-divergence when preempted is still compared against what
        # is actually serving, not against its own bad checkpoint
        val_before = trainer.evaluate()["loss"]
        resumed = 0
        if checkpoint_dir and latest_checkpoint(checkpoint_dir) is not None:
            # preemption recovery: a killed job's newest checkpoint
            # carries the full TrainState + loader cursor — continue,
            # don't restart
            with device_phase(device):
                resumed = trainer.restore()
        remaining = max(steps - resumed, 0)
        history = trainer.fit(steps=remaining) if remaining else []
        val_after = trainer.evaluate()["loss"]
        candidate = tree_map(lambda x: x.detach(),
                             trainer.state.ema_params if cfg.ema_decay > 0.0
                             else trainer.state.params)
        shipped = val_after < val_before * (1.0 - float(min_improvement))
        return FineTuneReport(
            params=candidate if shipped else None, shipped=shipped,
            val_before=float(val_before), val_after=float(val_after),
            steps=remaining, n_train=len(train_set),
            n_holdout=len(holdout), resumed_step=resumed,
            history=[h.get("loss") for h in history])
    finally:
        with device_phase(device):
            trainer.close()
            del trainer
