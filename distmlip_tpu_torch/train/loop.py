"""Trainer: the epoch/step loop (``distmlip_tpu/train/loop.py``).

``Trainer`` owns the loader (deterministic, prefetching), the accumulated
step, periodic held-out eval on the EMA weights, resumable async
checkpoints, best-model tracking, the per-step ``history`` and, with a
telemetry hub, one ``TrainRecord`` a step.

Micro-batch sizing against the card's memory: the JAX package plans a
step's peak statically over its jaxpr; the port measures it. For each
frozen capacity tier, one step runs on a throwaway copy of the state (no
update kept) with the allocator's high-water mark reset before it
(``device.begin_peak_measurement``), and ``torch.cuda.max_memory_allocated``
read after it
(:func:`estimate_step_peak_bytes`). ``micro_batch_size="auto"`` halves a
power-of-two candidate until every tier's peak fits ``hbm_budget_frac`` of
the budget (default ``utils.memory.device_bytes_limit()``, the card's
memory); an explicit size is checked the same way and refused up front
when it does not fit. On the CPU nothing is measured and the gate is
skipped, as the JAX package skips it without a memory limit.
"""

from __future__ import annotations

import math
import time

import torch

from ..device import begin_peak_measurement, device_phase, resolve_device
from ..obs import profiling as obs_profiling
from ..telemetry import TrainRecord
from ..utils.memory import device_bytes_limit
from .checkpoint import TrainCheckpointer
from .data import PackedBatchLoader
from .step import (TrainConfig, clone_state, init_train_state, make_accum_train_step,
                   make_eval_step)


def estimate_step_peak_bytes(step_fn, state, batch, device) -> int | None:
    """The measured peak of one train step on ``device``: the step runs on
    ``clone_state(state)`` (the update is thrown away) after
    ``device.begin_peak_measurement``; returns
    ``torch.cuda.max_memory_allocated``, or None on the CPU. A step that
    runs out of memory reads as an infinite peak."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    # under the card's phase lock: the reset and the read bracket this step
    # alone, never a serving replica's measured batch on the same card
    with device_phase(device):
        dev_batch = batch.to(device)
        copy = clone_state(state)
        torch.cuda.synchronize(device)
        begin_peak_measurement(device)
        try:
            step_fn(copy, dev_batch.graphs, dev_batch.targets)
            torch.cuda.synchronize(device)
            peak = int(torch.cuda.max_memory_allocated(device))
        except torch.cuda.OutOfMemoryError:
            peak = math.inf
        del copy, dev_batch
        torch.cuda.empty_cache()
    return peak


class Trainer:
    """End-to-end training over a labelled dataset of structures
    (``distmlip_tpu/train/loop.py:47-361``).

    Parameters
    ----------
    model_energy_fn, params, optimizer:
        the model's energy function, its initial parameters (fp32 master
        copies are made on ``device``) and an optimizer FACTORY,
        ``params -> torch.optim.Optimizer`` (the JAX Trainer takes an optax
        transformation); ``scheduler`` optionally a factory ``optimizer ->
        lr scheduler``, stepped once per applied step.
    samples:
        ``list[train.data.Sample]`` training set.
    cutoff:
        neighbor cutoff of the packed graphs (the model's cutoff).
    micro_batch_size:
        structures per micro-batch, or ``"auto"`` (fit the memory budget).
    config:
        :class:`TrainConfig`.
    mesh:
        must be None: the port trains on one card (ROADMAP.md A4).
    val_samples / eval_every:
        held-out set and eval cadence in optimizer steps (0 = once per
        epoch). Eval runs on the EMA weights when EMA is on.
    checkpoint_dir / checkpoint_every / keep_checkpoints:
        resumable async checkpoints (0 = once per epoch); best-model
        tracking keys on the eval loss.
    hbm_budget_bytes / hbm_budget_frac:
        the memory gate (module docstring).
    telemetry:
        a ``telemetry.Telemetry`` hub or None; with one, every optimizer
        step emits a ``TrainRecord`` (losses, grad norm, loss scale, skipped
        flag, examples/s, tier, padding waste, edge balance, the tier's
        measured peak), ``distmlip_tpu/train/loop.py:262-301``. A step on a
        tier not stepped before goes into the compile log
        (``obs.profiling``, site ``train_step``) either way.
    device:
        where the step runs (default CUDA; ``"cpu"`` for the plain path).
    """

    def __init__(self, model_energy_fn, params, optimizer, samples, cutoff: float, *,
                 micro_batch_size="auto", config: TrainConfig = TrainConfig(), mesh=None,
                 val_samples=None, eval_every: int = 0, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, keep_checkpoints: int = 3,
                 hbm_budget_bytes: int | None = None, hbm_budget_frac: float = 0.8,
                 telemetry=None, seed: int = 0, kernels: bool = True,
                 loader_kwargs: dict | None = None, scheduler=None, device=None):
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.config = config
        self.eval_every = int(eval_every)
        self.checkpoint_every = int(checkpoint_every)
        self.history: list[dict] = []
        self.best_val: float | None = None
        self._stepped: set = set()
        lk = dict(loader_kwargs or {})
        lk.setdefault("seed", seed)
        lk.setdefault("accum_steps", config.accum_steps)

        self.state = init_train_state(optimizer, params, mesh, config, seed=seed,
                                      scheduler=scheduler, device=self.device)
        self.step_fn = make_accum_train_step(model_energy_fn, mesh, config, kernels=kernels)
        self.eval_fn = make_eval_step(model_energy_fn, mesh, config, kernels=kernels)

        budget = hbm_budget_bytes
        if budget is None and self.device.type == "cuda":
            budget = device_bytes_limit()
            if budget is None:
                raise RuntimeError(
                    f"Trainer on {self.device}: the card's memory limit could not be read, "
                    "so the memory gate has no budget; pass hbm_budget_bytes=")
        self.hbm_budget_bytes = budget
        self.est_peak_bytes = 0
        self.tier_peak_bytes: dict[int, int] = {}
        self.loader = self._size_loader(samples, cutoff, micro_batch_size, budget,
                                        hbm_budget_frac, lk)

        self._val_batch = (self.loader.eval_batch(val_samples).to(self.device)
                           if val_samples else None)
        self.checkpointer = (TrainCheckpointer(checkpoint_dir, keep=keep_checkpoints)
                             if checkpoint_dir else None)

    # ---- memory-aware micro-batch sizing ----

    def _probe_loader(self, samples, cutoff, B, lk, needs):
        lk = dict(lk)
        # a caller may hand a dataset census through loader_kwargs; one
        # made for an earlier candidate wins (both are the same dataset's)
        needs = needs if needs is not None else lk.pop("precomputed_needs", None)
        lk.pop("precomputed_needs", None)
        return PackedBatchLoader(samples, cutoff, micro_batch_size=B,
                                 precomputed_needs=needs, **lk)

    def _size_loader(self, samples, cutoff, micro_batch_size, budget, frac,
                     lk) -> PackedBatchLoader:
        accum = int(lk.get("accum_steps", 1))
        max_b = max(len(samples) // max(accum, 1), 1)
        needs = None
        if micro_batch_size == "auto":
            b = 1 << int(math.floor(math.log2(max_b)))
            candidates = []
            while b >= 1:
                candidates.append(b)
                b //= 2
        else:
            b = int(micro_batch_size)
            if b > max_b:
                raise ValueError(
                    f"micro_batch_size={b} needs {b * accum} structures per optimizer "
                    f"step but the dataset has {len(samples)}")
            candidates = [b]
        last_est = None
        for b in candidates:
            probe = self._probe_loader(samples, cutoff, b, lk, needs)
            needs = probe.needs
            if budget is None:
                return probe  # nothing to gate against (the CPU)
            last_est = self._estimate(probe)
            if last_est is None:  # the CPU with an explicit budget: nothing measured
                return probe
            if last_est <= frac * budget:
                self.est_peak_bytes = last_est
                return probe
            probe.close()
        raise ValueError(
            f"no micro-batch size from {candidates} fits the memory budget: the "
            f"smallest measured {last_est / 2**20:.1f} MiB vs budget "
            f"{frac * budget / 2**20:.1f} MiB ({frac:.0%} of {budget / 2**30:.2f} GiB); "
            "shrink the model or the accumulation window, or raise hbm_budget_frac")

    def _estimate(self, loader):
        # measure EVERY frozen capacity tier: each must fit, and the gate
        # compares the largest
        self.tier_peak_bytes = {}
        for tier, step in sorted(loader.tier_first_steps().items()):
            peak = estimate_step_peak_bytes(self.step_fn, self.state, loader._build(0, step),
                                            self.device)
            if peak is None:
                self.tier_peak_bytes = {}
                return None
            self.tier_peak_bytes[tier] = peak
        return max(self.tier_peak_bytes.values())

    @property
    def compile_count(self) -> int:
        """Distinct capacity tiers (shape buckets) the run has stepped: the
        counterpart of the JAX step's jit-cache size, at most
        ``loader.num_tiers``. Eager PyTorch compiles nothing."""
        return len(self._stepped)

    # ---- the loop ----

    @property
    def steps_per_epoch(self) -> int:
        return self.loader.steps_per_epoch

    def train_step(self) -> dict:
        """One optimizer step: next batch -> upload -> step. Returns the host
        metrics dict (floats; reading them waits for the card)."""
        t0 = time.perf_counter()
        batch = self.loader.next_batch()
        # the device work under the card's phase lock (``device.device_phase``):
        # a serving replica on the same card never measures this step's
        # allocations as its own
        with device_phase(self.device):
            dev = batch.to(self.device)
            t_data = time.perf_counter() - t0
            new_tier = batch.meta["bucket_key"] not in self._stepped
            self._stepped.add(batch.meta["bucket_key"])
            self.state, metrics = self.step_fn(self.state, dev.graphs, dev.targets)
            m = {k: float(v) for k, v in metrics.items()}
            del dev, metrics
        dt = time.perf_counter() - t0
        # compile log: the first step on a tier (its wall time, first-use
        # work included), the JAX step's jit compile
        compile_s, compile_kind = 0.0, ""
        if new_tier:
            compile_s, compile_kind = dt - t_data, obs_profiling.KIND_FRESH
            obs_profiling.record_compile(site="train_step", kind=compile_kind,
                                         wall_s=compile_s, bucket_key=batch.meta["bucket_key"])
        epoch = int(batch.meta.get("epoch", 0))
        step_no = int(m.pop("step"))
        # cadence keys on the APPLIED-step transition: a skipped step
        # leaves step_no where it was and must not re-fire eval/checkpoints
        advanced = not m["skipped"]
        m.update(epoch=epoch,
                 examples_per_sec=batch.meta.get("n_structures", 0) / max(dt, 1e-9),
                 tier=int(batch.meta.get("tier", 0)),
                 padding_waste_frac=batch.meta.get("padding_waste_frac", 0.0),
                 edge_balance=batch.meta.get("edge_balance", 1.0),
                 data_s=t_data, step_s=dt)

        if self._val_batch is not None and self._due(step_no, batch, self.eval_every,
                                                     advanced):
            val = self.evaluate()
            m["val_loss"] = val["loss"]
            if self.checkpointer is not None:
                if self.checkpointer.save_best(self.state, val["loss"], self.loader.state()):
                    self.best_val = val["loss"]
        if self.checkpointer is not None and self._due(step_no, batch,
                                                       self.checkpoint_every, advanced):
            self.checkpointer.save(self.state, self.loader.state(), step=step_no)
        if self.telemetry is not None:
            self._emit_record(m, batch, step_no, t_data, dt, compile_s, compile_kind)
        self.history.append(m)
        return m

    def _emit_record(self, m, batch, step_no, t_data, dt, compile_s, compile_kind) -> None:
        """One ``TrainRecord`` of the step just taken, from the host metrics
        it already read back (no device read of its own)."""
        tier = m["tier"]
        # the tier's measured peak (falling back to the run max), and the
        # headroom from the same number, so the record is self-consistent
        tier_est = self.tier_peak_bytes.get(tier, self.est_peak_bytes)
        self.telemetry.emit(TrainRecord(
            step=step_no, epoch=m["epoch"],
            timings={"data_s": t_data, "device_s": dt - t_data, "total_s": dt},
            loss=m["loss"], loss_energy=m["energy"], loss_force=m["force"],
            loss_stress=m["stress"], val_loss=m.get("val_loss", float("nan")),
            grad_norm=m["grad_norm"], loss_scale=m["loss_scale"], skipped=bool(m["skipped"]),
            accum_steps=self.config.accum_steps,
            micro_batch_size=self.loader.micro_batch_size,
            examples_per_sec=m["examples_per_sec"],
            batch_size=batch.meta.get("n_structures", 0),
            n_atoms=batch.meta.get("n_atoms", 0),
            bucket_key=batch.meta.get("bucket_key", ""),
            tier=tier, padding_waste_frac=m["padding_waste_frac"],
            edge_balance=m["edge_balance"],
            est_peak_bytes=tier_est,
            hbm_headroom_frac=(1.0 - tier_est / self.hbm_budget_bytes
                               if self.hbm_budget_bytes and tier_est else 0.0),
            compile_s=compile_s, compile_kind=compile_kind, compiled=bool(compile_kind)))

    def _due(self, step_no: int, batch, every: int, advanced: bool) -> bool:
        if every > 0:
            return advanced and step_no > 0 and step_no % every == 0
        # per epoch: the last batch of each epoch
        return batch.meta.get("step", -1) == self.loader.steps_per_epoch - 1

    def fit(self, epochs: int = 1, steps: int | None = None) -> list[dict]:
        """Run ``steps`` optimizer steps (default: ``epochs`` full passes).
        Returns the per-step history (cumulative across calls)."""
        total = int(steps) if steps is not None else int(epochs) * self.steps_per_epoch
        for _ in range(total):
            self.train_step()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return self.history

    def evaluate(self) -> dict:
        """Held-out loss components on the EMA weights (the master weights
        when EMA is off)."""
        if self._val_batch is None:
            raise ValueError("Trainer was built without val_samples")
        params = (self.state.ema_params if self.config.ema_decay > 0.0
                  else self.state.params)
        with device_phase(self.device):
            comps = self.eval_fn(params, self._val_batch.graphs, self._val_batch.targets)
            return {k: float(v) for k, v in comps.items()}

    # ---- checkpoint plumbing ----

    def save_checkpoint(self) -> str:
        if self.checkpointer is None:
            raise ValueError("Trainer was built without checkpoint_dir")
        path = self.checkpointer.save(self.state, self.loader.state())
        self.checkpointer.wait()
        return path

    def restore(self, path: str | None = None) -> int:
        """Resume from ``path`` (default: the newest checkpoint): the whole
        state AND the loader cursor. Returns the restored step."""
        if self.checkpointer is None:
            raise ValueError("Trainer was built without checkpoint_dir")
        self.state, loader_state = self.checkpointer.restore(self.state, path)
        self.loader.set_state(loader_state)
        return int(self.state.step)

    def close(self) -> None:
        self.loader.close()
        if self.checkpointer is not None:
            self.checkpointer.wait()
