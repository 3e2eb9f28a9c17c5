"""Training on one card (``distmlip_tpu/train``).

- :mod:`.data` — labelled-structure datasets, deterministic seeded
  shuffling, block-diagonal packing at frozen capacities, target packing
  into the padded layout and a background prefetch loader with a
  resumable cursor;
- :mod:`.packing` — the cost census, capacity tiers and edge-balanced
  epoch plans (host numpy, bit for bit the JAX package's);
- :mod:`.step` — ``TrainState`` (fp32 master weights, a torch optimizer and
  scheduler, EMA, dynamic loss scale, generator), the packed force loss
  through the double backward, and the accumulated mixed-precision step;
- :mod:`.loop` — ``Trainer``: the epoch/step loop, EMA eval, best-model
  tracking, history, and micro-batch sizing against the card's memory
  from a measured step peak;
- :mod:`.checkpoint` — async atomic checkpoints with the state and the
  loader cursor;
- :mod:`.legacy` — the single-structure surface over the P-partition
  flattened graph.

Quick start::

    import functools, torch
    from distmlip_tpu_torch.train import Sample, TrainConfig, Trainer

    data = [Sample(atoms, energy, forces) for ...]
    trainer = Trainer(model.energy_fn, params,
                      functools.partial(torch.optim.Adam, lr=1e-3), data,
                      cutoff=model.cfg.cutoff, micro_batch_size=4,
                      config=TrainConfig(accum_steps=2),
                      val_samples=held_out, checkpoint_dir="ckpts")
    trainer.fit(epochs=10)
"""

from .checkpoint import TrainCheckpointer, latest_checkpoint
from .data import (PackedBatchLoader, Sample, TrainBatch, epoch_permutation,
                   labelled_dataset, pack_targets, structure_needs)
from .legacy import (load_train_state, make_batched_train_step, make_eval_fn,
                     make_loss_fn, make_train_step, save_train_state,
                     stack_graphs, stack_targets)
from .loop import Trainer, estimate_step_peak_bytes
from .packing import (CostCensus, assign_tiers, default_cost, model_cost_fn,
                      plan_epoch, plan_epoch_naive, predicted_plan_waste,
                      tier_caps)
from .step import (TrainConfig, TrainState, init_train_state,
                   make_accum_train_step, make_eval_step,
                   make_packed_loss_fn, resolve_zero1)

__all__ = [
    # the single-structure surface
    "make_loss_fn",
    "make_train_step",
    "make_batched_train_step",
    "make_eval_fn",
    "stack_graphs",
    "stack_targets",
    "save_train_state",
    "load_train_state",
    # data pipeline
    "Sample",
    "labelled_dataset",
    "PackedBatchLoader",
    "TrainBatch",
    "pack_targets",
    "epoch_permutation",
    "structure_needs",
    # cost-model packing
    "CostCensus",
    "assign_tiers",
    "default_cost",
    "model_cost_fn",
    "plan_epoch",
    "plan_epoch_naive",
    "predicted_plan_waste",
    "tier_caps",
    # step
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "make_accum_train_step",
    "make_packed_loss_fn",
    "make_eval_step",
    "resolve_zero1",
    # loop + checkpointing
    "Trainer",
    "estimate_step_peak_bytes",
    "TrainCheckpointer",
    "latest_checkpoint",
]
