"""Active learning: the uncertainty-routed serve -> train -> serve loop
(``distmlip_tpu/active``).

- :mod:`.uncertainty` — :class:`EnsembleBatchedPotential`, a
  ``BatchedPotential`` whose ``calculate`` serves the cheap primary
  member while ``calculate_with_variance`` re-evaluates the same packed
  batch under every member (one graph, one copy back), plus the
  cheap-first :class:`EscalationPolicy`;
- :mod:`.buffer` — :class:`ReplayBuffer`: dedup'd (the fleet result
  cache's canonical structure hash), variance-prioritized, atomically
  spilled to JSONL+npz in the JAX package's layout, and directly
  consumable by the trainer;
- :mod:`.trigger` — :class:`FineTuneTrigger` threshold policies (buffer
  size / variance drift / wall-clock cadence) and the gated,
  preemption-safe :func:`run_finetune` job over the port's ``Trainer``
  (a worse model never ships);
- :mod:`.hotswap` — weight swap into live ``ServeEngine``/``FleetRouter``
  replicas with no new serving bucket and the result-cache keys rolled
  forward (stale entries can never serve the new weights);
- :mod:`.loop` — :class:`ActiveLoop`, the controller: route -> buffer
  -> trigger -> train -> validate -> swap, synchronous and
  clock-injectable, with ``active_*`` telemetry rendered by the report.

Quick start::

    from distmlip_tpu_torch.active import (ActiveLoop, EnsembleBatchedPotential,
                                           EscalationPolicy, ReplayBuffer)
    from distmlip_tpu_torch.serve import ServeEngine

    ens = EnsembleBatchedPotential(model, [serving_params, *member_params])
    engine = ServeEngine(ens, max_batch=8)      # serves the primary member
    loop = ActiveLoop(engine, ens, ReplayBuffer(capacity=512),
                      policy=EscalationPolicy(sample_rate=0.05),
                      finetune_kwargs={"steps": 200,
                                       "loader_kwargs": {...}})
    fut = loop.submit(atoms)                    # same Future contract
    loop.tick()                                 # pump + maybe fine-tune/swap

Smoke/gate: ``python -m distmlip_tpu_torch.tools.load_test --fleet 2
--active --check`` (mid-burst hot swap, zero lost requests, no new
serving bucket).
"""

from .buffer import BufferEntry, ReplayBuffer
from .hotswap import (HotSwapError, check_swappable, hot_swap,
                      hot_swap_engine, hot_swap_router, params_digest,
                      swap_potential_params)
from .loop import ActiveLoop, ActiveStats
from .trigger import (FineTuneReport, FineTuneTrigger, TriggerPolicy,
                      holdout_split, run_finetune)
from .uncertainty import (EnsembleBatchedPotential, EscalationPolicy,
                          variance_score)

__all__ = [
    "ActiveLoop",
    "ActiveStats",
    "EnsembleBatchedPotential",
    "EscalationPolicy",
    "variance_score",
    "ReplayBuffer",
    "BufferEntry",
    "FineTuneTrigger",
    "TriggerPolicy",
    "FineTuneReport",
    "run_finetune",
    "holdout_split",
    "hot_swap",
    "hot_swap_engine",
    "hot_swap_router",
    "swap_potential_params",
    "check_swappable",
    "params_digest",
    "HotSwapError",
]
