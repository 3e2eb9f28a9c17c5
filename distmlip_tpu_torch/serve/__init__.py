"""Async serving engine: continuous micro-batching over the batched
multi-structure potential (``distmlip_tpu/serve``).

Callers ``submit()`` single structures with a priority and a deadline and
get Futures; a background scheduler assembles bucket-aware micro-batches
(``scheduler.plan_batch``) and runs them through one shared
``BatchedPotential``, with admission control, a ``DistPotential`` fallback
lane for oversized structures and per-request error isolation::

    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.serve import ServeEngine

    engine = ServeEngine(BatchedPotential(model, params), max_batch=8)
    result = engine.submit(atoms, priority=0, deadline=1.0).result()
    engine.close()               # drains in-flight work first

``loadgen`` drives an engine with closed- and open-loop traffic.
"""

from .engine import ADMISSION_MODES, EngineClosed, ServeEngine, ServeRejected, ServeStats
from .loadgen import LoadReport, percentile, run_closed_loop, run_open_loop
from .scheduler import BatchPlan, plan_batch

__all__ = [
    "ServeEngine", "ServeStats", "ServeRejected", "EngineClosed", "ADMISSION_MODES",
    "BatchPlan", "plan_batch", "LoadReport", "percentile", "run_closed_loop",
    "run_open_loop",
]
