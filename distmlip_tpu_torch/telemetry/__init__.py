"""Telemetry: structured step records, trace annotations, pluggable sinks
(``distmlip_tpu/telemetry/__init__.py``).

- ``StepRecord`` / ``TrainRecord`` — the typed per-step schema (timings,
  graph shape, capacity occupancy, halo volumes, cache behavior, device
  memory), field for field the JAX package's;
- ``Telemetry`` + sinks (``AggregatingSink``, ``JsonlSink``,
  ``StderrSummarySink``) — where records go;
- ``annotate``/``scope``/``device_trace`` — ``torch.profiler`` range names
  on the host phases and the models' layers;
- ``report`` — offline aggregation of a JSONL run
  (``python -m distmlip_tpu_torch.telemetry.report run.jsonl``).

Quick start::

    from distmlip_tpu_torch.telemetry import Telemetry, JsonlSink, AggregatingSink

    tel = Telemetry([JsonlSink("run.jsonl"), AggregatingSink()])
    pot = DistPotential(model, params, telemetry=tel)
    ...  # run MD / relax / calculate
    print(tel.sinks[1].summary())
    tel.close()
"""

from .record import PHASE_KEYS, StepRecord, TrainRecord
from .sinks import (AggregatingSink, JsonlSink, StderrSummarySink, Telemetry,
                    TelemetrySink)
from .trace import annotate, device_trace, scope, set_tracing, tracing_enabled

__all__ = [
    "PHASE_KEYS",
    "StepRecord",
    "TrainRecord",
    "Telemetry",
    "TelemetrySink",
    "AggregatingSink",
    "JsonlSink",
    "StderrSummarySink",
    "annotate",
    "scope",
    "device_trace",
    "set_tracing",
    "tracing_enabled",
]
