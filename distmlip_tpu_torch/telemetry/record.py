"""Typed per-step telemetry records (``distmlip_tpu/telemetry/record.py``).

``StepRecord`` is the one schema every producer (DistPotential, DeviceMD,
MolecularDynamics, Relaxer, bench.py) emits and every sink consumes. It
replaces the untyped ``last_timings`` dicts: a record carries the per-phase
host timings, the graph shape and capacity/padding occupancy, per-partition
halo send/recv volumes, compile-cache and graph-cache hit/miss flags, and
device memory stats where the backend reports them (a CUDA card; the CPU
returns none). Every field and its JSON form are the JAX package's, so
either package's report reads the other's JSONL.

The reference implementation's analogue is the ad-hoc C TIMING macros +
torch.profiler ranges (SURVEY.md §5); both papers this repo tracks
(arXiv:2504.16068, arXiv:2504.10700) key their analyses on exactly this
per-phase / per-partition breakdown.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field

# Phase keys every consumer can rely on (sinks/report treat unknown phases
# generically, so producers may add more).
PHASE_KEYS = (
    "neighbor_s",       # host neighbor-list build (excl. prefetch join)
    "partition_s",      # plan + pad + device_put (warm path: positions upload)
    "prefetch_wait_s",  # time spent joining an in-flight background build
    "rebuild_s",        # on-device neighbor rebuild dispatch (no host FPIS)
    "device_s",         # potential dispatch + result fetch
    "total_s",          # whole calculate()/chunk wall time
)


@dataclass
class StepRecord:
    """One step (or device-MD chunk) of a distributed-potential workload."""

    # --- identity ---
    step: int = 0                    # producer-local step counter
    kind: str = "calculate"          # calculate | md_chunk | relax_step | ...
    t_wall: float = field(default_factory=time.time)  # unix seconds
    # observability correlation (distmlip_tpu_torch.obs): the trace/span this
    # record was emitted under — a serve_batch record carries its batch
    # span, a fleet_request record its request root — so JSONL records
    # line up with the exported Perfetto span trees ("" = no tracer)
    trace_id: str = ""
    span_id: str = ""

    # --- per-phase host timings (seconds) ---
    timings: dict[str, float] = field(default_factory=dict)

    # --- graph shape + capacity/padding occupancy ---
    n_atoms: int = 0
    num_partitions: int = 0
    n_cap: int = 0                   # node capacity per partition
    e_cap: int = 0                   # edge capacity per partition
    b_cap: int = 0                   # bond-node capacity (0: no bond graph)
    n_nodes_per_part: list[int] = field(default_factory=list)  # real rows
    n_edges_per_part: list[int] = field(default_factory=list)
    node_occupancy: float = 0.0      # max real nodes / n_cap over partitions
    edge_occupancy: float = 0.0      # max real edges / e_cap over partitions
    # fraction of real edges that wait on the halo exchange (worst
    # partition) — the non-overlappable tail of the interior/frontier split
    frontier_edge_frac: float = 0.0

    # --- 2-D mesh placement (parallel/mesh.py; 0/empty = unknown/legacy) ---
    mesh_shape: list[int] = field(default_factory=list)  # [batch, spatial]
    spatial_parts: int = 0           # spatial (halo-ring) extent of the placement
    batch_parts: int = 0             # batch-shard extent of the placement

    # --- batched multi-structure engine (calculators/batched.py) ---
    batch_size: int = 0              # real structures this step (0: unbatched)
    bucket_key: str = ""             # compiled-shape bucket id (n/e/B caps)
    padding_waste_frac: float = 0.0  # dead padded slots / total slots
    structures_per_sec: float = 0.0  # batch throughput (batch_size / total_s)
    batch_occupancy: float = 0.0     # real structures / padded batch slots

    # --- serving engine (serve/engine.py; kind serve_batch/serve_fallback) ---
    queue_depth: int = 0             # requests still queued after dispatch
    queue_wait_s: list[float] = field(default_factory=list)   # per request
    request_latency_s: list[float] = field(default_factory=list)  # submit→done
    reject_count: int = 0            # cumulative admission rejects at emit
    deadline_miss_count: int = 0     # cumulative deadline misses at emit
    shed_count: int = 0              # cumulative deadline-shed requests at emit

    # --- ensemble / active-learning (calculators.EnsemblePotential,
    #     active/uncertainty.py; kind ensemble_calculate/ensemble_batched
    #     and the active_* records) ---
    member_count: int = 0            # ensemble members evaluated (0: single)

    # --- serving fleet (fleet/router.py; kind fleet_request) ---
    tenant: str = ""                 # submitting tenant ("" = unattributed)
    replica_id: str = ""             # replica that served it ("" = no chip:
    #                                  cache hit, or failed pre-dispatch)
    cache_hit: bool = False          # served from the content-addressed cache
    aot_rehydrated: bool = False     # executable came from the AOT cache
    #                                  (no trace/compile on this replica)

    # --- halo pipeline + device-program cost model ---
    halo_mode: str = ""              # coalesced | legacy ("" = unknown)
    collective_count: int = 0        # collectives in the traced step program
    # static contract audit of the step program (the JAX package's
    # analysis passes; 0 in the port until the static analysis, ROADMAP.md A13)
    contract_error_count: int = 0    # unsuppressed ERROR findings
    contract_warning_count: int = 0  # unsuppressed WARNING findings
    # kernel dispatch of the step (kernels/dispatch): "cuda" when any
    # call site launched a hand-written CUDA kernel, "plain" when all took
    # the plain PyTorch versions, "" unknown (the JAX package writes
    # "pallas" / "xla")
    kernel_mode: str = ""
    # fraction of kernel call sites served by a hand-written kernel in the
    # step (1.0 = every site, 0.0 = all plain)
    kernel_coverage: float = 0.0
    flops_per_step: float = 0.0      # analytic estimate (utils/flops.py)
    mfu: float = 0.0                 # flops / (device_s * devices * peak)

    # --- halo volumes (rows exchanged per partition, summed over shifts) ---
    halo_send_per_part: list[int] = field(default_factory=list)
    halo_recv_per_part: list[int] = field(default_factory=list)
    bond_halo_send_per_part: list[int] = field(default_factory=list)

    # --- neighbor rebuilds (device-resident rebuild, neighbors/device.py) ---
    rebuild_count: int = 0           # graph (re)builds this step/chunk
    rebuild_on_device: int = 0       # of those, rebuilt ON DEVICE (no host FPIS)
    rebuild_overflow_count: int = 0  # cumulative device-capacity fallbacks
    # per-rebuild latency rides timings["rebuild_s"] (phase table picks it up)

    # --- cache behavior ---
    graph_reused: bool = False       # skin cache hit (positions-only scatter)
    rebuild: bool = False            # this step built/adopted a new graph
    prefetch_adopted: bool = False   # rebuild absorbed by the background build
    prefetch_skipped_hbm: bool = False  # speculative build vetoed: HBM guard
    compile_cache_size: int = 0      # compiled shape buckets after step
    compiled: bool = False           # this step dispatched a new shape bucket
    # --- compile telemetry (obs/profiling.py; meaningful when compiled
    #     or aot_rehydrated — 0.0/"" on warm steps and in old JSONL) ---
    compile_s: float = 0.0           # trace+lower+compile (or rehydrate) wall
    compile_kind: str = ""           # "fresh" | "aot" | "" (no compile)

    # --- static HBM plan (analysis/memory.py; 0 = no estimate observed) ---
    # estimated per-device peak live bytes of the step's traced program
    # (BucketPolicy-calibrated on the batched engine; compared against
    # measured bytes_in_use by the report's hbm_estimator_drift check)
    est_peak_bytes: int = 0
    # 1 - est_peak_bytes / bytes_limit against the worst device's limit
    # (or the configured budget); 0.0 = unknown (no estimate or no limit)
    hbm_headroom_frac: float = 0.0

    # --- device memory (bytes; empty where the backend reports nothing) ---
    device_memory: dict[str, int] = field(default_factory=dict)

    # --- free-form producer extras ---
    extra: dict = field(default_factory=dict)

    # ---- serialization ----
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "StepRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        # unknown keys (a newer writer) ride along in extra, not lost
        unknown = {k: v for k, v in d.items() if k not in known}
        rec = cls(**kw)
        if unknown:
            rec.extra = {**rec.extra, **unknown}
        return rec

    @classmethod
    def from_json(cls, line: str) -> "StepRecord":
        return cls.from_dict(json.loads(line))

    # ---- convenience ----
    @property
    def total_s(self) -> float:
        t = self.timings.get("total_s")
        if t is not None:
            return float(t)
        return float(sum(v for k, v in self.timings.items()
                         if k != "total_s"))

    def halo_imbalance(self) -> float:
        """max/mean of per-partition halo send volume (1.0 = balanced)."""
        v = self.halo_send_per_part
        if not v:
            return 1.0
        mean = sum(v) / len(v)
        return (max(v) / mean) if mean > 0 else 1.0

    def spatial_halo_imbalance(self) -> float:
        """Halo-send imbalance measured PER MESH AXIS: on a 2-D placement
        each batch row is its own spatial ring, so max/mean is computed
        within each row (different batch shards legitimately carry
        different structures/volumes) and the worst row is reported.
        Falls back to the flat ``halo_imbalance`` off-mesh."""
        v = self.halo_send_per_part
        S = self.spatial_parts
        if not v or S <= 1 or len(v) % S != 0:
            return self.halo_imbalance()
        worst = 1.0
        for b in range(len(v) // S):
            row = v[b * S:(b + 1) * S]
            mean = sum(row) / S
            if mean > 0:
                worst = max(worst, max(row) / mean)
        return worst


@dataclass
class TrainRecord(StepRecord):
    """One optimizer step of a training run (train/loop.py).

    Subclasses :class:`StepRecord` so every existing sink consumes it
    unchanged; a reader parsing mixed JSONL as ``StepRecord`` sees the
    training fields ride along in ``extra`` (``from_dict`` keeps unknown
    keys), and the report's training section reads them from either place.
    """

    kind: str = "train_step"

    # --- loss decomposition (this step's micro-batch mean, fp32) ---
    loss: float = 0.0
    loss_energy: float = 0.0
    loss_force: float = 0.0
    loss_stress: float = 0.0
    val_loss: float = float("nan")   # NaN = no eval ran this step

    # --- optimizer dynamics ---
    grad_norm: float = 0.0           # global grad norm BEFORE clipping
    loss_scale: float = 0.0          # dynamic loss scale after this step
    skipped: bool = False            # nonfinite grads: update skipped
    epoch: int = 0

    # --- schedule shape ---
    accum_steps: int = 0             # micro-batches per optimizer step
    micro_batch_size: int = 0        # structures per micro-batch
    examples_per_sec: float = 0.0    # structures consumed / step wall time

    # --- data distribution (cost-model packing, train/packing.py) ---
    # padding_waste_frac rides the inherited StepRecord field — ONE
    # definition shared with the serving pack stats (partition.batch)
    tier: int = 0                    # frozen capacity tier this step ran
    edge_balance: float = 1.0        # worst mean/max edge balance across
    #                                  mesh batch rows + window micros

    @staticmethod
    def training_field(record: "StepRecord", name: str, default=0.0):
        """Read a training field off a live TrainRecord OR a StepRecord
        re-parsed from JSONL (where the field rides in ``extra``)."""
        if name in getattr(record, "extra", {}):
            return record.extra[name]
        return getattr(record, name, default)


# the typed fields of a StepRecord (producers route their keys by it)
STEP_RECORD_FIELDS = frozenset(f.name for f in dataclasses.fields(StepRecord))


# ---------------------------------------------------------------------------
# shared phase-statistics helpers (one implementation for the live
# AggregatingSink and the offline report — the two tables must not drift)
# ---------------------------------------------------------------------------


def percentile(sorted_xs: list[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY SORTED sample list."""
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    return sorted_xs[min(n - 1, int(q * (n - 1) + 0.5))]


def phase_stats_from_samples(xs: list[float], total_s: float | None = None,
                             count: int | None = None) -> dict:
    """total/count/mean/p50/p90/p99/max stats for one phase.

    ``total_s``/``count`` override the sample-derived values when the
    samples are a decimated subset of the real stream (AggregatingSink)."""
    xs = sorted(xs)
    if not xs:
        return {"total_s": float(total_s or 0.0), "count": int(count or 0)}
    total_s = float(sum(xs)) if total_s is None else float(total_s)
    count = len(xs) if count is None else int(count)
    return {
        "total_s": total_s, "count": count,
        "mean_s": total_s / max(count, 1),
        "p50_s": percentile(xs, 0.50), "p90_s": percentile(xs, 0.90),
        "p99_s": percentile(xs, 0.99), "max_s": xs[-1],
    }


def format_phase_table(phases: dict) -> str:
    """Render {phase: stats} (as produced above) as the per-phase table,
    ordered by total time descending."""
    lines = [
        "phase                    total_s   mean_ms    p50_ms    p90_ms"
        "    p99_ms    max_ms  calls"
    ]
    order = sorted(phases, key=lambda k: phases[k].get("total_s", 0.0),
                   reverse=True)
    for k in order:
        s = phases[k]
        if "mean_s" not in s:
            continue
        lines.append(
            f"{k:<24} {s['total_s']:8.3f} {1e3 * s['mean_s']:9.2f} "
            f"{1e3 * s['p50_s']:9.2f} {1e3 * s['p90_s']:9.2f} "
            f"{1e3 * s['p99_s']:9.2f} {1e3 * s['max_s']:9.2f} "
            f"{s['count']:6d}")
    return "\n".join(lines)
