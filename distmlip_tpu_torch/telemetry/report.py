"""Aggregate a JSONL telemetry run into the per-phase report
(``distmlip_tpu/telemetry/report.py``).

Run as ``python -m distmlip_tpu_torch.telemetry.report run.jsonl``: reads
``StepRecord`` JSONL (either package's),
produces the per-phase total/mean/percentile table plus run-level counters,
and flags the anomaly classes this repo has actually hit:

- **stall** — a step whose total wall time exceeds ``stall_factor`` x the
  run median (a wedged device's signature: one step silently taking
  minutes while nothing else reports it);
- **occupancy collapse** — capacity/padding occupancy below
  ``occupancy_floor``: the sticky capacity buckets grew far past the live
  graph, so most of every padded array (and the FLOPs over it) is waste;
- **halo imbalance** — max/mean per-partition halo send volume above
  ``imbalance_factor``: one partition's communication dominates, the slab
  decomposition needs rebalancing (arXiv:2504.10700's data-distribution
  failure mode);
- **host-rebuild dominant** — a device-rebuild-capable run (some rebuilds
  DID run on device) that still pays most of its rebuilds on the host:
  capacity overflows or structure churn are defeating the device-resident
  path, so the hot loop keeps stalling on host FPIS rebuilds;
- **kernel-fallback dominant** — an accelerator run (device memory stats
  reported) whose kernel call sites mostly took the plain PyTorch
  versions instead of the hand-written kernels (kernels/dispatch): a
  per-object ``kernels=False`` is likely left on;
- **hbm estimator drift** — flagged ONLY when measured device stats
  exist AND only on the sound side: the static HBM planner's
  ``est_peak_bytes`` exceeds 4x the backend's measured peak residency
  (the high-water mark bounds every true program peak from above, so
  a low ratio on a mixed run proves nothing) — retune the planner
  (analysis/memory.py) before trusting its admission gates.

Device-memory occupancy renders through the SAME worst-device fraction
the prefetch guard uses (``utils.memory.hbm_usage_frac``) — one parse,
no per-key duplication.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .record import (StepRecord, TrainRecord, format_phase_table, percentile,
                     phase_stats_from_samples)


def read_jsonl(path: str) -> list[StepRecord]:
    """Parse a telemetry JSONL file; blank/corrupt lines are skipped (a
    killed run may truncate its final line)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(StepRecord.from_json(line))
            except (json.JSONDecodeError, TypeError):
                continue
    return records


@dataclass
class Anomaly:
    kind: str       # stall | occupancy_collapse | halo_imbalance
    step: int
    detail: str


@dataclass
class Report:
    n_records: int = 0
    phases: dict = field(default_factory=dict)   # name -> stats dict
    counters: dict = field(default_factory=dict)
    anomalies: list = field(default_factory=list)

    def table(self) -> str:
        return format_phase_table(self.phases)

    def render(self) -> str:
        out = [self.table(), ""]
        c = self.counters
        out.append(
            f"records={self.n_records} rebuilds={c.get('rebuilds', 0)} "
            f"prefetch_adopted={c.get('prefetch_adopted', 0)} "
            f"compiles={c.get('compiles', 0)} "
            f"graph_reused={c.get('graph_reused', 0)}")
        if "compiles_fresh" in c or "compiles_aot" in c:
            out.append(
                f"compile: fresh={c.get('compiles_fresh', 0)} "
                f"aot_rehydrate={c.get('compiles_aot', 0)} "
                f"wall={c.get('compile_time_s', 0.0):.3f}s")
        if "min_node_occupancy" in c:
            out.append(
                f"occupancy: node min={c['min_node_occupancy']:.2f} "
                f"mean={c['mean_node_occupancy']:.2f}; "
                f"edge min={c['min_edge_occupancy']:.2f} "
                f"mean={c['mean_edge_occupancy']:.2f}")
        if "mesh_placements" in c:
            placements = " ".join(
                f"{b}x{s}" for b, s in c["mesh_placements"])
            line = (f"mesh placement (batch x spatial): {placements}")
            if "max_spatial_halo_imbalance" in c:
                line += (f"; spatial-ring send imbalance worst="
                         f"{c['max_spatial_halo_imbalance']:.2f}")
            out.append(line)
        if "max_halo_imbalance" in c:
            out.append(f"halo send imbalance (max/mean over partitions): "
                       f"worst={c['max_halo_imbalance']:.2f}")
        if c.get("rebuilds_total"):
            n_dev = c.get("rebuilds_on_device", 0)
            n_host = c["rebuilds_total"] - n_dev
            ovf = c.get("rebuild_overflows", 0)
            out.append(
                f"rebuilds: total={c['rebuilds_total']} on_device={n_dev} "
                f"host={n_host} overflow_fallbacks={ovf} "
                f"(overflow rate {ovf / max(c['rebuilds_total'], 1):.1%})")
        if "halo_modes" in c or "collective_count" in c:
            bits = []
            if "halo_modes" in c:
                bits.append(f"halo_mode={','.join(c['halo_modes'])}")
            if "collective_count" in c:
                bits.append(f"collectives/step={c['collective_count']}")
            if "mean_frontier_edge_frac" in c:
                bits.append(
                    f"frontier_edge_frac={c['mean_frontier_edge_frac']:.3f}")
            out.append("halo pipeline: " + " ".join(bits))
        if "kernel_modes" in c:
            out.append(
                f"fused kernels: mode={','.join(c['kernel_modes'])} "
                f"coverage mean={c['mean_kernel_coverage']:.2f}")
        if "mean_mfu" in c:
            out.append(f"mfu: mean={c['mean_mfu']:.3f} max={c['max_mfu']:.3f}")
        if c.get("roofline"):
            from ..obs.roofline import RooflineRow, format_roofline_table

            rows = [RooflineRow(
                program=d["program"], flops=d["flops"], bytes=d["bytes"],
                time_s=d["time_s"], peak_flops=d["peak_flops"],
                n_devices=d["n_devices"], source=d["source"])
                for d in c["roofline"]]
            out.append("")
            out.append(format_roofline_table(
                rows, title="roofline (record-derived; bytes = live-set "
                "proxy; program-accurate rows wait for the static analysis):"))
        if c.get("buckets"):
            out.append("")
            out.append("batched buckets (shape-bucketed compile cache):")
            out.append(
                "bucket                        steps  mean_B  node_occ"
                "  edge_occ  waste  structs/s")
            for key in sorted(c["buckets"]):
                b = c["buckets"][key]
                out.append(
                    f"{key:<28} {b['steps']:6d} {b['mean_batch_size']:7.1f} "
                    f"{b['mean_node_occupancy']:9.2f} "
                    f"{b['mean_edge_occupancy']:9.2f} "
                    f"{b['mean_padding_waste_frac']:6.2f} "
                    f"{b['mean_structures_per_sec']:10.1f}")
        if c.get("serving"):
            s = c["serving"]
            out.append("")
            out.append("serving (ServeEngine):")
            out.append(
                f"  requests={s['requests']} batches={s['batches']} "
                f"mean_batch_size={s['mean_batch_size']:.1f} "
                f"mean_batch_occupancy={s['mean_batch_occupancy']:.2f} "
                f"max_queue_depth={s['max_queue_depth']}")
            out.append(
                f"  queue_wait_ms p50={1e3 * s['queue_wait_p50_s']:.1f} "
                f"p95={1e3 * s['queue_wait_p95_s']:.1f} "
                f"p99={1e3 * s['queue_wait_p99_s']:.1f}")
            out.append(
                f"  latency_ms    p50={1e3 * s['latency_p50_s']:.1f} "
                f"p95={1e3 * s['latency_p95_s']:.1f} "
                f"p99={1e3 * s['latency_p99_s']:.1f}")
            out.append(
                f"  rejects={s['rejects']} "
                f"deadline_misses={s['deadline_misses']} "
                f"sheds={s.get('sheds', 0)} "
                f"fallback_batches={s['fallback_batches']}")
        if c.get("fleet"):
            fl = c["fleet"]
            out.append("")
            out.append("fleet (FleetRouter):")
            out.append(
                f"  requests={fl['requests']} "
                f"cache_hit_rate={fl['cache_hit_rate']:.2f} "
                f"coalesced={fl['coalesced']} "
                f"failovers={fl['failovers']} "
                f"redispatches={fl['redispatches']} "
                f"aot_rehydrated_steps={fl['aot_rehydrated_steps']}")
            for name, t in fl["tenants"].items():
                out.append(
                    f"  tenant {name:<16} n={t['requests']:<6d} "
                    f"latency_ms p50={1e3 * t['latency_p50_s']:.1f} "
                    f"p95={1e3 * t['latency_p95_s']:.1f} "
                    f"p99={1e3 * t['latency_p99_s']:.1f}")
            share = " ".join(f"{rid}={frac:.2f}"
                             for rid, frac in fl["replica_share"].items())
            if share:
                out.append(f"  replica load share: {share}")
        if c.get("active"):
            a = c["active"]
            out.append("")
            out.append("active learning (ActiveLoop):")
            out.append(
                f"  submitted={a['submitted']} escalated={a['escalated']} "
                f"rate={a['escalation_rate']:.2f} "
                f"members={a['member_count']} "
                f"buffer depth={a['buffer_depth']} "
                f"added={a['buffer_added']}")
            if "variance_p50" in a:
                out.append(
                    f"  variance p50={a['variance_p50']:.3g} "
                    f"p90={a['variance_p90']:.3g} "
                    f"max={a['variance_max']:.3g}")
            out.append(
                f"  finetunes={a['finetunes']} shipped={a['shipped']} "
                f"hot_swaps={a['swaps']}")
        if c.get("training"):
            t = c["training"]
            out.append("")
            out.append("training (train/loop.py):")
            out.append(
                f"  steps={t['steps']} epochs={t['epochs']} "
                f"accum={t['accum_steps']} "
                f"micro_batch={t['micro_batch_size']} "
                f"examples/s mean={t['mean_examples_per_sec']:.1f}")
            out.append(
                f"  loss first={t['first_loss']:.4g} "
                f"last={t['last_loss']:.4g} min={t['min_loss']:.4g}"
                + (f"  val best={t['best_val_loss']:.4g}"
                   if "best_val_loss" in t else ""))
            out.append(
                f"  grad_norm p50={t['grad_norm_p50']:.3g} "
                f"p95={t['grad_norm_p95']:.3g}  "
                f"loss_scale last={t['last_loss_scale']:.3g}  "
                f"skipped_steps={t['skipped_steps']}")
            if "mean_padding_waste_frac" in t:
                tiers = " ".join(
                    f"t{k}:{v}" for k, v in sorted(
                        t.get("steps_per_tier", {}).items()))
                out.append(
                    f"  packing: waste mean={t['mean_padding_waste_frac']:.2f}"
                    f" max={t['max_padding_waste_frac']:.2f} "
                    f"edge_balance min={t['min_edge_balance']:.2f} "
                    f"tiers={t['n_tiers']}"
                    + (f" steps[{tiers}]" if tiers else ""))
                by_ep = t.get("waste_by_epoch", {})
                if by_ep:
                    shown = sorted(by_ep)[:8]
                    out.append("  waste by epoch: " + " ".join(
                        f"{e}={by_ep[e]:.2f}" for e in shown)
                        + (" ..." if len(by_ep) > 8 else ""))
        if ("max_hbm_used_frac" in c or "max_est_peak_bytes" in c):
            bits = []
            if "max_hbm_used_frac" in c:
                bits.append(f"used worst={c['max_hbm_used_frac']:.0%}")
            if "max_est_peak_bytes" in c:
                bits.append(
                    f"est_peak={c['max_est_peak_bytes'] / 2**20:.1f}MiB")
            if "min_hbm_headroom_frac" in c:
                bits.append(
                    f"headroom min={c['min_hbm_headroom_frac']:.0%}")
            if "hbm_estimator_ratio" in c:
                bits.append(
                    f"est/measured={c['hbm_estimator_ratio']:.2f}x")
            out.append("hbm: " + " ".join(bits))
        if c.get("prefetch_skipped_hbm"):
            out.append(f"prefetch skipped by HBM guard: "
                       f"{c['prefetch_skipped_hbm']} step(s)")
        if c.get("trace"):
            from ..obs.export import format_critical_path

            out.append("")
            out.append(format_critical_path(c["trace"]))
        if self.anomalies:
            out.append("")
            out.append(f"ANOMALIES ({len(self.anomalies)}):")
            for a in self.anomalies:
                out.append(f"  [{a.kind}] step {a.step}: {a.detail}")
        else:
            out.append("no anomalies flagged")
        return "\n".join(out)

    def to_dict(self) -> dict:
        return {
            "n_records": self.n_records,
            "phases": self.phases,
            "counters": self.counters,
            "anomalies": [vars(a) for a in self.anomalies],
        }


def aggregate(
    records: list[StepRecord],
    stall_factor: float = 5.0,
    occupancy_floor: float = 0.35,
    imbalance_factor: float = 2.0,
) -> Report:
    rep = Report(n_records=len(records))
    if not records:
        return rep

    # --- per-phase table ---
    samples: dict[str, list[float]] = {}
    for r in records:
        for k, v in r.timings.items():
            samples.setdefault(k, []).append(float(v))
    for k, xs in samples.items():
        rep.phases[k] = phase_stats_from_samples(xs)

    # --- run counters ---
    c = rep.counters
    c["rebuilds"] = sum(r.rebuild for r in records)
    c["prefetch_adopted"] = sum(r.prefetch_adopted for r in records)
    c["compiles"] = sum(r.compiled for r in records)
    c["graph_reused"] = sum(r.graph_reused for r in records)
    # compile telemetry (obs/profiling.py): kind split + total wall paid
    # compiling. getattr-safe — a round may mix writers, with only some
    # records carrying the compile_s/compile_kind fields
    kinds = [str(getattr(r, "compile_kind", "") or "") for r in records]
    if any(kinds):
        c["compiles_fresh"] = sum(k == "fresh" for k in kinds)
        c["compiles_aot"] = sum(k == "aot" for k in kinds)
        c["compile_time_s"] = sum(
            float(getattr(r, "compile_s", 0.0) or 0.0) for r in records)
    node_occ = [r.node_occupancy for r in records if r.node_occupancy > 0]
    edge_occ = [r.edge_occupancy for r in records if r.edge_occupancy > 0]
    if node_occ and edge_occ:
        c["min_node_occupancy"] = min(node_occ)
        c["mean_node_occupancy"] = sum(node_occ) / len(node_occ)
        c["min_edge_occupancy"] = min(edge_occ)
        c["mean_edge_occupancy"] = sum(edge_occ) / len(edge_occ)
    # per-axis measure everywhere: on a 2-D placement each batch row is its
    # own spatial ring, so the summary metric must not conflate rows (same
    # rule the anomaly check below applies); off-mesh it equals the flat
    # max/mean
    imb = [r.spatial_halo_imbalance() for r in records
           if r.halo_send_per_part]
    if imb:
        c["max_halo_imbalance"] = max(imb)
    # 2-D mesh placements: which (batch x spatial) shapes the run used and
    # the worst per-axis (per batch row) spatial halo imbalance
    placements = sorted({tuple(r.mesh_shape) for r in records
                         if len(r.mesh_shape) == 2
                         and (r.mesh_shape[0] > 1 or r.mesh_shape[1] > 1)})
    if placements:
        c["mesh_placements"] = [list(p) for p in placements]
        sp_imb = [r.spatial_halo_imbalance() for r in records
                  if r.halo_send_per_part and r.spatial_parts > 1]
        if sp_imb:
            c["max_spatial_halo_imbalance"] = max(sp_imb)
    # overlap pipeline + cost model (0-valued fields = producer didn't know)
    modes = sorted({r.halo_mode for r in records if r.halo_mode})
    if modes:
        c["halo_modes"] = modes
    colls = [r.collective_count for r in records if r.collective_count > 0]
    if colls:
        c["collective_count"] = max(colls)
    # fused-kernel dispatch (kernels/dispatch): which modes the run's
    # traced programs used and the mean fraction of edge aggregations
    # served by the hand-written kernels ("" = producer observed none)
    kmodes = sorted({r.kernel_mode for r in records if r.kernel_mode})
    if kmodes:
        kcovs = [r.kernel_coverage for r in records if r.kernel_mode]
        c["kernel_modes"] = kmodes
        c["mean_kernel_coverage"] = sum(kcovs) / len(kcovs)
    # static contract audit (the analysis findings riding the
    # records): any error-severity finding on a shipped step program is an
    # anomaly — the program violates a stated runtime invariant
    cerrs = [r.contract_error_count for r in records
             if r.contract_error_count > 0]
    cwarns = [r.contract_warning_count for r in records
              if r.contract_warning_count > 0]
    if cerrs or cwarns:
        c["contract_errors"] = max(cerrs) if cerrs else 0
        c["contract_warnings"] = max(cwarns) if cwarns else 0
    if cerrs:
        rep.anomalies.append(Anomaly(
            "contract_errors", 0,
            f"{max(cerrs)} error-severity contract finding(s) in the "
            f"traced step program — run tools/contract_check.py for the "
            f"findings table"))
    fr = [r.frontier_edge_frac for r in records if r.frontier_edge_frac > 0]
    if fr:
        c["mean_frontier_edge_frac"] = sum(fr) / len(fr)
    mfus = [r.mfu for r in records if r.mfu > 0]
    if mfus:
        c["mean_mfu"] = sum(mfus) / len(mfus)
        c["max_mfu"] = max(mfus)
    # roofline rows (obs/roofline.py): only when some producer stamped a
    # FLOP estimate into extra — plain serving rounds yield none
    try:
        from ..obs.roofline import rows_from_records

        rrows = rows_from_records(records)
    except Exception:  # noqa: BLE001 - report must render regardless
        rrows = []
    if rrows:
        c["roofline"] = [row.as_dict() for row in rrows]
    c["prefetch_skipped_hbm"] = sum(
        getattr(r, "prefetch_skipped_hbm", False) for r in records)
    # device memory + static HBM plan: occupancy through the SAME
    # worst-device fraction the prefetch guard uses (utils/memory), the
    # planner's peak estimates, and prediction-vs-measured drift. The
    # drift check requires MEASURED stats — a CPU run (no device_memory)
    # must never flag the estimator against a measurement that isn't there
    from ..utils.memory import hbm_usage_frac, measured_peak_bytes

    used = [hbm_usage_frac(r.device_memory) for r in records
            if r.device_memory]
    used = [u for u in used if u is not None]
    if used:
        c["max_hbm_used_frac"] = max(used)
    ests = [r.est_peak_bytes for r in records if r.est_peak_bytes > 0]
    if ests:
        c["max_est_peak_bytes"] = max(ests)
        heads = [r.hbm_headroom_frac for r in records
                 if r.est_peak_bytes > 0 and r.hbm_headroom_frac != 0.0]
        if heads:
            c["min_hbm_headroom_frac"] = min(heads)
        ratios = []
        for r in records:
            if r.est_peak_bytes <= 0 or not r.device_memory:
                continue
            measured = measured_peak_bytes(r.device_memory)
            if measured:
                ratios.append(r.est_peak_bytes / measured)
        if ratios:
            ratio = sum(ratios) / len(ratios)
            c["hbm_estimator_ratio"] = ratio
            # one-sided by design: the backend's peak_bytes_in_use is a
            # process-lifetime high-water mark (>= any true program
            # peak), so est >> measured is a sound over-estimation
            # signal while est << measured merely means an earlier phase
            # allocated more — never flag the low side
            if ratio > 4.0:
                rep.anomalies.append(Anomaly(
                    "hbm_estimator_drift", 0,
                    f"static HBM plan estimates {ratio:.2f}x the measured "
                    f"peak residency over {len(ratios)} step(s) (> 4x) — "
                    f"the planner's admission gates over-reject for this "
                    f"workload (analysis/memory.py)"))
    # neighbor rebuilds: legacy records (pre-device-rebuild writers) carry
    # rebuild_count == 0 even on rebuild steps — fall back to the bool
    reb_total = sum(max(r.rebuild_count, int(r.rebuild)) for r in records)
    if reb_total:
        c["rebuilds_total"] = reb_total
        c["rebuilds_on_device"] = sum(r.rebuild_on_device for r in records)
        # rebuild_overflow_count is CUMULATIVE per producer; distinct
        # producers emit distinct kinds (calculate / md_chunk /
        # batched_calculate / serve_*), so sum the per-kind maxima — a
        # plain max() across a shared sink would drop every producer but
        # the largest
        by_kind_max: dict[str, int] = {}
        for r in records:
            by_kind_max[r.kind] = max(by_kind_max.get(r.kind, 0),
                                      r.rebuild_overflow_count)
        c["rebuild_overflows"] = sum(by_kind_max.values())

    # --- batched engine: per-bucket table (shape-bucketed compile cache) ---
    by_bucket: dict[str, list[StepRecord]] = {}
    for r in records:
        if r.bucket_key:
            by_bucket.setdefault(r.bucket_key, []).append(r)
    if by_bucket:
        buckets = {}
        for key, rs in by_bucket.items():
            n = len(rs)
            buckets[key] = {
                "steps": n,
                "mean_batch_size": sum(r.batch_size for r in rs) / n,
                "mean_node_occupancy": sum(r.node_occupancy for r in rs) / n,
                "mean_edge_occupancy": sum(r.edge_occupancy for r in rs) / n,
                "mean_padding_waste_frac": sum(
                    r.padding_waste_frac for r in rs) / n,
                "mean_structures_per_sec": sum(
                    r.structures_per_sec for r in rs) / n,
            }
        c["buckets"] = buckets
        sps = [r.structures_per_sec for r in records
               if r.structures_per_sec > 0]
        if sps:
            c["mean_structures_per_sec"] = sum(sps) / len(sps)

    # --- serving engine: per-request queue-wait / latency percentiles ---
    serve = [r for r in records if r.kind in ("serve_batch",
                                              "serve_fallback")]
    if serve:
        waits = sorted(w for r in serve for w in r.queue_wait_s)
        lats = sorted(x for r in serve for x in r.request_latency_s)
        batches = [r for r in serve if r.kind == "serve_batch"]
        occs = [r.batch_occupancy for r in batches if r.batch_occupancy > 0]
        c["serving"] = {
            "requests": len(lats),
            "batches": len(batches),
            "fallback_batches": len(serve) - len(batches),
            "mean_batch_size": (sum(r.batch_size for r in batches)
                                / len(batches)) if batches else 0.0,
            "mean_batch_occupancy": (sum(occs) / len(occs)) if occs else 0.0,
            "max_queue_depth": max(r.queue_depth for r in serve),
            "queue_wait_p50_s": percentile(waits, 0.50),
            "queue_wait_p95_s": percentile(waits, 0.95),
            "queue_wait_p99_s": percentile(waits, 0.99),
            "latency_p50_s": percentile(lats, 0.50),
            "latency_p95_s": percentile(lats, 0.95),
            "latency_p99_s": percentile(lats, 0.99),
            # cumulative counters: the LAST record carries the run totals
            "rejects": max(r.reject_count for r in serve),
            "deadline_misses": max(r.deadline_miss_count for r in serve),
            "sheds": max(r.shed_count for r in serve),
        }

    # --- serving fleet: per-tenant tails, per-replica load, cache ---
    fleet = [r for r in records if r.kind == "fleet_request"]
    if fleet:
        def _get(r, name, default=0):
            return r.extra.get(name, default) if r.extra else default

        by_tenant: dict[str, list[float]] = {}
        by_replica: dict[str, int] = {}
        for r in fleet:
            name = r.tenant or "(unattributed)"
            by_tenant.setdefault(name, []).extend(r.request_latency_s)
            if r.replica_id:
                by_replica[r.replica_id] = (by_replica.get(r.replica_id, 0)
                                            + max(r.batch_size, 1))
        dispatched = sum(by_replica.values())
        tenants = {}
        for name, lats in sorted(by_tenant.items()):
            lats = sorted(lats)
            tenants[name] = {
                "requests": len(lats),
                "latency_p50_s": percentile(lats, 0.50),
                "latency_p95_s": percentile(lats, 0.95),
                "latency_p99_s": percentile(lats, 0.99),
            }
        hits = sum(bool(r.cache_hit) for r in fleet)
        # AOT-rehydrated dispatches: count ONE kind, preferring the one
        # closest to the actual dispatch — a rehydrated batch serving 8
        # requests emits the flag on its batched_calculate record AND its
        # serve_batch record; summing across kinds would multi-count it
        aot = 0
        for kinds in (("batched_calculate",),
                      ("serve_batch", "serve_fallback"),
                      ("fleet_request",)):
            sel = [r for r in records if r.kind in kinds]
            if sel:
                aot = sum(bool(r.aot_rehydrated) for r in sel)
                break
        c["fleet"] = {
            "requests": sum(max(r.batch_size, 1) for r in fleet),
            "tenants": tenants,
            "replica_share": {rid: n / max(dispatched, 1)
                              for rid, n in sorted(by_replica.items())},
            "cache_hit_rate": hits / len(fleet),
            "cache_evictions": max(_get(r, "cache_evictions")
                                   for r in fleet),
            "coalesced": max(_get(r, "coalesced_count") for r in fleet),
            "failovers": max(_get(r, "failover_count") for r in fleet),
            "redispatches": max(_get(r, "redispatch_count")
                                for r in fleet),
            "aot_rehydrated_steps": aot,
        }
        # replica load skew: with >= 2 replicas actually serving, one
        # replica carrying more than imbalance_factor x the OTHERS' mean
        # load means least-loaded routing is defeated (a replica is
        # slow-serving, or the others are flapping). Measured against
        # the others — max/overall-mean saturates at N on N replicas and
        # could never flag a 2-replica fleet.
        # (suppressed on runs with failovers: a killed replica's traffic
        # legitimately piles onto the survivors)
        if len(by_replica) >= 2 and dispatched >= 8 \
                and c["fleet"]["failovers"] == 0:
            worst_rid = max(by_replica, key=by_replica.get)
            others = dispatched - by_replica[worst_rid]
            mean_others = others / (len(by_replica) - 1)
            skew = (by_replica[worst_rid] / mean_others
                    if mean_others > 0 else float("inf"))
            if skew > imbalance_factor:
                rep.anomalies.append(Anomaly(
                    "replica_load_skew", 0,
                    f"replica {worst_rid} served {skew:.2f}x the mean "
                    f"load share (> {imbalance_factor:.1f}) over "
                    f"{dispatched} dispatched request(s) — check replica "
                    f"health / outstanding caps"))
        # cache thrash: the byte bound is evicting entries faster than
        # the stream re-uses them — the cache burns memory and copies
        # without serving hits; grow max_bytes or stop caching this
        # workload
        evictions = c["fleet"]["cache_evictions"]
        if (len(fleet) >= 20 and evictions > len(fleet)
                and c["fleet"]["cache_hit_rate"] < 0.05):
            rep.anomalies.append(Anomaly(
                "cache_thrash", 0,
                f"{evictions} eviction(s) against "
                f"{c['fleet']['cache_hit_rate']:.1%} hit rate over "
                f"{len(fleet)} request(s) — the result cache's byte bound "
                f"is far below the working set"))

    # --- active learning: escalation variance, buffer depth, swaps ---
    act = [r for r in records if r.kind.startswith("active_")]
    if act:
        esc = [r for r in act if r.kind == "active_escalate"]
        fts = [r for r in act if r.kind == "active_finetune"]
        swaps = [r for r in act if r.kind == "active_swap"]
        variances = sorted(float(v) for r in esc
                           for v in (r.extra or {}).get("variances", []))
        submitted = max((int((r.extra or {}).get("submitted_total", 0))
                         for r in esc), default=0)
        escalated = max((int((r.extra or {}).get("escalated_total", 0))
                         for r in esc), default=0)
        depth = max((int((r.extra or {}).get("buffer_depth", 0))
                     for r in act), default=0)
        a = {
            "evaluations": len(variances),
            "submitted": submitted,
            "escalated": escalated,
            "escalation_rate": (escalated / submitted if submitted
                                else 0.0),
            "buffer_depth": depth,
            "buffer_added": sum(int((r.extra or {}).get("buffer_added", 0))
                                for r in esc),
            "finetunes": len(fts),
            "shipped": sum(bool((r.extra or {}).get("shipped"))
                           for r in fts),
            "swaps": len(swaps),
            "member_count": max((r.member_count for r in act), default=0),
        }
        if variances:
            a["variance_p50"] = percentile(variances, 0.50)
            a["variance_p90"] = percentile(variances, 0.90)
            a["variance_max"] = variances[-1]
        c["active"] = a

    # --- training loop: loss trajectory + optimizer dynamics ---
    train = [r for r in records if r.kind == "train_step"]
    if train:
        tf = TrainRecord.training_field
        losses = [float(tf(r, "loss")) for r in train]
        norms = sorted(float(tf(r, "grad_norm")) for r in train)
        vals = [float(tf(r, "val_loss", float("nan"))) for r in train]
        vals = [v for v in vals if v == v]  # drop NaN (no eval that step)
        eps = [float(tf(r, "examples_per_sec")) for r in train]
        skipped = sum(bool(tf(r, "skipped", False)) for r in train)
        t = {
            "steps": len(train),
            "epochs": int(max(tf(r, "epoch", 0) for r in train)) + 1,
            "accum_steps": int(max(tf(r, "accum_steps", 0) for r in train)),
            "micro_batch_size": int(max(
                tf(r, "micro_batch_size", 0) for r in train)),
            "mean_examples_per_sec": sum(eps) / len(eps),
            "first_loss": losses[0],
            "last_loss": losses[-1],
            "min_loss": min(losses),
            "grad_norm_p50": percentile(norms, 0.50),
            "grad_norm_p95": percentile(norms, 0.95),
            "last_loss_scale": float(tf(train[-1], "loss_scale")),
            "skipped_steps": skipped,
        }
        if vals:
            t["best_val_loss"] = min(vals)
        # data-distribution section: only when some producer measured
        # waste (older writers carry 0.0 everywhere — no packing lines)
        wastes = [float(tf(r, "padding_waste_frac", 0.0)) for r in train]
        if any(w > 0 for w in wastes):
            balances = [float(tf(r, "edge_balance", 1.0)) for r in train]
            tiers = [int(tf(r, "tier", 0)) for r in train]
            per_tier: dict[int, int] = {}
            for x in tiers:
                per_tier[x] = per_tier.get(x, 0) + 1
            by_epoch: dict[int, list] = {}
            for r, w in zip(train, wastes):
                by_epoch.setdefault(int(tf(r, "epoch", 0)), []).append(w)
            t.update(
                mean_padding_waste_frac=sum(wastes) / len(wastes),
                max_padding_waste_frac=max(wastes),
                min_edge_balance=min(balances),
                n_tiers=len(per_tier),
                steps_per_tier=per_tier,
                waste_by_epoch={e: sum(ws) / len(ws)
                                for e, ws in by_epoch.items()})
        c["training"] = t
        # skipped-step dominance: the dynamic loss scale exists to absorb
        # the OCCASIONAL overflow — a run skipping a large fraction of its
        # updates is diverging (or the scale is thrashing), not training
        if len(train) >= 4 and skipped > 0.25 * len(train):
            rep.anomalies.append(Anomaly(
                "train_skipped_steps", 0,
                f"{skipped}/{len(train)} optimizer steps skipped on "
                f"nonfinite grads — loss scale thrashing or divergence "
                f"(last scale {t['last_loss_scale']:.3g}); lower the LR "
                f"or the initial loss scale"))
        # padding-waste dominance: over half of every padded compute
        # array is masked lanes — the run spends most of its FLOPs on
        # padding, which is the arXiv 2504.10700 data-distribution
        # failure mode the cost-model packer exists to remove
        mean_w = t.get("mean_padding_waste_frac", 0.0)
        if len(train) >= 4 and mean_w > 0.5:
            rep.anomalies.append(Anomaly(
                "padding_waste_dominant", 0,
                f"mean train padding_waste_frac {mean_w:.2f} over "
                f"{len(train)} step(s) (> 0.50) across "
                f"{t.get('n_tiers', 1)} capacity tier(s) — the frozen "
                f"caps dwarf the live graphs; switch the loader to "
                f"packing='cost_model' / add a capacity tier "
                f"(train/packing.py), or audit the dataset with "
                f"tools/pack_audit.py"))

    # --- anomalies ---
    # stall detection is PER KIND: a DeviceMD chunk legitimately takes
    # hundreds of calculate-steps' worth of wall time, so a mixed
    # calculate/md_chunk run must not flag every chunk against the
    # calculate median
    by_kind: dict[str, list[StepRecord]] = {}
    for r in records:
        by_kind.setdefault(r.kind, []).append(r)
    for kind, rs in by_kind.items():
        totals = sorted(r.total_s for r in rs if r.total_s > 0)
        med = percentile(totals, 0.50)
        if med <= 0:
            continue
        for r in rs:
            if r.total_s > stall_factor * med:
                rep.anomalies.append(Anomaly(
                    "stall", r.step,
                    f"{kind} step took {r.total_s:.3f}s vs kind-median "
                    f"{med:.3f}s (>{stall_factor:.0f}x) — wedge-style "
                    f"stall or mid-run recompile"))
    for r in records:
        occs = [("node", r.node_occupancy), ("edge", r.edge_occupancy)]
        low = [f"{what} {o:.2f}" for what, o in occs if 0 < o < occupancy_floor]
        if low:
            rep.anomalies.append(Anomaly(
                "occupancy_collapse", r.step,
                f"padding occupancy {', '.join(low)} below "
                f"{occupancy_floor:.2f} — sticky capacities far above the "
                f"live graph (mostly-padded compute)"))
    # per-bucket occupancy collapse: a bucket whose mean occupancy sits
    # below the floor means the geometric ladder is quantizing this
    # request-size population too coarsely (or the batcher under-fills) —
    # most of each executable's padded lanes are waste
    for key, b in (c.get("buckets") or {}).items():
        occ = min(b["mean_node_occupancy"], b["mean_edge_occupancy"])
        if 0 < occ < occupancy_floor:
            rep.anomalies.append(Anomaly(
                "bucket_occupancy_collapse", 0,
                f"bucket {key}: mean occupancy {occ:.2f} over {b['steps']} "
                f"step(s) below {occupancy_floor:.2f} — tune BucketPolicy "
                f"growth/base or batch more structures per request"))
    # kernel-fallback-dominant: an accelerator run (device memory stats
    # reported — CPU backends report none) whose traced programs mostly
    # took the plain PyTorch path: the card is paying the materialized
    # (E, width) memory round-trips the kernels exist to remove
    # (per-object kernels=False left on)
    if kmodes:
        on_accel = any(r.device_memory for r in records if r.kernel_mode)
        if on_accel and c["mean_kernel_coverage"] < 0.5:
            rep.anomalies.append(Anomaly(
                "kernel_fallback_dominant", 0,
                f"mean fused-kernel coverage "
                f"{c['mean_kernel_coverage']:.2f} (< 0.5) on an "
                f"accelerator run (modes: {','.join(kmodes)}) — edge "
                f"aggregations are falling back to the plain path; "
                f"check the per-potential kernels= flags"))
    # host-rebuild-dominant: the run proved device-rebuild capability (at
    # least one on-device rebuild) yet paid the majority of its rebuilds on
    # the host — overflows or churn are defeating the device-resident path
    n_dev = c.get("rebuilds_on_device", 0)
    n_total = c.get("rebuilds_total", 0)
    if n_dev > 0 and n_total >= 4 and (n_total - n_dev) > n_dev:
        rep.anomalies.append(Anomaly(
            "host_rebuild_dominant", 0,
            f"{n_total - n_dev}/{n_total} rebuilds ran on the HOST in a "
            f"device-rebuild-capable run ({c.get('rebuild_overflows', 0)} "
            f"overflow fallback(s)) — grow capacities or check structure "
            f"churn; the hot loop is stalling on host FPIS rebuilds"))
    for r in records:
        if not r.halo_send_per_part:
            continue
        if r.spatial_parts > 1 and r.batch_parts > 1:
            # 2-D placement: measure imbalance per mesh axis — each batch
            # row is an independent spatial ring, so a flat max/mean
            # across all partitions would conflate legitimately different
            # batch shards with a genuinely skewed ring
            imb_r = r.spatial_halo_imbalance()
            if imb_r > imbalance_factor:
                rep.anomalies.append(Anomaly(
                    "spatial_halo_imbalance", r.step,
                    f"per-batch-row spatial halo send max/mean = "
                    f"{imb_r:.2f} (> {imbalance_factor:.1f}) on a "
                    f"{r.batch_parts}x{r.spatial_parts} placement — "
                    f"volumes {r.halo_send_per_part}"))
        elif r.halo_imbalance() > imbalance_factor:
            rep.anomalies.append(Anomaly(
                "halo_imbalance", r.step,
                f"per-partition halo send max/mean = "
                f"{r.halo_imbalance():.2f} (> {imbalance_factor:.1f}) — "
                f"volumes {r.halo_send_per_part}"))
    return rep


def main(argv=None) -> int:
    """CLI: ``python -m distmlip_tpu_torch.telemetry.report run.jsonl
    [--json out] [--trace-dir DIR] [--stall-factor F] [--occupancy-floor F]
    [--imbalance-factor F]``. Exit codes: 0 clean, 4 anomalies flagged, 2
    usage, 1 unreadable input."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"stall_factor": 5.0, "occupancy_floor": 0.35,
            "imbalance_factor": 2.0}
    out_json = None
    trace_dir = None
    usage = ("usage: telemetry_report <run.jsonl> [--json out.json] "
             "[--trace-dir DIR] [--stall-factor F] "
             "[--occupancy-floor F] [--imbalance-factor F]")
    try:
        for flag in ("--stall-factor", "--occupancy-floor",
                     "--imbalance-factor"):
            while flag in argv:
                i = argv.index(flag)
                opts[flag[2:].replace("-", "_")] = float(argv[i + 1])
                del argv[i:i + 2]
        if "--json" in argv:
            i = argv.index("--json")
            out_json = argv[i + 1]
            del argv[i:i + 2]
        if "--trace-dir" in argv:
            i = argv.index("--trace-dir")
            trace_dir = argv[i + 1]
            del argv[i:i + 2]
    except (IndexError, ValueError):
        print(usage, file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(usage, file=sys.stderr)
        return 2
    try:
        records = read_jsonl(argv[0])
    except OSError as e:
        print(f"error: cannot read {argv[0]}: {e}", file=sys.stderr)
        return 1
    rep = aggregate(records, **opts)
    if trace_dir is not None:
        # per-request critical-path percentiles from exported trace
        # JSON (distmlip_tpu_torch.obs), rendered next to the per-phase table
        from ..obs.export import critical_path_summary, load_trace_dir

        try:
            spans = load_trace_dir(trace_dir)
        except OSError as e:
            print(f"error: cannot read {trace_dir}: {e}", file=sys.stderr)
            return 1
        summary = critical_path_summary(spans)
        rep.counters["trace"] = summary
        if summary.get("queue_dominant"):
            comps = summary["components"]
            rep.anomalies.append(Anomaly(
                "queue_dominant", 0,
                f"median per-request queue wait "
                f"{1e3 * comps['queue']['p50']:.1f}ms exceeds median "
                f"device time "
                f"{1e3 * (comps['device']['p50'] + comps['compile']['p50']):.1f}ms "
                f"over {summary['requests']} request(s) — serving is "
                f"capacity-bound: add replicas / batch slots, faster "
                f"kernels will not move the p99"))
    print(rep.render())
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rep.to_dict(), f, indent=2, sort_keys=True)
    return 0 if not rep.anomalies else 4


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
