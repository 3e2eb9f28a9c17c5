"""The fleet's load test and acceptance gate (``tools/load_test.py``'s
fleet mode, ``run_fleet``).

    python -m distmlip_tpu_torch.tools.load_test --fleet N
        [--chaos none|kill-replica] [--active] [--check]
        [--device cuda|cpu] [--model pair|mace] [--requests R] ...

An open-loop burst through a ``FleetRouter`` over N in-process
``ServeEngine`` replicas that share the host's card (two tenants weighted
4:1, a content-addressed result cache, failover), and ONE JSON line of
results. Phases: (1) ``requests // 2`` UNIQUE structures as a burst; with
``--chaos kill-replica`` replica r0 is killed after half of them are in;
(2) every Future is harvested; (3) the same structures again as duplicates,
which must come back from the result cache without touching a replica.

``--active`` attaches an ``ActiveLoop``: traffic routes through it, a
quarter of the requests escalate to a two-member ensemble evaluator, and
after the cache phase a SECOND burst runs with a mid-burst hot swap of
perturbed weights into every live replica.

``--check`` turns the run into a gate (exit 3 on a failed check, 2 on a
usage error, 0 otherwise), with the JAX tool's ``checks``: every Future
resolved with zero failures, p99 under ``--p99-bound-s``, the compile
count (shape buckets dispatched) within the ``BucketPolicy`` ladder bound
times the replicas, the duplicate phase's hit rate at least
``--cache-hit-floor`` with zero new dispatches, a failover observed under
chaos, and with ``--active`` zero lost requests and no new bucket across
the swap, the cache's ``model_id`` rolled and escalations evaluated. With
the obs hub on (``--obs auto`` turns it on with ``--check``) the span
trees and the compile metrics are checked too.

``--device cuda`` (the default) runs the replicas with the CUDA kernels on
the card and raises without one; ``--device cpu`` runs the plain PyTorch
path. ``--model pair`` is the pair potential, ``--model mace`` MACE at the
MACE-MP-0-medium widths (``tools/workload.py`` ``MACE_KW``, random weights
from seed 0). The JAX tool's ``--aot`` (a shared AOT executable cache) is
not accepted: the port has none (ROADMAP.md A10b).

Smoke: ``python -m distmlip_tpu_torch.tools.load_test --fleet 2 --chaos
kill-replica --active --check --device cpu --model pair --requests 24``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def make_pool(rng, n_structures: int, species: int = 14):
    """Mixed-size perturbed fcc supercells (4 to 32 atoms), the JAX tool's
    pool draw for draw."""
    from .. import geometry
    from ..calculators import Atoms

    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    reps_pool = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (3, 1, 1)]
    pool = []
    for _ in range(n_structures):
        reps = reps_pool[int(rng.integers(len(reps_pool)))]
        a = float(rng.uniform(3.4, 3.8))
        frac, lattice = geometry.make_supercell(unit, np.eye(3) * a, reps)
        cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.05, (len(frac), 3))
        pool.append(Atoms(numbers=np.full(len(cart), species), positions=cart, cell=lattice))
    return pool


def build_model(name: str):
    """``(model, params)``: the pair potential, or MACE at ``MACE_KW``."""
    if name == "pair":
        from ..models import PairConfig, PairPotential

        model = PairPotential(PairConfig(cutoff=4.0))
        return model, model.init()
    if name == "mace":
        from ..models import MACE, MACEConfig
        from .workload import MACE_KW

        model = MACE(MACEConfig(**MACE_KW))
        return model, model.init(0)
    raise SystemExit(f"unknown --model {name!r} (pair | mace)")


def perturbed(params, scale: float, seed: int):
    """``params`` with N(0, scale) noise from ``seed`` on every floating
    leaf (a fresh tree; the input is untouched)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [leaf(v) for v in x]
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            noise = torch.randn(x.shape, generator=gen, dtype=torch.float32)
            return x + (scale * noise).to(x.device, x.dtype)
        return x

    return leaf(params)


def setup_obs(args):
    """The obs hub (and a metrics endpoint on localhost) when the run asks
    for it: ``--obs auto`` turns it on with ``--check`` / ``--trace-out`` /
    ``--metrics-port``; ``--obs off`` is the uninstrumented baseline."""
    want = (args.obs == "on"
            or (args.obs == "auto"
                and (args.check or args.trace_out or args.metrics_port is not None)))
    if not want:
        return None, None
    from ..obs import MetricsServer, Observability

    hub = Observability.enable()
    server = (MetricsServer(hub.metrics, port=args.metrics_port)
              if args.metrics_port is not None else None)
    return hub, server


def scrape_metrics(server, expected: dict) -> tuple[bool, dict]:
    """One GET /metrics on localhost; the scraped sample lines against the
    load test's own totals."""
    import urllib.request

    from ..obs import parse_exposition

    body = urllib.request.urlopen(server.url, timeout=10).read().decode()
    vals = parse_exposition(body)
    scraped = {k: vals.get(k, 0.0) for k in expected}
    return all(scraped[k] == v for k, v in expected.items()), scraped


def trace_summary_block(hub, n_submitted: int, trace_out=None) -> dict:
    """Span-tree conservation and critical-path coverage over the run."""
    from ..obs.export import critical_path_summary, request_trace_summary

    spans = hub.tracer.spans()
    tsum = request_trace_summary(spans)
    csum = critical_path_summary(spans)
    out = {
        "submitted": n_submitted,
        "request_traces": tsum["requests"],
        "complete": tsum["complete"],
        "terminals": tsum["terminals"],
        "terminal_violations": tsum["terminal_violation_count"],
        "spans_dropped": hub.tracer.spans_dropped,
        "coverage_p50": round(csum.get("coverage_p50", 0.0), 3),
        "queue_dominant": bool(csum.get("queue_dominant", False)),
    }
    if trace_out:
        hub.tracer.write(trace_out)
        out["path"] = trace_out
    return out


def trace_checks(trace: dict) -> dict:
    """Every submission left a closed span tree with exactly one
    ``future.resolve`` terminal, and the spans explain >= 90% of the
    median request's latency."""
    return {
        "trace_complete": (
            trace["request_traces"] == trace["submitted"]
            and trace["complete"] == trace["submitted"]
            and trace["terminal_violations"] == 0
            and trace["spans_dropped"] == 0),
        "trace_critical_path": trace["coverage_p50"] >= 0.9,
    }


def _metric_kind_totals(hub) -> dict:
    from ..obs import parse_exposition

    totals: dict = {}
    for line, v in parse_exposition(hub.metrics.render()).items():
        if not line.startswith("distmlip_compiles_total{"):
            continue
        for part in line[line.index("{") + 1:line.index("}")].split(","):
            k, _, val = part.partition("=")
            if k.strip() == "kind":
                kind = val.strip().strip('"')
                totals[kind] = totals.get(kind, 0) + int(v)
    return totals


def run_fleet(args) -> int:
    """Fleet mode (module docstring). Returns the exit code."""
    from ..calculators import BatchedPotential
    from ..device import resolve_device
    from ..fleet import FleetRouter, ResultCache, TenantConfig
    from ..obs import profiling as _profiling
    from ..partition import BucketPolicy
    from ..serve import ServeEngine
    from ..telemetry import JsonlSink, Telemetry

    device = resolve_device(args.device)  # --device cuda without a card raises here
    rng = np.random.default_rng(args.seed)
    model, params = build_model(args.model)
    hub, metrics_server = setup_obs(args)
    telemetry = None
    if args.jsonl:
        telemetry = Telemetry([JsonlSink(args.jsonl, max_bytes=args.jsonl_max_bytes)])
    policies = [BucketPolicy() for _ in range(args.fleet)]
    _profiling.reset_compile_log()
    potentials = [BatchedPotential(model, params, caps=policies[i], skin=args.skin,
                                   device=device)
                  for i in range(args.fleet)]
    engines = [ServeEngine(potentials[i], max_batch=args.max_batch, max_wait_s=args.max_wait,
                           max_queue=args.max_queue, admission="reject", telemetry=telemetry)
               for i in range(args.fleet)]
    router = FleetRouter(
        engines, result_cache=ResultCache(max_bytes=args.cache_bytes), model_id=args.model,
        tenants={"interactive": TenantConfig(weight=4.0),
                 "screening": TenantConfig(weight=1.0)},
        telemetry=telemetry)

    loop = None
    if args.active:
        from ..active import (ActiveLoop, EnsembleBatchedPotential, EscalationPolicy,
                              FineTuneTrigger, ReplayBuffer, TriggerPolicy)

        ensemble = EnsembleBatchedPotential(model, [params, perturbed(params, 0.05, 1)],
                                            skin=args.skin, device=device)
        loop = ActiveLoop(
            router, ensemble, ReplayBuffer(capacity=256),
            policy=EscalationPolicy(sample_rate=0.25),
            # the run swaps explicitly mid-burst; keep the trigger out
            trigger=FineTuneTrigger(TriggerPolicy(min_buffer=1 << 30)),
            telemetry=telemetry, seed=args.seed)

    tenant_totals: dict = {}
    n_submitted = 0

    def count_submit(tenant="default"):
        nonlocal n_submitted
        n_submitted += 1
        tenant_totals[tenant] = tenant_totals.get(tenant, 0) + 1

    def fleet_submit(atoms, **kw):
        count_submit(kw.get("tenant", "default"))
        return loop.submit(atoms, **kw) if loop is not None else router.submit(atoms, **kw)

    base_pool = make_pool(rng, max(8, args.requests // 8))
    n_uniq = max(args.requests // 2, 2)
    n_dup = max(args.requests - n_uniq, 1)
    uniques = []
    for i in range(n_uniq):
        a = base_pool[i % len(base_pool)].copy()
        a.positions = a.positions + rng.normal(0, 0.02, a.positions.shape)
        uniques.append(a)

    futs, t_sub = [], []
    killed = reclaimed = 0
    t0 = time.perf_counter()
    for i, a in enumerate(uniques):
        if args.chaos == "kill-replica" and i == n_uniq // 2 and not killed:
            reclaimed = router.kill_replica("r0")
            killed = 1
        tenant = "interactive" if i % 4 == 0 else "screening"
        t_sub.append(time.perf_counter())
        futs.append(fleet_submit(a, tenant=tenant))
    ok = failed = 0
    lats = []
    for f, ts in zip(futs, t_sub):
        try:
            f.result(timeout=300)
        except Exception:  # noqa: BLE001 - explicit per-request error
            failed += 1
            continue
        ok += 1
        lats.append(time.perf_counter() - ts)
    router.drain(timeout=120)
    dispatched_before_dup = sum(r["dispatched_total"]
                                for r in router.snapshot()["replicas"].values())
    hits_before_dup = router.cache.hits

    dup_futs = []
    dup_ok = 0
    for i in range(n_dup):
        count_submit()
        dup_futs.append(router.submit(uniques[i % n_uniq]))
    for f in dup_futs:
        try:
            f.result(timeout=300)
            dup_ok += 1
        except Exception:  # noqa: BLE001
            failed += 1
    dispatched_after_dup = sum(r["dispatched_total"]
                               for r in router.snapshot()["replicas"].values())
    hit_rate = (router.cache.hits - hits_before_dup) / max(n_dup, 1)
    # wall_s covers the burst and cache phases; the active phase is timed on
    # its own so --active runs stay comparable with plain fleet runs
    wall_s = time.perf_counter() - t0

    swap_futs = []
    swap_ok = 0
    swap_report = None
    swap_compile_delta = {}
    swap_phase_s = 0.0
    if loop is not None:
        t_active = time.perf_counter()
        loop.pump()  # evaluate the burst's escalations
        # the swap burst: jittered copies of one base cell, whose buckets
        # (one per batch size 1..max_batch) are warmed on every alive
        # replica first, so the delta below counts only what the swap adds
        swap_pool = []
        for _ in range(n_uniq):
            a = base_pool[0].copy()
            a.positions = a.positions + rng.normal(0, 0.01, a.positions.shape)
            swap_pool.append(a)
        for rep in router.replicas.values():
            if not rep.alive:
                continue
            for b in range(1, args.max_batch + 1):
                warm = []
                for a in swap_pool[:b]:
                    n_submitted += 1
                    warm.append(rep.engine.submit(a))
                rep.engine.drain(timeout=120)
                for f in warm:
                    f.result(timeout=300)
        compile_at_swap = {rid: r["compile_count"]
                           for rid, r in router.snapshot()["replicas"].items()}
        new_params = perturbed(params, 1e-3, 2)
        for i, a in enumerate(swap_pool):
            if i == max(n_uniq // 4, 1) and swap_report is None:
                swap_report = loop.swap_now(new_params)  # mid-burst
            count_submit()
            swap_futs.append(loop.submit(a))
        if swap_report is None:
            swap_report = loop.swap_now(new_params)
        for f in swap_futs:
            try:
                f.result(timeout=300)
                swap_ok += 1
            except Exception:  # noqa: BLE001
                failed += 1
        router.drain(timeout=120)
        loop.pump()
        swap_compile_delta = {rid: r["compile_count"] - compile_at_swap.get(rid, 0)
                              for rid, r in router.snapshot()["replicas"].items()}
        swap_phase_s = time.perf_counter() - t_active

    snap = router.snapshot()
    compile_total = sum(r["compile_count"] for r in snap["replicas"].values())
    lats.sort()
    p99 = lats[min(len(lats) - 1, int(0.99 * (len(lats) - 1) + 0.5))] if lats else 0.0
    router.close()
    if telemetry is not None:
        telemetry.close()
    scraped_ok = scraped = None
    if metrics_server is not None:
        expected = {f'distmlip_fleet_requests_total{{tenant="{t}"}}': float(n)
                    for t, n in sorted(tenant_totals.items())}
        scraped_ok, scraped = scrape_metrics(metrics_server, expected)
        metrics_server.close()
    kind_counts = _profiling.compile_counts()
    metric_kind_totals = _metric_kind_totals(hub) if hub is not None else {}

    n_atoms = [len(a) for a in uniques]
    bound = args.fleet * policies[0].ladder_bound(
        min(n_atoms), sum(sorted(n_atoms)[-args.max_batch:]), args.max_batch)
    summary = {
        "metric": "fleet_load_test",
        "fleet": args.fleet,
        "chaos": args.chaos,
        "device": device.type,
        "model": args.model,
        "requests": n_uniq + n_dup,
        "unique": n_uniq,
        "duplicates": n_dup,
        "ok": ok + dup_ok,
        "failed": failed,
        "reclaimed_on_kill": reclaimed,
        "wall_s": round(wall_s, 3),
        "latency_p99_ms": round(1e3 * p99, 2),
        "compile_count": compile_total,
        "compile_bound": bound,
        "cache_hit_rate": round(hit_rate, 3),
        "dup_dispatches": dispatched_after_dup - dispatched_before_dup,
        "stats": snap["stats"],
        "tenants": snap["tenants"],
        "replicas": snap["replicas"],
        "cache": snap["cache"],
        "compile_events": {"kinds": kind_counts, "metrics_kinds": metric_kind_totals},
    }
    if loop is not None:
        summary["active"] = {
            **loop.snapshot(),
            "swap_burst_requests": len(swap_futs),
            "swap_burst_ok": swap_ok,
            "swap_compile_delta": swap_compile_delta,
            "swap_phase_s": round(swap_phase_s, 3),
            "model_id": router.model_id,
        }
    if args.jsonl:
        summary["jsonl"] = args.jsonl
    if hub is not None:
        summary["trace"] = trace_summary_block(hub, n_submitted, trace_out=args.trace_out)
    if scraped is not None:
        summary["metrics_scrape"] = scraped
    rc = 0
    if args.check:
        checks = {
            "all_resolved": all(f.done() for f in futs + dup_futs),
            "zero_lost": ok + dup_ok == n_uniq + n_dup and failed == 0,
            "p99_bounded": p99 <= args.p99_bound_s,
            "compile_bound": compile_total <= bound,
            "cache_hit_floor": hit_rate >= args.cache_hit_floor,
            "no_dispatch_on_hits": dispatched_after_dup == dispatched_before_dup,
        }
        if args.chaos == "kill-replica":
            checks["failover_observed"] = snap["stats"]["failovers"] >= 1
        if hub is not None:
            checks["compile_metrics_consistent"] = metric_kind_totals == dict(kind_counts)
        if loop is not None:
            checks["active_all_resolved"] = all(f.done() for f in swap_futs)
            checks["active_zero_lost"] = swap_ok == len(swap_futs)
            checks["active_no_swap_recompiles"] = all(
                d == 0 for d in swap_compile_delta.values())
            checks["active_model_id_rolled"] = router.model_id != args.model
            checks["active_escalations_evaluated"] = loop.stats.evaluated > 0
        if hub is not None:
            checks.update(trace_checks(summary["trace"]))
        if scraped_ok is not None:
            checks["metrics_scrape"] = scraped_ok
        summary["checks"] = checks
        if not all(checks.values()):
            summary["check"] = "FAIL"
            rc = 3
        else:
            summary["check"] = "ok"
    print(json.dumps(summary), flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fleet", type=int, default=0,
                   help="N in-process ServeEngine replicas behind a FleetRouter (required)")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait", type=float, default=0.02)
    p.add_argument("--max-queue", type=int, default=4096)
    p.add_argument("--model", default="pair", help="pair | mace")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the kernels on the card; raises without one) or cpu "
                        "(the plain PyTorch path)")
    p.add_argument("--skin", type=float, default=0.0)
    p.add_argument("--jsonl", default=None, help="write telemetry records here")
    p.add_argument("--jsonl-max-bytes", type=int, default=None,
                   help="rotate the telemetry JSONL past this size")
    p.add_argument("--obs", choices=("auto", "on", "off"), default="auto",
                   help="the obs hub: auto = on with --check/--trace-out/--metrics-port")
    p.add_argument("--trace-out", default=None,
                   help="write the run's trace_event JSON here")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the metrics on this localhost port (0 = ephemeral) and "
                        "scrape them once at the end")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check", action="store_true",
                   help="assert the acceptance checks; exit 3 on a failure")
    p.add_argument("--active", action="store_true",
                   help="attach an ActiveLoop and run a second burst with a mid-burst "
                        "hot swap")
    p.add_argument("--chaos", choices=("none", "kill-replica"), default="none",
                   help="kill replica r0 mid-burst")
    p.add_argument("--cache-bytes", type=int, default=64 * 2**20,
                   help="result-cache byte bound")
    p.add_argument("--p99-bound-s", type=float, default=60.0,
                   help="--check: p99 latency bound in seconds, failover included")
    p.add_argument("--cache-hit-floor", type=float, default=0.9,
                   help="--check: the duplicate phase's result-cache hit-rate floor")
    args = p.parse_args(argv)
    if args.fleet < 1:
        print("usage error: the port's load test runs fleet mode only (--fleet N, N >= 1)",
              file=sys.stderr)
        return 2
    try:
        return run_fleet(args)
    finally:
        from ..obs import uninstall

        uninstall()


if __name__ == "__main__":
    raise SystemExit(main())
