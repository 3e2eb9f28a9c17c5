"""The observability plane, JAX vs port: ``distmlip_tpu_torch.obs``.

The tracer, metrics registry, SLO monitor, flight recorder, trace export
and compile log are plain Python in both packages: the same call sequence
under one injected clock must give the same span trees (span ids aside:
they carry the process id), the same Prometheus exposition text, the same
SLO breach decisions, the same flight captures, the same Perfetto round
trip and the same critical-path summary from both. The attribution of one
synthetic trace in the JAX package's shape must give the same
``ScopeBreakdown`` from both ``attribute`` functions, the JAX package's
``pallas_kernel`` bucket being the port's ``custom_kernel``; a synthetic
``torch.profiler``-shaped trace checks the port's own placement (annotation
ranges, launch correlation, the backward's forward scope). Then the port's
serving engine with a hub installed: complete request traces, metrics over
HTTP on localhost, the SLO feed, a flight capture at a deadline miss, and
the compile log. Exact equality everywhere: the two sides run the same
arithmetic on the same floats.
"""

import json
import os

import numpy as np
import pytest

from distmlip_tpu import obs as jobs
from distmlip_tpu.obs import attribution as jattribution
from distmlip_tpu.obs import roofline as jroofline
from distmlip_tpu.telemetry import StepRecord as JStepRecord
from distmlip_tpu_torch import obs
from distmlip_tpu_torch.obs import attribution, profiling, roofline
from distmlip_tpu_torch.telemetry import StepRecord
from tests.torch_threads import one_intra_op_thread  # noqa: F401


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _drive_tracer(pkg, clock):
    """One request through queue, a linked batch trace and its terminal; a
    rejected root; nested live spans; an adopted (outer-owned) trace."""
    tr = pkg.Tracer(clock=clock)
    reqs = [tr.start_request("engine.submit", attrs={"n_atoms": 8 + i}) for i in range(3)]
    clock.advance(0.004)
    t_q = clock()
    for r in reqs:
        tr.emit("engine.queue", parent=r.ctx, t_start=r.t_submit, t_end=t_q)
    batch = tr.begin("serve.batch", new_trace=True, links=[r.ctx for r in reqs],
                     t_start=t_q, attrs={"batch_size": 3})
    tr.emit("scheduler.plan_batch", parent=batch, t_start=t_q, t_end=t_q + 0.0005)
    clock.advance(0.002)
    tr.emit("batched.pack", parent=batch, t_start=t_q + 0.0005, t_end=clock())
    clock.advance(0.010)
    tr.emit("device.dispatch", parent=batch, t_start=t_q + 0.0025, t_end=clock())
    tr.end(batch, attrs={"bucket_key": "n64_e1024_B4"})
    for r in reqs[:2]:
        tr.finish_request(r, status="ok")
    clock.advance(0.001)
    tr.finish_request(reqs[2], status="error")
    rejected = tr.begin("engine.submit", new_trace=True)
    tr.end(rejected, status="rejected")
    with tr.span("outer", attrs={"k": 1}):
        clock.advance(0.003)
        with tr.span("inner"):
            clock.advance(0.002)
        adopted = tr.adopt_request()
        tr.finish_request(adopted)  # no-op: the outer layer owns it
    try:
        with tr.span("failing"):
            clock.advance(0.001)
            raise ValueError("x")
    except ValueError:
        pass
    return tr


def _normalized(spans):
    """Span dicts with ids replaced by (trace root name, span name) paths."""
    spans = [s if isinstance(s, dict) else s.to_dict() for s in spans]
    name_of = {s["span_id"]: s["name"] for s in spans}
    order = {}
    for s in spans:
        order.setdefault(s["trace_id"], len(order))
    out = []
    for s in spans:
        out.append((order[s["trace_id"]], s["name"], name_of.get(s["parent_id"], ""),
                    s["t_start"], s["t_end"], s["status"],
                    json.dumps(s.get("attrs") or {}, sort_keys=True),
                    tuple((order.get(l[0]), name_of.get(l[1])) for l in s["links"])))
    return out


@pytest.fixture(scope="module")
def traced():
    return {name: _drive_tracer(pkg, FakeClock()) for name, pkg in (("jax", jobs), ("port", obs))}


def test_span_trees_match_jax(traced):
    j, p = traced["jax"], traced["port"]
    assert _normalized(p.spans()) == _normalized(j.spans())
    assert (p.spans_finished, p.spans_dropped) == (j.spans_finished, j.spans_dropped)
    assert p.current() is None


def test_perfetto_round_trip_and_critical_paths_match_jax(traced, tmp_path):
    j, p = traced["jax"], traced["port"]
    pj, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jobs.write_trace(pj, j.spans(), t_wall0=0.0)
    obs.write_trace(pp, p.spans(), t_wall0=0.0)
    # each package reads both files back to the same spans
    for path in (pj, pp):
        assert _normalized(obs.load_trace(path)) == _normalized(jobs.load_trace(path))
    assert _normalized(obs.load_trace(pp)) == _normalized(jobs.load_trace(pj))
    loaded = obs.load_trace_dir(str(tmp_path))
    assert len(loaded) == 2 * len(p.spans())
    assert obs.request_trace_summary(p.spans()) == jobs.request_trace_summary(j.spans())
    summary = obs.critical_path_summary(p.spans())
    assert summary == jobs.critical_path_summary(j.spans())
    assert summary["requests"] == 4 and obs.format_critical_path(summary) == \
        jobs.format_critical_path(summary)
    strip = lambda paths: [{k: v for k, v in c.items() if k != "trace_id"}  # noqa: E731
                           for c in paths]
    assert strip(obs.critical_paths(p.spans())) == strip(jobs.critical_paths(j.spans()))
    complete = obs.request_trace_summary(p.spans())
    assert complete["complete"] == 4 and complete["terminal_violation_count"] == 0


def _drive_metrics(pkg):
    reg = pkg.MetricsRegistry(max_label_children=3)
    c = reg.counter("distmlip_serve_completed_total", "done")
    c.inc()
    c.inc(2)
    g = reg.gauge("distmlip_serve_queue_depth", "depth")
    g.set(5)
    g.dec()
    h = reg.histogram("distmlip_serve_request_latency_seconds", "lat")
    for x in (1e-5, 0.003, 0.003, 0.5, 300.0):
        h.observe(x)
    t = reg.counter("distmlip_fleet_requests_total", "per tenant", labels=("tenant",))
    for name in ("a", "b", "c", "d", "e", "a"):
        t.labels(tenant=name).inc()
    b = reg.histogram("distmlip_compile_seconds", "compile", labels=("site", "kind"),
                      buckets=profiling.COMPILE_BUCKETS)
    b.labels(site="batched_bucket", kind="fresh").observe(0.25)
    with pytest.raises(ValueError):
        reg.gauge("distmlip_serve_completed_total")
    return reg, h.quantile(0.5), h.quantile(0.99)


def test_metrics_exposition_matches_jax():
    (jr, j50, j99), (pr, p50, p99) = _drive_metrics(jobs), _drive_metrics(obs)
    assert pr.render() == jr.render()
    assert pr.snapshot() == jr.snapshot()
    assert (p50, p99) == (j50, j99)
    parsed = obs.parse_exposition(pr.render())
    assert parsed == jobs.parse_exposition(jr.render())
    assert parsed["distmlip_serve_completed_total"] == 3.0
    assert parsed['distmlip_fleet_requests_total{tenant="_other"}'] == 2.0
    assert parsed['distmlip_metrics_label_overflow_total{metric="distmlip_fleet_requests_total"}'] \
        == 2.0
    assert obs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS


def _drive_slo(pkg):
    clock = FakeClock(0.0)
    fired = []
    mon = pkg.SLOMonitor(default=pkg.SLOConfig(latency_s=0.1, min_requests=4, fast_window_s=10,
                                               slow_window_s=60, cooldown_s=30),
                         per_tenant={"b": pkg.SLOConfig(latency_s=1.0)}, clock=clock,
                         on_breach=lambda t, info: fired.append((t, info)))
    pattern = [0.01, 0.2, 0.05, 0.3, 0.4, 0.5, 0.02, 0.6, 0.7, 0.01]
    for i, x in enumerate(pattern * 3):
        clock.advance(0.7 if i % 5 else 9.0)
        mon.observe("a" if i % 3 else "b", x, ok=(i % 11 != 0))
        if i in (7, 21):
            fired.append(("rates", mon.burn_rates("a")))
    return fired, mon.snapshot()


def test_slo_burn_rate_decisions_match_jax():
    jf, js = _drive_slo(jobs)
    pf, ps = _drive_slo(obs)
    assert pf == jf and ps == js
    assert any(t == "a" for t, _ in pf)  # at least one breach fired
    with pytest.raises(ValueError):
        obs.SLOConfig(objective=1.0)


def _drive_flight(pkg, out_dir):
    clock = FakeClock()
    tr = _drive_tracer(pkg, FakeClock())
    reg, _, _ = _drive_metrics(pkg)
    fr = pkg.FlightRecorder(out_dir, tracer=tr, metrics=reg, last_k_traces=2,
                            min_interval_s=60.0, clock=clock)
    first = fr.capture("serve deadline miss", attrs={"n_atoms": 8})
    second = fr.capture("again")            # rate-limited
    clock.advance(61.0)
    third = fr.capture("slo burn-rate breach", attrs={"tenant": "a"})
    return fr, [first, second, third]


def test_flight_captures_match_jax(tmp_path):
    jf, jdirs = _drive_flight(jobs, str(tmp_path / "jax"))
    pf, pdirs = _drive_flight(obs, str(tmp_path / "port"))
    assert [d is None for d in pdirs] == [d is None for d in jdirs] == [False, True, False]
    assert (pf.captures, pf.suppressed) == (jf.captures, jf.suppressed) == (2, 1)
    for jd, pd in zip(jdirs[::2], pdirs[::2]):
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
        with open(os.path.join(jd, "incident.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(pd, "incident.json")) as f:
            pmeta = json.load(f)
        jmeta.pop("t_wall"), pmeta.pop("t_wall")
        assert pmeta == jmeta
        for name in ("metrics.prom", "metrics.json"):
            with open(os.path.join(jd, name)) as f, open(os.path.join(pd, name)) as g:
                assert g.read() == f.read()
        assert _normalized(obs.load_trace(os.path.join(pd, "trace.json"))) == \
            _normalized(jobs.load_trace(os.path.join(jd, "trace.json")))


def test_hub_install_and_snapshot():
    hub = obs.Observability.enable(slo={"t": obs.SLOConfig(latency_s=0.5)})
    try:
        assert obs.hub() is hub and obs.runtime.tracer() is hub.tracer
        assert obs.runtime.current_trace_id() is None
        with hub.tracer.span("x"):
            assert obs.runtime.current_trace_id() is not None
        hub.metrics.counter("c").inc()
        snap = hub.snapshot()
        assert snap["tracer"]["spans_finished"] == 1 and "c" in snap["metrics"]
        assert hub.slo.default.latency_s == 0.5
    finally:
        obs.uninstall()
    assert obs.hub() is None
    other = obs.Observability.enable(metrics=False, register=False)
    assert obs.hub() is None and other.metrics is None
    other.close()


def test_compile_log_matches_jax():
    for pkg in (jobs, obs):
        pkg.reset_compile_log()
    reg = obs.MetricsRegistry()
    obs.install(obs.Observability(metrics=reg))
    try:
        for pkg in (jobs, obs):
            pkg.record_compile("batched_bucket", "fresh", 0.5, bucket_key="n64_e1024_B4")
            pkg.record_compile("kernel_build", "fresh", 3.25, bucket_key="segment_sum",
                               executable_bytes=1024)
    finally:
        obs.uninstall()
    jev = [e.as_dict() for e in jobs.compile_events()]
    pev = [e.as_dict() for e in obs.compile_events()]
    for e in jev + pev:
        e.pop("t_wall")
    assert pev == jev and obs.compile_counts() == jobs.compile_counts() == {"fresh": 2}
    parsed = obs.parse_exposition(reg.render())
    assert parsed['distmlip_compiles_total{site="kernel_build",kind="fresh"}'] == 1.0
    assert parsed['distmlip_compile_seconds_count{site="batched_bucket",kind="fresh"}'] == 1.0
    obs.reset_compile_log()


# ---------------------------------------------------------------------------
# attribution and roofline
# ---------------------------------------------------------------------------

def _jax_shaped_trace():
    ev = []
    rows = [("fusion.12", "jit(step)/mace/interaction/dot_general", 120.0),
            ("collective-permute.1", "jit(step)/halo_exchange/ppermute", 40.0),
            ("custom-call.3", "jit(step)/pallas_segment_sum", 55.0),
            ("scatter-add.2", "", 30.0),
            ("transpose.7", "jit(step)/transpose(jvp(mace))/interaction", 80.0),
            ("copy.1", "", 10.0), ("MemcpyD2H", "", 5.0), ("loop_add_fusion", "", 12.5),
            ("reduce.3", "jit(step)/segment_sum", 17.0)]
    for i, (name, scope, dur) in enumerate(rows):
        ev.append({"ph": "X", "name": name, "ts": 10.0 * i, "dur": dur, "pid": 1, "tid": 2,
                   "args": {"long_name": scope} if scope else {}})
    ev.append({"ph": "M", "name": "process_name", "pid": 1})
    ev.append({"ph": "X", "name": "$idle", "ts": 0, "dur": 9999})
    return {"traceEvents": ev}


def test_attribution_of_a_jax_shaped_trace_matches_jax(tmp_path):
    trace = _jax_shaped_trace()
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    for src in (trace, path, trace["traceEvents"]):
        want = jattribution.attribute(1.0, trace=src, program="step").as_dict()
        got = attribution.attribute(1.0, trace=src, program="step").as_dict()
        want["by_category"] = {("custom_kernel" if k == "pallas_kernel" else k): v
                               for k, v in want["by_category"].items()}
        assert got == want
    assert got["by_category"]["custom_kernel"] > 0 and got["n_events"] == 8
    for name, scope in (("dot", "a/halo/b"), ("x", "mosaic"), ("y", "jvp_transpose"),
                        ("gather", ""), ("foo", "")):
        want = jattribution.classify(name, scope)
        assert attribution.classify(name, scope) == (
            "custom_kernel" if want == "pallas_kernel" else want)
    empty = attribution.attribute(2.0, program="x")
    assert empty.as_dict() == jattribution.attribute(2.0, program="x").as_dict()
    with pytest.raises(NotImplementedError, match="A13"):
        attribution.attribute(1.0, jaxpr=object())


def _torch_shaped_trace():
    """A forward (MACE interaction 0 with a GEMM and B1, a halo copy), its
    backward on the autograd thread (a Sequence-number match), a kernel
    placed only by a gpu_user_annotation range, and a memcpy."""
    cpu = lambda name, ts, dur, tid=1, cat="cpu_op", **args: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 10, "tid": tid,
        "args": args}
    launch = lambda ts, corr, tid=1: {  # noqa: E731
        "ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
        "pid": 10, "tid": tid, "args": {"correlation": corr}}
    kern = lambda name, ts, dur, corr=None, cat="kernel": {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
        "args": {} if corr is None else {"correlation": corr}}
    ev = [
        cpu("distmlip/potential", 0, 1000, cat="user_annotation"),
        cpu("mace/interaction0", 10, 400, cat="user_annotation"),
        cpu("aten::mm", 20, 10, **{"Sequence number": 5}), launch(22, 1),
        cpu("aten::index_add_", 40, 10), launch(42, 2),
        cpu("halo/exchange", 300, 50, cat="user_annotation"), launch(310, 3),
        cpu("autograd::engine::evaluate_function: MmBackward0", 500, 100, tid=2,
            **{"Sequence number": 5}),
        launch(510, 4, tid=2),
        kern("sm90_xmma_gemm_f32f32_tf32f32", 100, 50, 1),
        kern("void segment_sum_kernel_rows<float>(float const*)", 160, 20, 2),
        kern("void at::native::index_elementwise_kernel<128, 4>", 360, 8, 3),
        kern("sm90_xmma_gemm_backward_kernel", 700, 30, 4),
        kern("void at::native::vectorized_elementwise_kernel<4>", 810, 10),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "mace/readout0", "ts": 800,
         "dur": 100, "pid": 0, "tid": 7},
        kern("Memcpy DtoH (Device -> Pinned)", 950, 6, cat="gpu_memcpy"),
    ]
    return {"traceEvents": ev}


def test_attribution_places_torch_profiler_events():
    bd = attribution.attribute(0.0, trace=_torch_shaped_trace(), program="mace")
    assert bd.source == "trace" and bd.n_events == 6
    us = {k: round(v * 1e6, 6) for k, v in bd.by_category.items()}
    assert us == {"other": 66.0, "custom_kernel": 20.0, "halo_exchange": 8.0,
                  "gradient_transpose": 30.0}
    assert round(bd.total_s * 1e6, 6) == 124.0
    scopes = {k: round(v * 1e6, 6) for k, v in bd.by_scope.items()}
    assert scopes == {"distmlip/potential/mace/interaction0": 70.0,
                      "distmlip/potential/mace/interaction0/halo/exchange": 8.0,
                      "distmlip/potential/mace/interaction0/backward": 30.0,
                      "mace/readout0": 10.0, "Memcpy DtoH (Device -> Pinned)": 6.0}
    layers = {k: round(v * 1e6, 6) for k, v in attribution.by_layer(bd).items()}
    assert layers == {"mace/interaction0": 100.0, "halo/exchange": 8.0, "mace/readout0": 10.0,
                      "(unscoped)": 6.0}
    assert attribution.is_port_kernel("so2_conv_bf16_kernel")
    assert attribution.is_port_kernel("tensornet_interaction_bwd_kernel_bf16")
    assert not attribution.is_port_kernel("sm90_xmma_gemm")
    # a CPU-only capture: no device event, an empty breakdown
    cpu_only = {"traceEvents": [e for e in _torch_shaped_trace()["traceEvents"]
                                if e["cat"] in ("cpu_op", "user_annotation")]}
    assert attribution.attribute_trace(cpu_only).n_events == 0


def test_roofline_rows_from_records_match_jax():
    def recs(cls):
        out = []
        for i, (kind, key, t) in enumerate([("calculate", "", 0.1), ("calculate", "", 0.3),
                                            ("calculate", "", 0.2), ("batched_calculate", "b1",
                                                                     0.05)]):
            out.append(cls(kind=kind, bucket_key=key, timings={"device_s": t},
                           est_peak_bytes=10_000 * (i + 1), num_partitions=1 + (i == 3),
                           compiled=(i == 0), extra={"flops_per_step": 1e9 * (i + 1)}))
        out.append(cls(kind="serve_batch"))
        return out
    jrows = jroofline.rows_from_records(recs(JStepRecord))
    prows = roofline.rows_from_records(recs(StepRecord))
    assert [r.as_dict() for r in prows] == [r.as_dict() for r in jrows]
    assert roofline.format_roofline_table(prows) == jroofline.format_roofline_table(jrows)
    row = roofline.RooflineRow("p", flops=1e12, bytes=1e9, time_s=0.1, peak_flops=67e12)
    assert row.mfu == pytest.approx(1e13 / 67e12) and row.ridge_bound == "compute"
    with pytest.raises(NotImplementedError, match="A13"):
        roofline.jaxpr_flop_estimate(object())


# ---------------------------------------------------------------------------
# the serving engine with a hub installed
# ---------------------------------------------------------------------------

def _pair_engine(**kw):
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.models import PairConfig, PairPotential
    from distmlip_tpu_torch.serve import ServeEngine

    pot = BatchedPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")),
                           {"eps": np.float32(0.05), "sigma": np.float32(2.0)}, device="cpu")
    return ServeEngine(pot, max_batch=4, max_wait_s=0.002, start=False, **kw)


def _pool(n, seed=0):
    from distmlip_tpu_torch.calculators import Atoms
    from tests.utils import make_crystal

    out = []
    for i in range(n):
        cart, lat, _ = make_crystal(np.random.default_rng(seed + i), reps=(2, 2, 2), a=3.8,
                                    noise=0.03)
        out.append(Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat))
    return out


def test_engine_spans_metrics_slo_and_flight(tmp_path):
    import urllib.request

    profiling.reset_compile_log()
    hub = obs.Observability.enable(slo=obs.SLOConfig(latency_s=60.0),
                                   flight_dir=str(tmp_path / "incidents"))
    server = obs.MetricsServer(hub.metrics, port=0)
    try:
        engine = _pair_engine()
        pool = _pool(6)
        futs = [engine.submit(a) for a in pool[:4]]
        late = engine.submit(pool[4], deadline=0.0)   # resolves past its deadline
        bad = pool[5].copy()
        bad.positions[0, 0] = np.nan
        poison = engine.submit(bad)
        engine.start()
        assert engine.drain(timeout=120)
        results = [f.result() for f in futs + [late]]
        with pytest.raises(ValueError, match="non-finite"):
            poison.result()
        engine.close()
        with urllib.request.urlopen(server.url, timeout=30) as resp:
            scraped = obs.parse_exposition(resp.read().decode())
        spans = hub.tracer.spans()
    finally:
        server.close()
        obs.uninstall()
    assert len(results) == 5
    summary = obs.request_trace_summary(spans)
    assert summary["requests"] == 6 and summary["complete"] == 6
    assert summary["terminal_violation_count"] == 0 and summary["terminals"] == 6
    statuses = sorted(s.status for s in spans if s.name == "future.resolve")
    assert statuses == ["error"] + ["ok"] * 5
    names = {s.name for s in spans}
    assert {"engine.submit", "engine.queue", "serve.batch", "scheduler.plan_batch",
            "batched.pack", "device.compile", "future.resolve"} <= names
    paths = obs.critical_path_summary(spans)
    assert paths["requests"] == 6 and paths["coverage_p50"] > 0.5
    assert scraped["distmlip_serve_completed_total"] == 5.0
    assert scraped["distmlip_serve_failed_total"] == 1.0
    assert scraped["distmlip_serve_submitted_total"] == 6.0
    assert scraped["distmlip_serve_deadline_miss_total"] == 1.0
    assert scraped["distmlip_serve_request_latency_seconds_count"] == 5.0
    assert scraped['distmlip_compiles_total{site="batched_bucket",kind="fresh"}'] >= 1.0
    assert hub.slo.snapshot()["engine"]["good"] == 5 and hub.slo.snapshot()["engine"]["bad"] == 1
    assert hub.flight.captures == 1
    incident = hub.flight.incidents[0]
    with open(os.path.join(incident, "incident.json")) as f:
        assert json.load(f)["reason"] == "serve deadline miss"
    assert {e.site for e in profiling.compile_events()} == {"batched_bucket"}
    profiling.reset_compile_log()


def test_engine_without_a_hub_makes_no_span():
    assert obs.hub() is None
    engine = _pair_engine()
    fut = engine.submit(_pool(1)[0])
    assert engine._pending[0].trace is None
    engine.start()
    assert engine.drain(timeout=60)
    assert np.isfinite(fut.result()["energy"])
    engine.close()
