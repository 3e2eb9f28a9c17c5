"""The port's serving fleet (``distmlip_tpu_torch.fleet``, the engine's fleet
hooks, ``utils.health``) against the JAX package's, on the CPU.

- ``TokenBucket``, ``FairScheduler`` and ``ReprobePolicy`` give the JAX
  package's decision sequences under one fake clock.
- ``ServeEngine.extract_pending`` / ``health_snapshot``.
- The router's round trip over a pool of pair-potential structures against
  the JAX ``FleetRouter`` on the same pool and parameters (float32
  roundoff), its cache hits with zero dispatches, coalescing, quota
  rejects, the kill drill, the wedge drill (``fail_over`` and the
  ``ReplicaHealth`` monitor), the last replica never killed, every replica
  dead, the lifecycle, and ``make_fleet(aot_cache_dir=...)`` refusing.
- ``fleet_request`` records and the port's report over them, as
  ``tests/test_fleet.py`` holds the JAX fleet's.
- Replicas sharing one device: the cache key's precision is the replicas'
  compute dtype, the launch counters add up under threads, the device
  phase lock serializes replicas, and ``share_device_budget`` splits a
  card's room.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from distmlip_tpu import fleet as jfleet
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import BatchedPotential as JBatchedPotential
from distmlip_tpu.models import PairConfig as JPairConfig
from distmlip_tpu.models import PairPotential as JPairPotential
from distmlip_tpu.serve import ServeEngine as JServeEngine
from distmlip_tpu.utils import health as jhealth
from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.calculators import Atoms, BatchedPotential, DistPotential
from distmlip_tpu_torch.calculators import batched as batched_mod
from distmlip_tpu_torch.device import device_phase
from distmlip_tpu_torch.fleet import (FleetError, FleetRouter, Replica, ReplicaHealth,
                                      ResultCache, TenantConfig, TokenBucket, make_fleet)
from distmlip_tpu_torch.fleet.tenancy import FairScheduler
from distmlip_tpu_torch.kernels import count_launch, launch_counts
from distmlip_tpu_torch.models import PairConfig, PairPotential
from distmlip_tpu_torch.partition import BucketPolicy
from distmlip_tpu_torch.serve import EngineClosed, ServeEngine, ServeRejected
from distmlip_tpu_torch.telemetry import StepRecord, Telemetry
from distmlip_tpu_torch.telemetry.report import aggregate
from distmlip_tpu_torch.utils.health import ProbeConfig, ReprobePolicy
from tests.torch_threads import one_intra_op_thread  # noqa: F401


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def pair():
    model = PairPotential(PairConfig(cutoff=4.0))
    return model, model.init()


def make_structure(rng, noise=0.05):
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.6, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, noise, (len(frac), 3))
    return Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat)


def make_engine(pair, **kw):
    model, params = pair
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_s", 0.005)
    kw.setdefault("max_queue", 4096)
    return ServeEngine(BatchedPotential(model, params, caps=BucketPolicy(), device="cpu"),
                       **kw)


# ---------------------------------------------------------------------------
# host primitives against the JAX package's, one fake clock
# ---------------------------------------------------------------------------


def test_token_bucket_sequence_equals_jax():
    clock = FakeClock()
    port = TokenBucket(rate_hz=10.0, burst=3.0, clock=clock)
    ref = jfleet.TokenBucket(rate_hz=10.0, burst=3.0, clock=clock)
    got, want = [], []
    for dt in [0, 0, 0, 0, 0.1, 0, 0.05, 0.06, 100.0, 0, 0, 0, 0, 0.31, 0, 0, 0]:
        clock.advance(dt)
        got.append(port.take())
        want.append(ref.take())
    assert got == want
    assert got[:4] == [True, True, True, False]
    assert TokenBucket(rate_hz=0.2, clock=clock).burst == jfleet.TokenBucket(
        rate_hz=0.2, clock=clock).burst == 1.0


def _drive_scheduler(cls_sched, cls_cfg):
    s = cls_sched(clock=FakeClock())
    s.configure("heavy", cls_cfg(weight=3.0))
    s.configure("light", cls_cfg(weight=1.0))
    s.configure("capped", cls_cfg(weight=2.0, rate_hz=1.0, burst=2.0))
    out = []
    for i in range(20):
        s.enqueue("heavy", f"h{i}")
        s.enqueue("light", f"l{i}")
    out.append([s.admit("capped") for _ in range(4)])
    for i in range(3):
        s.enqueue("capped", f"c{i}")
    out.append([s.pop() for _ in range(16)])
    name, item = s.pop()
    s.enqueue(name, item, front=True)          # failover reclaim
    out.append([s.pop() for _ in range(8)])
    for i in range(4):                          # an idle tenant wakes late
        s.enqueue("sleepy", f"s{i}")
    out.append([s.pop() for _ in range(30)])
    out.append((s.backlog(), s.queue_depths(), s.stats()))
    return out


def test_fair_scheduler_sequence_equals_jax():
    port = _drive_scheduler(FairScheduler, TenantConfig)
    ref = _drive_scheduler(jfleet.FairScheduler, jfleet.TenantConfig)
    assert port == ref
    first16 = [name for name, _ in port[1]]
    assert first16.count("heavy") >= 2 * first16.count("light") > 0


def test_fair_scheduler_front_requeue_preserves_head():
    s = FairScheduler(clock=FakeClock())
    s.enqueue("t", "first")
    s.enqueue("t", "second")
    name, item = s.pop()
    s.enqueue("t", item, front=True)
    assert s.pop()[1] == "first"
    assert s.pop()[1] == "second"


def test_reprobe_policy_sequence_equals_jax():
    clock = FakeClock()
    pols = [ReprobePolicy(max_reprobes=2, backoff_s=1.0, clock=clock),
            jhealth.ReprobePolicy(max_reprobes=2, backoff_s=1.0, clock=clock)]
    seq = [(False, 0), (False, 0.5), (False, 0.6), (False, 0.2), (False, 1.5), (True, 0),
           (False, 3), (False, 1.1), (True, 1.1), (False, 0), (False, 2), (False, 2),
           (False, 2)]
    got = [[], []]
    for healthy, dt in seq:
        clock.advance(dt)
        for p, g in zip(pols, got):
            g.append((p.observe(healthy), p.failures))
    assert got[0] == got[1]
    assert "wedged" in [v for v, _ in got[0]]


def test_probe_config_from_env_equals_jax(monkeypatch):
    for k, v in (("BENCH_CLAIM_TIMEOUT_S", "12"), ("BENCH_RETRIES", "0"),
                 ("BENCH_WEDGE_REPROBES", "-3"), ("BENCH_WEDGE_REPROBE_TIMEOUT_S", "7")):
        monkeypatch.setenv(k, v)
    assert vars(ProbeConfig.from_env()) == vars(jhealth.ProbeConfig.from_env())
    assert ProbeConfig.from_env().retries == 1


def _canary(code):
    import subprocess

    return lambda: subprocess.Popen([sys.executable, "-c", code], start_new_session=True,
                                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


@pytest.mark.parametrize("code, ok", [("pass", True), ("import time; time.sleep(60)", False),
                                      ("raise SystemExit(3)", False)])
def test_canary_prober_equals_jax(code, ok):
    """A healthy canary, a wedged one (killed, one re-probe, killed again)
    and one that fails fast: the port's prober reports what the JAX
    package's does."""
    from distmlip_tpu_torch.utils.health import CanaryProber

    cfg = dict(claim_budget_s=0.6, retries=2, backoff_s=0.05, max_reprobes=1,
               reprobe_budget_s=0.3, poll_s=0.02)
    tels = [{}, {}]
    outs = []
    for cls, pcls, tel in ((CanaryProber, ProbeConfig, tels[0]),
                           (jhealth.CanaryProber, jhealth.ProbeConfig, tels[1])):
        outs.append(cls(_canary(code), config=pcls(**cfg), telemetry=tel).run()[0])
    assert outs == [ok, ok]
    drop = ("canary_elapsed_s", "canary_pid")
    assert {k: v for k, v in tels[0].items() if k not in drop} == \
        {k: v for k, v in tels[1].items() if k not in drop}


# ---------------------------------------------------------------------------
# engine hooks
# ---------------------------------------------------------------------------


def test_extract_pending_reclaims_unresolved_futures(rng, pair):
    engine = make_engine(pair, start=False)
    futs = [engine.submit(make_structure(rng), priority=p) for p in (1, 0, 2)]
    reqs = engine.extract_pending()
    assert [r.priority for r in reqs] == [0, 1, 2]
    assert engine.queue_depth == 0
    assert not any(r.future.done() for r in reqs)
    assert {r.future for r in reqs} == set(futs)
    with pytest.raises(EngineClosed):
        engine.submit(make_structure(rng))
    engine.close()


def test_health_snapshot_reports_progress_and_liveness(rng, pair):
    clock = FakeClock()
    engine = make_engine(pair, start=False, clock=clock)
    snap = engine.health_snapshot()
    assert snap["scheduler_alive"] is False
    assert set(snap) == {"queue_depth", "inflight", "scheduler_alive",
                         "last_progress_age_s", "completed", "failed"}
    engine.submit(make_structure(rng))
    clock.advance(42.0)
    snap = engine.health_snapshot()
    assert snap["queue_depth"] == 1 and snap["last_progress_age_s"] >= 42.0
    engine.start()
    assert engine.drain(timeout=60)
    snap = engine.health_snapshot()
    assert snap["scheduler_alive"] and snap["completed"] == 1
    assert snap["last_progress_age_s"] < 42.0
    engine.close()


# ---------------------------------------------------------------------------
# router against the JAX router
# ---------------------------------------------------------------------------


def test_router_roundtrip_equals_jax_router(rng, pair):
    model, params = pair
    structs = [make_structure(rng) for _ in range(12)]
    router = make_fleet(2, lambda i: BatchedPotential(model, params, device="cpu"),
                        engine_kwargs=dict(max_batch=4, max_wait_s=0.005),
                        result_cache=ResultCache(), model_id="pair")
    assert router.precision == "float32"
    results = [f.result(timeout=60) for f in [router.submit(a) for a in structs]]
    snap = router.snapshot()
    assert all(r["dispatched_total"] > 0 for r in snap["replicas"].values())
    router.close()

    jmodel = JPairPotential(JPairConfig(cutoff=4.0))
    jengines = [JServeEngine(JBatchedPotential(jmodel, jmodel.init()), max_batch=4,
                             max_wait_s=0.005) for _ in range(2)]
    jrouter = jfleet.FleetRouter(jengines, result_cache=jfleet.ResultCache(),
                                 model_id="pair")
    jstructs = [JAtoms(numbers=a.numbers, positions=a.positions, cell=a.cell, pbc=a.pbc)
                for a in structs]
    want = [f.result(timeout=120) for f in [jrouter.submit(a) for a in jstructs]]
    jrouter.close()
    for got, ref in zip(results, want):
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["forces"], ref["forces"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["stress"], ref["stress"], rtol=1e-5, atol=1e-6)
    # the same structure, model id and precision give the same cache key
    assert jfleet.cache_key(jstructs[0], "pair") == \
        jfleet.cache_key(jstructs[0], "pair", precision=router.precision)


def test_router_result_equals_dist_potential(rng, pair):
    model, params = pair
    router = FleetRouter([make_engine(pair) for _ in range(2)], result_cache=ResultCache(),
                         model_id="pair")
    a = make_structure(rng)
    got = router.submit(a).result(timeout=60)
    router.close()
    ref = DistPotential(model, params, device="cpu").calculate(a)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["forces"], ref["forces"], rtol=1e-5, atol=1e-5)


def test_router_cache_hits_perform_no_dispatch(rng, pair):
    router = FleetRouter([make_engine(pair)], result_cache=ResultCache(), model_id="pair")
    a = make_structure(rng)
    ref = router.submit(a).result(timeout=60)
    router.drain(timeout=60)
    disp_before = router.snapshot()["replicas"]["r0"]["dispatched_total"]
    eng_before = router.replicas["r0"].engine.stats.submitted
    for f in [router.submit(a.copy()) for _ in range(20)]:
        got = f.result(timeout=60)
        assert got["energy"] == ref["energy"]
        assert np.array_equal(got["forces"], ref["forces"])
    snap = router.snapshot()
    assert snap["stats"]["cache_hits"] == 20
    assert snap["replicas"]["r0"]["dispatched_total"] == disp_before
    assert router.replicas["r0"].engine.stats.submitted == eng_before
    assert router.cache.hit_rate() >= 0.9
    router.close()


def test_router_coalesces_identical_inflight(rng, pair):
    engine = make_engine(pair, start=False)
    router = FleetRouter([engine], result_cache=ResultCache(), model_id="pair")
    a = make_structure(rng)
    futs = [router.submit(a.copy()) for _ in range(5)]
    assert router.stats.coalesced == 4
    engine.start()
    results = [f.result(timeout=60) for f in futs]
    assert len({r["energy"] for r in results}) == 1
    for other in results[1:]:
        assert not np.shares_memory(results[0]["forces"], other["forces"])
    router.close()


def test_tenant_quota_rejects_over_rate(rng, pair):
    clock = FakeClock()
    router = FleetRouter(
        [make_engine(pair)],
        tenants={"firehose": TenantConfig(weight=1.0, rate_hz=10.0, burst=3.0)},
        clock=clock)
    a = make_structure(rng)
    futs = [router.submit(a.copy(), tenant="firehose") for _ in range(3)]
    with pytest.raises(ServeRejected):
        router.submit(a.copy(), tenant="firehose")
    ok = router.submit(a.copy(), tenant="interactive")
    for f in futs + [ok]:
        f.result(timeout=60)
    assert router.stats.quota_rejected == 1
    assert router.snapshot()["tenants"]["firehose"]["quota_rejects"] == 1
    router.close()


def test_kill_replica_mid_burst_loses_zero_requests(rng, pair):
    router = FleetRouter([make_engine(pair) for _ in range(2)], result_cache=ResultCache(),
                         model_id="pair")
    structs = [make_structure(rng) for _ in range(30)]
    futs = [router.submit(a) for a in structs[:15]]
    moved = router.kill_replica("r0")
    futs += [router.submit(a) for a in structs[15:]]
    results = [f.result(timeout=120) for f in futs]
    assert len(results) == 30 and all("energy" in r and "forces" in r for r in results)
    snap = router.snapshot()
    assert snap["stats"]["failovers"] == 1 and snap["stats"]["failed"] == 0
    assert not snap["replicas"]["r0"]["alive"]
    assert snap["replicas"]["r1"]["dispatched_total"] >= 15 + moved - 5
    router.close()


def test_failing_replica_fails_its_request_explicitly(rng, pair):
    """A replica whose potential raises fails that request through the
    router's contract: the error reaches the caller, nothing retries it on
    another route, the other requests are served."""
    model, params = pair
    bad = BatchedPotential(model, params, device="cpu")

    def boom(structures):
        raise RuntimeError("kernel fault")

    bad.calculate = boom
    router = FleetRouter([ServeEngine(bad, max_batch=1, max_wait_s=0.005)],
                         result_cache=ResultCache(), model_id="pair")
    with pytest.raises(RuntimeError, match="kernel fault"):
        router.submit(make_structure(rng)).result(timeout=60)
    assert router.stats.failed == 1 and router.stats.redispatches == 0
    router.close()


def test_failover_of_wedged_replica_redispatches_queued(rng, pair):
    wedged = make_engine(pair, start=False)
    healthy = make_engine(pair)
    router = FleetRouter([Replica(wedged, "r0"), Replica(healthy, "r1")], max_outstanding=4)
    futs = [router.submit(make_structure(rng)) for _ in range(8)]
    time.sleep(0.2)
    moved = router.fail_over("r0", reason="test wedge")
    assert moved >= 1
    for f in futs:
        assert "energy" in f.result(timeout=120)
    assert router.stats.redispatches >= moved
    router.close()
    wedged.close()


def test_health_monitor_confirms_wedge_only_after_reprobes(rng, pair):
    """A replica whose potential blocks on an event (in flight, no progress)
    is SUSPECT, then confirmed only after ``max_reprobes`` further looks past
    the backoff; its queue and its in-flight request are re-dispatched."""
    model, params = pair
    clock = FakeClock()
    gate = threading.Event()
    blocked = BatchedPotential(model, params, device="cpu")
    real = blocked.calculate

    def stuck(structures):
        gate.wait(60)
        return real(structures)

    blocked.calculate = stuck
    wedged = ServeEngine(blocked, max_batch=1, max_wait_s=0.001, clock=clock)
    healthy = make_engine(pair)
    router = FleetRouter([Replica(wedged, "r0"), Replica(healthy, "r1")], max_outstanding=3)
    monitor = ReplicaHealth(router, stall_budget_s=30.0, max_reprobes=2, backoff_s=1.0,
                            clock=clock)
    futs = [router.submit(make_structure(rng)) for _ in range(6)]
    deadline = time.time() + 30
    while wedged.health_snapshot()["inflight"] == 0 and time.time() < deadline:
        clock.advance(0.01)
        time.sleep(0.01)
    clock.advance(31.0)                       # past the stall budget
    verdicts = [monitor.poll_once()["r0"]]
    clock.advance(0.5)                        # inside the backoff: the verdict stands
    verdicts.append(monitor.poll_once()["r0"])
    clock.advance(1.5)
    verdicts.append(monitor.poll_once()["r0"])
    assert router.replicas["r0"].alive and monitor.failovers == 0
    clock.advance(1.5)
    verdicts.append(monitor.poll_once()["r0"])
    assert verdicts == ["suspect", "suspect", "suspect", "wedged"]
    assert not router.replicas["r0"].alive and monitor.failovers == 1
    for f in futs:
        assert "energy" in f.result(timeout=120)
    assert router.stats.failed == 0 and router.stats.redispatches >= 1
    assert monitor.poll_once()["r0"] == "dead"
    gate.set()
    monitor.close()
    router.close()


def test_health_monitor_never_kills_last_alive_replica(rng, pair):
    clock = FakeClock()
    wedged = make_engine(pair, start=False, clock=clock)
    router = FleetRouter([Replica(wedged, "r0")])
    monitor = ReplicaHealth(router, stall_budget_s=30.0, max_reprobes=1, backoff_s=1.0,
                            clock=clock)
    assert monitor.poll_once()["r0"] == "suspect"
    clock.advance(2.0)
    assert monitor.poll_once()["r0"] == "wedged"
    assert router.replicas["r0"].alive and monitor.failovers == 0
    monitor.close()
    router.close(drain=False)
    wedged.close()


def test_all_replicas_dead_fails_futures_explicitly(rng, pair):
    engine = make_engine(pair, start=False)
    router = FleetRouter([engine])
    futs = [router.submit(make_structure(rng)) for _ in range(3)]
    router.fail_over("r0", reason="test")
    for f in futs:
        with pytest.raises(FleetError):
            f.result(timeout=30)
    router.close()
    engine.close()


def test_router_close_and_lifecycle(rng, pair):
    router = FleetRouter([make_engine(pair)])
    f = router.submit(make_structure(rng))
    router.close()
    assert f.done()
    with pytest.raises(EngineClosed):
        router.submit(make_structure(rng))
    router.close()


def test_make_fleet_refuses_the_aot_cache(pair):
    model, params = pair
    with pytest.raises(NotImplementedError, match="A10b"):
        make_fleet(2, lambda i: BatchedPotential(model, params, device="cpu"),
                   aot_cache_dir="/nonexistent")
    with pytest.raises(ValueError):
        make_fleet(0, lambda i: None)


def test_make_fleet_default_device_is_cuda(monkeypatch, pair):
    model, params = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        make_fleet(2, lambda i: BatchedPotential(model, params))


# ---------------------------------------------------------------------------
# replicas sharing one device
# ---------------------------------------------------------------------------


def test_precision_is_the_replicas_compute_dtype(pair):
    model, params = pair
    engines = [make_engine(pair) for _ in range(2)]
    assert FleetRouter(engines).precision == "float32"
    with pytest.raises(ValueError, match="replicas compute in"):
        FleetRouter(engines, precision="bfloat16")
    engines[1].potential.compute_dtype = "bfloat16"
    with pytest.raises(ValueError, match="different dtypes"):
        FleetRouter(engines)
    for e in engines:
        e.close()


def test_launch_counts_add_up_under_threads():
    before = launch_counts["segment_sum"]
    n_threads, per = 8, 5000

    def bump():
        for _ in range(per):
            count_launch("segment_sum")

    ts = [threading.Thread(target=bump) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the threads hard
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert launch_counts["segment_sum"] - before == n_threads * per
    launch_counts["segment_sum"] = before


def test_device_phase_serializes_replicas(rng, pair):
    """Two replicas on one device: their device phases never overlap (a
    measured peak counts one replica's work), their host phases may."""
    model, params = pair
    pots = [BatchedPotential(model, params, device="cpu") for _ in range(2)]
    inside, overlaps = [0], []
    guard = threading.Lock()
    for pot in pots:
        real = pot._run_on_device

        def watched(structures, plan, real=real):
            with guard:
                inside[0] += 1
                overlaps.append(inside[0])
            time.sleep(0.005)
            try:
                return real(structures, plan)
            finally:
                with guard:
                    inside[0] -= 1

        pot._run_on_device = watched
    structs = [make_structure(rng) for _ in range(6)]
    threads = [threading.Thread(target=lambda p=p: [p.calculate([a]) for a in structs])
               for p in pots]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(overlaps) == 12 and max(overlaps) == 1
    assert device_phase("cpu") is device_phase(torch.device("cpu"))


def test_share_device_budget_splits_the_card(monkeypatch):
    class Pot:
        def __init__(self, budget):
            self.device = torch.device("cuda", 0)
            self.hbm_budget_bytes = budget

    total, allocated = 100 * 2**30, 4 * 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (0, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: allocated)
    room = int(0.8 * total - allocated)
    pots = [Pot(room), Pot(room), Pot(None)]
    batched_mod.share_device_budget(pots)
    assert [p.hbm_budget_bytes for p in pots] == [room // 2, room // 2, None]
    small = [Pot(2**30), Pot(2**30)]
    batched_mod.share_device_budget(small)     # already within the room: kept
    assert [p.hbm_budget_bytes for p in small] == [2**30, 2**30]


class _CudaPot:
    """A stand-in for a CUDA potential: a device and a budget."""

    def __init__(self, budget):
        self.device = torch.device("cuda", 0)
        self.hbm_budget_bytes = budget


def _stub_card(monkeypatch, total, allocated):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (0, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: allocated)


def test_share_device_budget_never_raises_a_budget(monkeypatch):
    """Past the room the split follows the budgets asked for: an explicit
    small budget beside a default one shrinks, never grows, and a
    potential listed twice counts once."""
    total, allocated = 80 * 2**30, 2**30
    _stub_card(monkeypatch, total, allocated)
    room = int(0.8 * total - allocated)
    small, default = _CudaPot(10 * 2**30), _CudaPot(room)
    batched_mod.share_device_budget([small, default, default])
    assert small.hbm_budget_bytes == room * (10 * 2**30) // (room + 10 * 2**30)
    assert default.hbm_budget_bytes == room * room // (room + 10 * 2**30)
    assert small.hbm_budget_bytes < 10 * 2**30 and default.hbm_budget_bytes < room
    assert small.hbm_budget_bytes + default.hbm_budget_bytes <= room


def test_device_room_left_leaves_out_the_serving_budgets(monkeypatch):
    total = 80 * 2**30
    _stub_card(monkeypatch, total, 0)
    pots = [_CudaPot(20 * 2**30), _CudaPot(30 * 2**30)]
    assert batched_mod.device_room_left("cuda:0", pots + pots[:1]) == total - 50 * 2**30
    assert batched_mod.device_room_left("cuda:0", []) == total
    assert batched_mod.device_room_left("cpu", pots) is None


def test_peak_allocated_keeps_the_mark_across_measured_phases(monkeypatch):
    """``begin_peak_measurement`` resets the allocator's mark so a phase
    reads its own peak; ``peak_allocated`` still reads the highest mark
    since ``reset_peak``."""
    from distmlip_tpu_torch import device as device_mod

    card = {"allocated": 100, "peak": 100}

    def reset(dev=None):
        card["peak"] = card["allocated"]

    def alloc(n):
        card["allocated"] += n
        card["peak"] = max(card["peak"], card["allocated"])

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: card["allocated"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev=None: card["peak"])
    monkeypatch.setattr(device_mod, "_high_water", {})
    device_mod.reset_peak()
    alloc(900)      # a trainer's step
    alloc(-900)
    base = device_mod.begin_peak_measurement("cuda")
    alloc(50)       # a replica's batch, far under the trainer's mark
    alloc(-50)
    assert torch.cuda.max_memory_allocated() - base == 50
    assert device_mod.peak_allocated() == 1000
    device_mod.reset_peak()
    assert device_mod.peak_allocated() == 100


# ---------------------------------------------------------------------------
# telemetry: fleet records and the port's report
# ---------------------------------------------------------------------------


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def close(self):
        pass


def test_fleet_records_carry_tenant_replica_cache_fields(rng, pair):
    sink = _ListSink()
    router = FleetRouter([make_engine(pair)], result_cache=ResultCache(), model_id="pair",
                         telemetry=Telemetry([sink]))
    a = make_structure(rng)
    router.submit(a, tenant="vip").result(timeout=60)
    router.submit(a.copy(), tenant="vip").result(timeout=60)
    router.close()
    fleet = [r for r in sink.records if r.kind == "fleet_request"]
    assert len(fleet) == 2
    served, hit = fleet
    assert served.tenant == "vip" and served.replica_id == "r0" and not served.cache_hit
    assert hit.cache_hit and hit.replica_id == ""
    assert all(len(r.request_latency_s) >= 1 for r in fleet)
    rep = aggregate(sink.records)
    assert rep.counters["fleet"]["requests"] == 2
    assert "fleet (FleetRouter):" in rep.render()


def _fleet_record(step, tenant, replica_id, lat, cache_hit=False, extra=None):
    return StepRecord(step=step, kind="fleet_request", tenant=tenant, replica_id=replica_id,
                      cache_hit=cache_hit, batch_size=1, request_latency_s=[lat],
                      timings={"total_s": lat}, extra=dict(extra or {}))


def test_report_fleet_section_and_load_skew_anomaly():
    records = [_fleet_record(i, "screening" if i % 2 else "interactive",
                             "r0" if i < 27 else "r1", 0.01 * (1 + i % 5))
               for i in range(30)]
    rep = aggregate(records)
    fl = rep.counters["fleet"]
    assert fl["requests"] == 30
    assert set(fl["tenants"]) == {"interactive", "screening"}
    assert fl["replica_share"]["r0"] > 0.8
    assert any(a.kind == "replica_load_skew" for a in rep.anomalies)
    assert "fleet (FleetRouter):" in rep.render()
    rep_fo = aggregate([_fleet_record(i, "t", "r0" if i < 27 else "r1", 0.01,
                                      extra={"failover_count": 1}) for i in range(30)])
    assert rep_fo.counters["fleet"]["failovers"] == 1
    assert not any(a.kind == "replica_load_skew" for a in rep_fo.anomalies)


def test_report_cache_thrash_anomaly_and_clean_fleet():
    rep = aggregate([_fleet_record(i, "t", "r0", 0.01, extra={"cache_evictions": 100})
                     for i in range(25)])
    assert any(a.kind == "cache_thrash" for a in rep.anomalies)
    rep2 = aggregate([_fleet_record(i, "t", f"r{i % 2}", 0.01, cache_hit=(i % 3 == 0))
                      for i in range(24)])
    kinds = {a.kind for a in rep2.anomalies}
    assert "replica_load_skew" not in kinds and "cache_thrash" not in kinds
    assert rep2.counters["fleet"]["cache_hit_rate"] > 0.2
