"""The serving engine of the port: ``plan_batch`` decision for decision
against the JAX package's, and the engine's behaviours (those of
``tests/test_serve.py``) on the port's pair model on the CPU.

Scheduler assembly, priority -> deadline -> FIFO order, the max-wait timer
(a fake clock: no real sleeps beyond 0.1 s), admission control (reject,
block, the measured memory budget), error isolation (a NaN request fails
only its own Future; a batch that raises is retried as singles), the
oversized lane to a ``DistPotential`` fallback, drain/close, and the load
drivers. Results through the engine equal ``DistPotential``'s on each
structure to float32 roundoff: |dE| <= 1e-5 max(1, |E|), max |dF| <= 5e-5.
"""

import threading
import time

import numpy as np
import pytest

from distmlip_tpu.partition import BucketPolicy as JBucketPolicy
from distmlip_tpu.serve import plan_batch as jax_plan_batch
from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.calculators import Atoms, BatchedPotential, DistPotential
from distmlip_tpu_torch.models import PairConfig, PairPotential
from distmlip_tpu_torch.partition import BucketPolicy
from distmlip_tpu_torch.serve import (EngineClosed, ServeEngine, ServeRejected, plan_batch,
                                      run_closed_loop, run_open_loop)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.serve


class FakeClock:
    """Deterministic engine clock: time moves only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def pair():
    model = PairPotential(PairConfig(cutoff=4.0))
    return model, model.init()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_structure(rng, reps=(1, 1, 1), a=3.5, noise=0.05):
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * a, reps)
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, noise, (len(frac), 3))
    return Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lattice)


def poison_structure(rng):
    bad = make_structure(rng)
    bad.positions[0, 0] = np.nan
    return bad


def batched(model, params, **kw):
    return BatchedPotential(model, params, device="cpu", **kw)


def assert_matches_single(res, ref):
    assert abs(res["energy"] - ref["energy"]) <= 1e-5 * max(1.0, abs(ref["energy"]))
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=5e-5)


# ---------------------------------------------------------------------------
# plan_batch: the same decisions as the JAX package's
# ---------------------------------------------------------------------------


def _calibrated(policy_cls, points):
    pol = policy_cls()
    for cap, peak in points:
        pol.calibrate_bytes(cap, peak)
    return pol


@pytest.mark.parametrize("seed", range(4))
def test_plan_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    points = [(128, 4 * 10 ** 6), (512, 9 * 10 ** 6)][:seed % 3]
    for trial in range(60):
        n = int(rng.integers(1, 40))
        hi = int(rng.choice([8, 64, 600, 5000]))
        sizes = [int(x) for x in rng.integers(1, hi, n)]
        max_batch = int(rng.choice([1, 2, 4, 8, 16]))
        window = int(rng.choice([4, 16, 64]))
        budget = [None, 5 * 10 ** 6, 2 * 10 ** 7][trial % 3]
        got = plan_batch(sizes, _calibrated(BucketPolicy, points), max_batch, window, budget)
        want = jax_plan_batch(sizes, _calibrated(JBucketPolicy, points), max_batch, window,
                              budget)
        for k in ("take", "skipped", "total_atoms", "node_cap", "est_bytes", "over_budget"):
            assert getattr(got, k) == getattr(want, k), (k, sizes, max_batch, window, budget)
        assert got.occupancy == want.occupancy


def test_plan_batch_rules():
    # a huge head seeds its own batch; all-tiny fills max_batch on one rung
    assert 0 in plan_batch([5000, 4, 4, 4], max_batch=8).take
    plan = plan_batch([4] * 20, max_batch=8)
    assert plan.take == list(range(8)) and plan.node_cap == 128
    # a rung-degrading candidate is skipped only at a power-of-two slot count
    plan = plan_batch([32, 32, 32, 32, 32, 32], BucketPolicy(), max_batch=8)
    assert plan.take == [0, 1, 2, 3] and plan.skipped and plan.occupancy == 1.0
    assert 3 in plan_batch([40, 40, 40, 40], BucketPolicy(), max_batch=8).take
    assert len(plan_batch([4] * 100, max_batch=64, window=10).take) == 10


# ---------------------------------------------------------------------------
# engine basics
# ---------------------------------------------------------------------------


def test_single_request_roundtrip(rng, pair):
    model, params = pair
    atoms = make_structure(rng)
    with ServeEngine(batched(model, params), max_wait_s=0.005) as engine:
        res = engine.submit(atoms).result(timeout=60)
        assert_matches_single(res, DistPotential(model, params, device="cpu").calculate(atoms))
        assert engine.stats.completed == 1
        assert isinstance(res["forces"], np.ndarray)


def test_staged_queue_assembles_one_full_batch(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_batch=8, max_wait_s=0.005, start=False)
    futs = [engine.submit(make_structure(rng)) for _ in range(8)]
    engine.start()
    for f in futs:
        f.result(timeout=60)
    assert engine.drain(timeout=30)
    assert engine.stats.batches == 1 and engine.stats.completed == 8
    dom = engine.stats.dominant_bucket()
    assert dom is not None and dom[1] == 1.0  # all 8 slots filled
    assert engine.compile_count == 1
    engine.close()


def test_priority_and_deadline_ordering(rng, pair):
    model, params = pair
    clock = FakeClock()
    engine = ServeEngine(batched(model, params), max_batch=1, max_wait_s=0.0, start=False,
                         clock=clock)
    order = []
    futs = {"lo": engine.submit(make_structure(rng), priority=5),
            "hi": engine.submit(make_structure(rng), priority=-5),
            # same priority: earliest deadline first, then FIFO
            "d2": engine.submit(make_structure(rng), priority=0, deadline=200.0),
            "d1": engine.submit(make_structure(rng), priority=0, deadline=100.0)}
    for name, f in futs.items():
        f.add_done_callback(lambda _f, n=name: order.append(n))
    engine.start()
    assert engine.drain(timeout=30)
    engine.close()
    assert order == ["hi", "d1", "d2", "lo"]


def test_max_wait_timer_fake_clock(rng, pair):
    model, params = pair
    clock = FakeClock()
    engine = ServeEngine(batched(model, params), max_batch=8, max_wait_s=50.0, clock=clock)
    fut = engine.submit(make_structure(rng))
    time.sleep(0.05)          # real time passes; the fake clock is frozen
    assert not fut.done(), "dispatched before the max-wait deadline"
    clock.advance(51.0)
    engine.kick()
    fut.result(timeout=60)
    assert engine.stats.batches == 1
    engine.close()


def test_deadline_miss_counted_and_shedding(rng, pair):
    model, params = pair
    clock = FakeClock()
    engine = ServeEngine(batched(model, params), max_batch=8, max_wait_s=0.0, start=False,
                         clock=clock)
    fut = engine.submit(make_structure(rng), deadline=0.5)
    clock.advance(1.0)        # the deadline expires in the queue
    engine.start()
    assert "energy" in fut.result(timeout=60)  # late results are delivered
    assert engine.drain(timeout=30)
    assert engine.stats.deadline_misses == 1
    engine.close()
    shed = ServeEngine(batched(model, params), max_wait_s=0.0, start=False, clock=clock,
                       shed_deadlines=True)
    late = shed.submit(make_structure(rng), deadline=0.5)
    ok = shed.submit(make_structure(rng))
    clock.advance(1.0)
    shed.start()
    with pytest.raises(ServeRejected, match="deadline shed"):
        late.result(timeout=60)
    ok.result(timeout=60)
    assert shed.stats.shed_count == 1 and shed.stats.deadline_misses == 0
    shed.close()


def test_properties_filter_and_cancel(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_batch=8, max_wait_s=0.005, start=False)
    fut = engine.submit(make_structure(rng))
    keep = engine.submit(make_structure(rng), properties=("energy", "forces"))
    assert fut.cancel()
    engine.start()
    assert set(keep.result(timeout=60)) == {"energy", "forces"}
    assert engine.drain(timeout=30)
    assert engine.stats.cancelled == 1 and engine.stats.completed == 1
    engine.close()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_reject(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_queue=2, admission="reject", start=False)
    engine.submit(make_structure(rng))
    engine.submit(make_structure(rng))
    with pytest.raises(ServeRejected, match="queue full"):
        engine.submit(make_structure(rng))
    assert engine.stats.rejected == 1
    engine.start()
    assert engine.drain(timeout=30)
    assert engine.stats.completed == 2
    engine.close()


def test_admission_block_unblocks_on_dispatch_and_close(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_queue=1, admission="block",
                         max_wait_s=0.005, start=False)
    f1 = engine.submit(make_structure(rng))
    blocked, done = [], threading.Event()

    def blocked_submit():
        blocked.append(engine.submit(make_structure(rng)))
        done.set()

    threading.Thread(target=blocked_submit, daemon=True).start()
    assert not done.wait(0.05), "submit should block while the queue is full"
    engine.start()
    assert done.wait(10), "blocked submit never unblocked"
    f1.result(timeout=60)
    blocked[0].result(timeout=60)
    engine.close()

    engine = ServeEngine(batched(model, params), max_queue=1, admission="block", start=False)
    engine.submit(make_structure(rng))
    raised = threading.Event()

    def closed_submit():
        try:
            engine.submit(make_structure(rng))
        except EngineClosed:
            raised.set()

    threading.Thread(target=closed_submit, daemon=True).start()
    time.sleep(0.05)
    engine.close(drain=False)
    assert raised.wait(10), "blocked submitter not released by close()"


def test_memory_admission_on_a_measured_rung(rng, pair):
    """A structure whose own rung was measured over the budget is rejected
    at submit; an unmeasured (extrapolated) one is admitted as a probe."""
    model, params = pair
    pot = batched(model, params, hbm_budget_bytes=10 ** 6)
    engine = ServeEngine(pot, max_wait_s=0.005, start=False)
    small = make_structure(rng)
    engine.submit(small)                         # nothing measured yet: admitted
    pot.caps.calibrate_bytes(pot.caps.get("nodes", len(small)), 5 * 10 ** 6)
    with pytest.raises(ServeRejected, match="budget"):
        engine.submit(make_structure(rng))
    assert engine.stats.rejected == 1
    engine.close(drain=False)


# ---------------------------------------------------------------------------
# error isolation
# ---------------------------------------------------------------------------


def test_poison_request_fails_only_its_own_future(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_batch=8, max_wait_s=0.005, start=False)
    goods = [make_structure(rng, reps=r) for r in ((1, 1, 1), (2, 1, 1), (2, 2, 1))]
    good_futs = [engine.submit(a) for a in goods]
    bad_fut = engine.submit(poison_structure(rng))
    engine.start()
    with pytest.raises(ValueError, match="non-finite"):
        bad_fut.result(timeout=60)
    single = DistPotential(model, params, device="cpu")
    for atoms, fut in zip(goods, good_futs):
        assert_matches_single(fut.result(timeout=60), single.calculate(atoms))
    assert "energy" in engine.submit(goods[0]).result(timeout=60)  # still serving
    assert engine.drain(timeout=30)
    assert engine.queue_depth == 0
    assert engine.stats.failed == 1 and engine.stats.scheduler_errors == 0
    engine.close()


class _StubPotential:
    """A potential that raises on any batch holding a marked structure: the
    batch-fault -> singles-retry path (the poison screen cannot see it)."""

    caps = BucketPolicy()
    compile_count = 0
    last_stats: dict = {}

    def __init__(self):
        self.batch_sizes = []

    def calculate(self, structures):
        self.batch_sizes.append(len(structures))
        if any(a.info.get("poison") for a in structures):
            raise RuntimeError("kernel launch failed")
        return [{"energy": float(len(a)), "free_energy": float(len(a))} for a in structures]


def test_batch_fault_isolated_by_singles_retry(rng):
    stub = _StubPotential()
    engine = ServeEngine(stub, max_batch=8, max_wait_s=0.005, start=False)
    goods = [make_structure(rng) for _ in range(3)]
    bad = make_structure(rng)
    bad.info["poison"] = True
    good_futs = [engine.submit(a) for a in goods]
    bad_fut = engine.submit(bad)
    engine.start()
    with pytest.raises(RuntimeError, match="launch failed"):
        bad_fut.result(timeout=60)
    for f in good_futs:
        assert f.result(timeout=60)["energy"] == 4.0
    assert engine.drain(timeout=30)
    engine.close()
    assert stub.batch_sizes[0] == 4 and sorted(stub.batch_sizes[1:]) == [1, 1, 1, 1]
    assert engine.stats.scheduler_errors == 0


# ---------------------------------------------------------------------------
# oversized-structure fallback lane
# ---------------------------------------------------------------------------


def test_oversized_routes_to_fallback(rng, pair):
    model, params = pair
    big, small = make_structure(rng, reps=(2, 2, 2)), make_structure(rng)
    engine = ServeEngine(batched(model, params),
                         fallback=DistPotential(model, params, device="cpu"),
                         max_batch_atoms=16, max_wait_s=0.005, start=False)
    f_big, f_small = engine.submit(big), engine.submit(small)
    engine.start()
    assert_matches_single(f_big.result(timeout=60),
                          DistPotential(model, params, device="cpu").calculate(big))
    f_small.result(timeout=60)
    assert engine.drain(timeout=30)
    assert engine.stats.fallback_requests == 1
    engine.close()
    engine = ServeEngine(batched(model, params), max_batch_atoms=16, max_wait_s=0.005)
    with pytest.raises(ValueError, match="max_batch_atoms"):
        engine.submit(make_structure(rng, reps=(2, 2, 2))).result(timeout=60)
    engine.close()


# ---------------------------------------------------------------------------
# lifecycle and load drivers
# ---------------------------------------------------------------------------


def test_drain_and_close(rng, pair):
    model, params = pair
    engine = ServeEngine(batched(model, params), max_batch=4, max_wait_s=10.0)
    futs = [engine.submit(make_structure(rng)) for _ in range(10)]
    assert engine.drain(timeout=60)  # a long max-wait: drain must flush
    assert engine.queue_depth == 0 and all(f.done() for f in futs)
    more = [engine.submit(make_structure(rng)) for _ in range(3)]
    engine.close()                   # drains first
    assert all(f.done() for f in more)
    engine.close()                   # idempotent
    with pytest.raises(EngineClosed):
        engine.submit(make_structure(rng))

    engine = ServeEngine(batched(model, params), max_wait_s=10.0, start=False)
    futs = [engine.submit(make_structure(rng)) for _ in range(3)]
    engine.close(drain=False)
    for f in futs:
        with pytest.raises(EngineClosed):
            f.result(timeout=10)


def test_unported_options_raise(pair):
    model, params = pair
    with pytest.raises(NotImplementedError, match="A12"):
        ServeEngine(batched(model, params), telemetry=object(), start=False)


def test_load_drivers(rng, pair):
    model, params = pair
    pool = [make_structure(rng) for _ in range(4)]
    with ServeEngine(batched(model, params, skin=0.5), max_batch=4, max_wait_s=0.005,
                     admission="block") as engine:
        rep = run_open_loop(engine, pool, 12, rate_hz=0.0)
        assert rep.n_ok == 12 and rep.n_failed == 0 and len(rep.latencies_s) == 12
        rep = run_closed_loop(engine, pool, 12, concurrency=3)
        assert rep.n_ok == 12 and rep.structures_per_sec > 0
        p = rep.latency_percentiles()
        assert 0 < p["p50_s"] <= p["p95_s"] <= p["p99_s"] <= p["max_s"]
        assert set(rep.summary()) >= {"latency_p95_ms", "structures_per_sec"}
