"""The port's active-learning layer (``distmlip_tpu_torch.active``) against
the JAX package's, on the CPU.

- ``EnsembleBatchedPotential``: a narrow MACE's three-member lane against
  the JAX package's vmapped lane on the same weights (the port's ``init``
  as numpy, members drawn from numpy seeds) and against three lone port
  ``BatchedPotential``s; ``calculate`` is member 0 exactly; a variance
  call right after a serve of the same batch adds no rebuild;
  ``set_primary`` swaps member 0.
- ``ReplayBuffer``: a spill written by the JAX package loads in the port,
  and the reverse; dedup and priority eviction.
- ``holdout_split`` and the trigger's decisions equal the JAX package's.
- ``params_digest`` and the router's rolled ``model_id`` equal the JAX
  package's; hot-swap refusals mutate nothing; a swap reuses every serving
  bucket and rolls the cache identity.
- ``run_finetune`` against the JAX ``run_finetune`` (Adam, 4 steps, the
  pair potential): the ship decision, ``val_before`` / ``val_after`` and
  the shipped parameters to rel 1e-5; the divergent job is refused by both;
  the resume gate compares against the live weights.
- ``ActiveLoop``: for one seed the same requests escalate as in the JAX
  loop and the buffer holds the same structures with the committee's
  labels; the loop over a two-replica fleet fine-tunes, swaps and serves
  the new weights; its records render in the port's report.
- The CLI gate ``--fleet 2 --chaos kill-replica --active --check --device
  cpu --model pair`` exits 0 in a subprocess.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distmlip_tpu import active as jactive
from distmlip_tpu import fleet as jfleet
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import BatchedPotential as JBatchedPotential
from distmlip_tpu.models import PairConfig as JPairConfig
from distmlip_tpu.models import PairPotential as JPairPotential
from distmlip_tpu.serve import ServeEngine as JServeEngine
from distmlip_tpu.train import Sample as JSample
from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.active import (ActiveLoop, EnsembleBatchedPotential, EscalationPolicy,
                                       FineTuneTrigger, HotSwapError, ReplayBuffer,
                                       TriggerPolicy, check_swappable, holdout_split,
                                       hot_swap_engine, hot_swap_router, params_digest,
                                       run_finetune, variance_score)
from distmlip_tpu_torch.calculators import Atoms, BatchedPotential
from distmlip_tpu_torch.fleet import FleetRouter, ResultCache, make_fleet
from distmlip_tpu_torch.models import PairConfig, PairPotential
from distmlip_tpu_torch.serve import ServeEngine
from distmlip_tpu_torch.telemetry import Telemetry
from distmlip_tpu_torch.telemetry.report import aggregate
from distmlip_tpu_torch.utils import params_from_numpy
from distmlip_tpu_torch.train import Sample
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.torch_train_common import both_samples, jax_model, numpy_tree, port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIES_MAP = np.array([0, 0, 1, 2])   # atomic numbers 1-3 -> species 0-2


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class CaptureSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def close(self):
        pass


def jitter(tree, scale, seed):
    """A numpy tree plus N(0, scale) from ``seed`` on its floating leaves,
    drawn in sorted-key order (the same tree for both packages)."""
    r = np.random.default_rng(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return [leaf(v) for v in x]
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return (x + scale * r.normal(size=x.shape)).astype(x.dtype)
        return x

    return leaf(tree)


def to_jax(a):
    return JAtoms(numbers=a.numbers, positions=a.positions, cell=a.cell, pbc=a.pbc,
                  info=dict(a.info))


def make_structure(rng, reps=(2, 1, 1), a=3.6, noise=0.04, species=14):
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * a, reps)
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, noise, (len(frac), 3))
    return Atoms(numbers=np.full(len(cart), species), positions=cart, cell=lattice)


@pytest.fixture(scope="module")
def pair():
    model = PairPotential(PairConfig(cutoff=4.0))
    return model, numpy_tree(model.init())


@pytest.fixture(scope="module")
def jpair():
    return JPairPotential(JPairConfig(cutoff=4.0))


def pair_engine(pair, params=None, **kw):
    model, p0 = pair
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_s", 0.005)
    return ServeEngine(BatchedPotential(model, p0 if params is None else params,
                                        device="cpu"), **kw)


# ---------------------------------------------------------------------------
# the ensemble lane: a narrow MACE against the JAX vmapped lane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mace_lane():
    """Three members of a narrow MACE, three 32-atom structures, and the
    JAX package's vmapped lane over them (one JAX evaluation)."""
    port_samples, jax_samples = both_samples(3)
    model = port_model("mace")
    p0 = numpy_tree(model.init(0))
    members = [p0, jitter(p0, 0.05, 1), jitter(p0, 0.05, 2)]
    jens = jactive.EnsembleBatchedPotential(jax_model("mace"), members,
                                            species_map=SPECIES_MAP)
    want = jens.calculate_with_variance([s.atoms for s in jax_samples])
    return model, members, [s.atoms for s in port_samples], want


def assert_close_scaled(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * scale


def test_ensemble_lane_equals_jax_vmapped_lane(mace_lane):
    model, members, structs, want = mace_lane
    ens = EnsembleBatchedPotential(model, members, species_map=SPECIES_MAP, device="cpu")
    got = ens.calculate_with_variance(structs)
    assert len(got) == len(want) and ens.last_stats["member_count"] == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("energy", "committee_energy", "energies"):
            assert_close_scaled(g[k], w[k], 1e-5)
        for k in ("forces", "forces_all", "committee_forces", "stress"):
            assert_close_scaled(g[k], w[k], 2e-5)
        assert_close_scaled(g["energy_var"], w["energy_var"], 1e-5)
        assert_close_scaled(g["forces_var"], w["forces_var"], 1e-4)
        assert g["forces_all"].shape == (3, len(structs[0]), 3)
    assert variance_score(got[0]) > 0


def test_ensemble_lane_equals_sequential_members(mace_lane):
    model, members, structs, _ = mace_lane
    sink = CaptureSink()
    ens = EnsembleBatchedPotential(model, members, species_map=SPECIES_MAP, device="cpu",
                                   telemetry=Telemetry([sink]))
    out = ens.calculate_with_variance(structs)
    (rec,) = [r for r in sink.records if r.kind == "ensemble_batched"]
    assert rec.member_count == 3 and rec.batch_size == len(structs)
    seq = [BatchedPotential(model, p, species_map=SPECIES_MAP, device="cpu")
           .calculate(structs) for p in members]
    for b in range(len(structs)):
        e_all = np.array([seq[k][b]["energy"] for k in range(3)])
        f_all = np.stack([seq[k][b]["forces"] for k in range(3)])
        s_all = np.stack([seq[k][b]["stress"] for k in range(3)])
        np.testing.assert_array_equal(out[b]["energies"], e_all)
        np.testing.assert_array_equal(out[b]["forces_all"], f_all)
        np.testing.assert_allclose(out[b]["stress"], s_all.mean(axis=0), rtol=1e-6,
                                   atol=1e-9)
        assert out[b]["energy_var"] == pytest.approx(e_all.var(), rel=1e-9)
        assert out[b]["committee_energy"] == pytest.approx(e_all[1:].mean(), rel=1e-12)
    # the serving path is member 0 exactly
    for a, b in zip(ens.calculate(structs), seq[0]):
        assert a["energy"] == b["energy"]
        np.testing.assert_array_equal(a["forces"], b["forces"])


def test_variance_after_serve_adds_no_rebuild_and_set_primary(mace_lane):
    model, members, structs, _ = mace_lane
    ens = EnsembleBatchedPotential(model, members, species_map=SPECIES_MAP, device="cpu",
                                   skin=0.3)
    ens.calculate(structs)
    rebuilds = ens.rebuild_count
    ens.calculate_with_variance(structs)
    assert ens.rebuild_count == rebuilds and ens.last_stats["rebuild_count"] == 0
    ens.set_primary(members[2])
    out = ens.calculate_with_variance(structs)
    np.testing.assert_array_equal(out[0]["energies"][0], out[0]["energies"][2])
    assert ens.rebuild_count == rebuilds
    with pytest.raises(HotSwapError):
        ens.set_primary({"bad": np.zeros(3)})
    three = EnsembleBatchedPotential(model, [members[1]] * 3, species_map=SPECIES_MAP,
                                     device="cpu")
    same = three.calculate_with_variance(structs[:1])[0]
    # identical members: a variance at float32 roundoff of the forces
    f_scale = max(float(np.abs(same["forces"]).max()), 1.0)
    assert same["energy_var"] == 0.0
    assert float(same["forces_var"].max()) <= (1e-6 * f_scale) ** 2
    with pytest.raises(ValueError):
        EnsembleBatchedPotential(model, [], device="cpu")


# ---------------------------------------------------------------------------
# replay buffer
# ---------------------------------------------------------------------------


def _fill(buf, structs, atoms_cls):
    for i, s in enumerate(structs):
        a = atoms_cls(numbers=s.numbers, positions=s.positions, cell=s.cell, pbc=s.pbc,
                      info={"charge": i % 2, "tag": "omat"})
        buf.add(a, float(i), np.full((len(a), 3), 0.25 * i), variance=0.1 * (i + 1),
                stress=np.eye(3) * i if i % 2 else None)
    wrapped = atoms_cls(numbers=structs[0].numbers,
                        positions=structs[0].positions + structs[0].cell[0],
                        cell=structs[0].cell, pbc=structs[0].pbc, info={"charge": 0,
                                                                      "tag": "omat"})
    buf.add(wrapped, 9.0, np.zeros((len(wrapped), 3)), variance=0.05)


def _entries(buf):
    return sorted((e.key, e.energy, e.variance, e.forces.tolist(),
                   None if e.stress is None else e.stress.tolist(),
                   e.atoms.positions.tolist(), e.atoms.numbers.tolist(),
                   sorted(e.atoms.info.items())) for e in buf._entries.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_buffer_spill_crosses_packages(rng, tmp_path, writer):
    structs = [make_structure(rng) for _ in range(4)]
    d = str(tmp_path / "buf")
    if writer == "jax":
        src = jactive.ReplayBuffer(capacity=3, directory=d)
        _fill(src, structs, JAtoms)
        dst = ReplayBuffer(capacity=3, directory=d)
    else:
        src = ReplayBuffer(capacity=3, directory=d)
        _fill(src, structs, Atoms)
        dst = jactive.ReplayBuffer(capacity=3, directory=d)
    assert len(dst) == len(src) == 3 and src.evictions == 2  # one over capacity, one re-add
    assert _entries(dst) == _entries(src)
    assert [s.energy for s in dst.to_samples()] == [s.energy for s in src.to_samples()]


def test_buffer_dedup_and_priority_eviction(rng):
    buf = ReplayBuffer(capacity=2)
    s1, s2, s3 = (make_structure(rng) for _ in range(3))
    f = np.zeros((len(s1), 3))
    assert buf.add(s1, 1.0, f, variance=0.5) is not None
    wrapped = s1.copy()
    wrapped.positions = wrapped.positions + wrapped.cell[0]
    buf.add(wrapped, 1.1, f, variance=0.2)
    assert len(buf) == 1 and buf.dedup_hits == 1
    entry = next(iter(buf._entries.values()))
    assert entry.variance == 0.5 and entry.energy == 1.1
    buf.add(s2, 2.0, f, variance=0.9)
    assert buf.add(s3, 3.0, f, variance=0.1) is None
    assert len(buf) == 2 and buf.evictions == 1
    samples = buf.to_samples()
    assert [s.energy for s in samples] == [2.0, 1.1]
    assert isinstance(samples[0], Sample)


# ---------------------------------------------------------------------------
# holdout split and trigger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("frac", [0.25, 0.5, 0.1])
def test_holdout_split_equals_jax(n, frac):
    items = list(range(n))
    assert holdout_split(items, frac) == jactive.holdout_split(items, frac)


def test_trigger_decisions_equal_jax():
    clock = FakeClock()
    policy = dict(min_buffer=4, interval_s=100.0, variance_drift=2.0, drift_window=4,
                  cooldown_s=10.0)
    trigs = [FineTuneTrigger(TriggerPolicy(**policy), clock=clock),
             jactive.FineTuneTrigger(jactive.TriggerPolicy(**policy), clock=clock)]
    script = [("adv", 500.0), ("due", 0), ("due", 1), ("fire", 1), ("due", 1),
              ("adv", 11.0), ("due", 1), ("due", 5), ("fire", 5), ("adv", 11.0),
              ("due", 7), ("due", 9), ("var", 1.0), ("var", 1.0), ("var", 1.0),
              ("var", 1.0), ("var", 3.0), ("var", 3.0), ("due", 1), ("fire", 1),
              ("adv", 5.0), ("due", 20), ("adv", 200.0), ("due", 2)]
    logs = [[], []]
    for op, x in script:
        if op == "adv":
            clock.advance(x)
            continue
        for t, log in zip(trigs, logs):
            if op == "due":
                log.append(t.due(x))
            elif op == "fire":
                t.note_fired(x)
            else:
                t.observe_variance(x)
            log.append(round(t.drift_ratio(), 12))
    assert logs[0] == logs[1]
    assert any(r and r.startswith("variance_drift") for r in logs[0] if isinstance(r, str))
    assert trigs[0].fired == trigs[1].fired == 3


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------


def test_params_digest_equals_jax(mace_lane, pair):
    _, members, _, _ = mace_lane
    model, p0 = pair
    for tree in (members[1], p0, {"a": [None, np.ones((2, 3), np.float32)], "b": None}):
        assert params_digest(params_from_numpy(tree)) == jactive.params_digest(tree)
        assert params_digest(tree) == jactive.params_digest(tree)


def test_router_swap_rolls_model_id_like_jax(rng, pair, jpair):
    model, p0 = pair
    p1 = jitter(p0, 0.1, 6)
    router = FleetRouter([pair_engine(pair)], result_cache=ResultCache(), model_id="pair")
    jrouter = jfleet.FleetRouter([JServeEngine(JBatchedPotential(jpair, p0), max_batch=4,
                                               max_wait_s=0.005)],
                                 result_cache=jfleet.ResultCache(), model_id="pair")
    atoms = make_structure(rng)
    e_old = router.submit(atoms).result(timeout=60)["energy"]
    router.submit(atoms).result(timeout=60)
    assert router.stats.cache_hits == 1
    dispatched = router.snapshot()["replicas"]["r0"]["dispatched_total"]
    report = hot_swap_router(router, p1)
    jreport = jactive.hot_swap_router(jrouter, p1)
    assert report["model_id"] == jreport["model_id"] == router.model_id == jrouter.model_id
    assert params_digest(p1) in router.model_id
    e_new = router.submit(atoms).result(timeout=60)["energy"]
    # recomputed on a replica with the new weights, never the stale entry
    assert router.snapshot()["replicas"]["r0"]["dispatched_total"] == dispatched + 1
    assert router.stats.cache_hits == 1 and len(router.cache) == 2
    ref = BatchedPotential(model, p1, device="cpu").calculate([atoms])[0]["energy"]
    assert e_new == pytest.approx(ref, abs=1e-6) and e_new != pytest.approx(e_old, abs=1e-9)
    again = hot_swap_router(router, p1, model_id="pair-v2")
    assert again["model_id"] == "pair-v2" and again["previous_model_id"] == report["model_id"]
    router.close()
    jrouter.close()


def test_hot_swap_engine_reuses_buckets_and_resolves_inflight(rng, pair):
    model, p0 = pair
    p1 = jitter(p0, 0.1, 5)
    engine = pair_engine(pair)
    pool = [make_structure(rng) for _ in range(4)]
    for f in [engine.submit(a) for a in pool]:
        f.result(timeout=60)
    compile_before = engine.compile_count
    futs = [engine.submit(a) for a in pool]
    report = hot_swap_engine(engine, p1)
    futs += [engine.submit(a) for a in pool]
    assert len([f.result(timeout=60) for f in futs]) == 8
    assert engine.compile_count == report["compile_count"] == compile_before
    ref = BatchedPotential(model, p1, device="cpu").calculate(pool)
    for a, b in zip([engine.submit(a).result(timeout=60) for a in pool], ref):
        assert a["energy"] == pytest.approx(b["energy"], abs=1e-6)
    # the live weights are a copy: mutating the caller's tree changes nothing
    p1["eps"] *= 2.0
    assert float(engine.potential.params["eps"]) != float(p1["eps"])
    assert engine.stats.failed == 0
    engine.close()


def test_hot_swap_refusals_mutate_nothing(rng, pair):
    model, p0 = pair
    engines = [pair_engine(pair, start=False) for _ in range(2)]
    live = [e.potential.params for e in engines]
    bad_shape = {k: np.zeros((2,), np.float32) for k in p0}
    bad_dtype = {k: np.float64(v) for k, v in p0.items()}
    bad_keys = {**p0, "extra": np.float32(1.0)}
    for bad in (bad_shape, bad_dtype, bad_keys, [p0]):
        with pytest.raises(HotSwapError):
            check_swappable(live[0], bad)
        with pytest.raises(HotSwapError):
            hot_swap_engine(engines[0], bad)
        assert engines[0].potential.params is live[0]
    # a fleet where one alive replica refuses: no replica is mutated, the
    # identity does not roll
    engines[1].potential.params = {**live[1], "extra": torch.tensor(1.0)}
    mixed = engines[1].potential.params
    router = FleetRouter(engines, model_id="pair")
    with pytest.raises(HotSwapError):
        hot_swap_router(router, jitter(p0, 0.1, 3))
    assert engines[0].potential.params is live[0] and engines[1].potential.params is mixed
    assert router.model_id == "pair"
    router.close(drain=False)


# ---------------------------------------------------------------------------
# run_finetune against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def finetune_samples(pair, jpair):
    """Six structures labelled by the pair potential's weights, as both
    packages' Samples."""
    model, p0 = pair
    r = np.random.default_rng(21)
    structs = [make_structure(r, noise=0.05) for _ in range(6)]
    labels = BatchedPotential(model, p0, device="cpu").calculate(structs)
    port = [Sample(a, res["energy"], res["forces"].astype(np.float32)) for a, res in
            zip(structs, labels)]
    jax_s = [JSample(to_jax(a), s.energy, s.forces) for a, s in zip(structs, port)]
    return port, jax_s


def test_run_finetune_equals_jax(pair, jpair, finetune_samples):
    import optax

    model, p0 = pair
    drifted = {k: (v * 1.05).astype(np.float32) for k, v in p0.items()}
    port_s, jax_s = finetune_samples
    got = run_finetune(model, drifted, port_s, steps=4, learning_rate=1e-2, device="cpu")
    want = jactive.run_finetune(jpair, drifted, jax_s, steps=4,
                                optimizer=optax.adam(1e-2))
    assert got.shipped == want.shipped is True
    assert (got.n_train, got.n_holdout, got.steps) == (want.n_train, want.n_holdout,
                                                       want.steps)
    assert got.val_before == pytest.approx(want.val_before, rel=1e-5)
    assert got.val_after == pytest.approx(want.val_after, rel=1e-5)
    assert got.history == pytest.approx(want.history, rel=1e-5)
    for k in p0:
        assert float(got.params[k]) == pytest.approx(float(want.params[k]), rel=1e-5)
    # the shipped candidate drops into a live engine as a pure swap
    check_swappable(BatchedPotential(model, p0, device="cpu").params, got.params)


def test_run_finetune_divergent_job_is_refused_by_both(pair, jpair, finetune_samples):
    import optax

    model, p0 = pair
    port_s, jax_s = finetune_samples
    got = run_finetune(model, p0, port_s, steps=3, device="cpu",
                       optimizer=functools.partial(torch.optim.SGD, lr=1e6))
    want = jactive.run_finetune(jpair, p0, jax_s, steps=3, optimizer=optax.sgd(1e6))
    assert not got.shipped and got.params is None
    assert got.shipped == want.shipped
    assert got.val_before == pytest.approx(want.val_before, rel=1e-5)


def test_run_finetune_resume_gate_compares_against_live(pair, finetune_samples, tmp_path):
    model, p0 = pair
    port_s, _ = finetune_samples
    ckpt = str(tmp_path / "ft")
    bad = {k: (v * 1.5).astype(np.float32) for k, v in p0.items()}
    run_finetune(model, bad, port_s, steps=2, learning_rate=1e-4, checkpoint_dir=ckpt,
                 device="cpu")
    report = run_finetune(model, p0, port_s, steps=4, learning_rate=1e-4,
                          checkpoint_dir=ckpt, device="cpu")
    assert report.resumed_step >= 1
    assert report.val_before < report.val_after
    assert not report.shipped and report.params is None


def test_run_finetune_default_device_is_cuda(monkeypatch, pair, finetune_samples):
    model, p0 = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_finetune(model, p0, finetune_samples[0], steps=1)


# ---------------------------------------------------------------------------
# ActiveLoop
# ---------------------------------------------------------------------------


def test_active_loop_escalations_equal_jax(rng, pair, jpair):
    """For one seed the same requests escalate in both packages' loops, and
    after the pump the buffers hold the same structures with the committee's
    labels."""
    model, p0 = pair
    members = [p0, jitter(p0, 0.05, 1), jitter(p0, 0.05, 2)]
    pool = [make_structure(rng) for _ in range(16)]
    policy = dict(sample_rate=0.3, force_var_floor=1e-12)
    ens = EnsembleBatchedPotential(model, members, device="cpu")
    engine = ServeEngine(ens, max_batch=4, max_wait_s=0.005)
    loop = ActiveLoop(engine, ens, policy=EscalationPolicy(**policy), seed=5,
                      escalation_batch=4)
    jens = jactive.EnsembleBatchedPotential(jpair, members)
    jengine = JServeEngine(jens, max_batch=4, max_wait_s=0.005)
    jloop = jactive.ActiveLoop(jengine, jens, policy=jactive.EscalationPolicy(**policy),
                               seed=5, escalation_batch=4)
    for a in pool:
        loop.submit(a).result(timeout=60)
        jloop.submit(to_jax(a)).result(timeout=120)
    assert loop.stats.escalated == jloop.stats.escalated > 0
    assert [p.positions.tolist() for p in loop._pending] == \
        [p.positions.tolist() for p in jloop._pending]
    assert loop.pump() == jloop.pump()
    assert loop.snapshot()["stats"] == jloop.snapshot()["stats"]
    got = {e.key: e for e in loop.buffer._entries.values()}
    want = {e.key: e for e in jloop.buffer._entries.values()}
    assert set(got) == set(want) and got
    for k in got:
        assert got[k].energy == pytest.approx(want[k].energy, rel=1e-5)
        assert_close_scaled(got[k].forces, want[k].forces, 2e-5)
        assert got[k].variance == pytest.approx(want[k].variance, rel=1e-3, abs=1e-9)
    engine.close()
    jengine.close()


def test_active_loop_over_fleet_finetunes_swaps_and_serves(rng, pair, finetune_samples):
    """Serve -> buffer -> fine-tune -> swap over a two-replica fleet: zero
    lost requests, no new serving bucket, the identity rolled, a formerly
    cached structure recomputed, post-swap results equal a fresh potential
    at the new weights; the active records render in the report."""
    model, p0 = pair
    drifted = {k: (v * 1.05).astype(np.float32) for k, v in p0.items()}
    sink = CaptureSink()
    tel = Telemetry([sink])
    router = make_fleet(2, lambda i: BatchedPotential(model, drifted, device="cpu"),
                        engine_kwargs=dict(max_batch=4, max_wait_s=0.005),
                        result_cache=ResultCache(), model_id="pair", telemetry=tel)
    ens = EnsembleBatchedPotential(model, [drifted, p0, jitter(p0, 0.01, 2)], device="cpu")
    loop = ActiveLoop(router, ens, ReplayBuffer(capacity=64),
                      policy=EscalationPolicy(sample_rate=1.0),
                      trigger=FineTuneTrigger(TriggerPolicy(min_buffer=6)), telemetry=tel,
                      finetune_kwargs={"steps": 6, "learning_rate": 1e-2})
    pool = [s.atoms for s in finetune_samples[0]] + [make_structure(rng) for _ in range(4)]
    for f in [loop.submit(a) for a in pool]:
        assert np.isfinite(f.result(timeout=60)["energy"])
    assert loop.pump() == len(pool)
    compiles = {rid: r["compile_count"] for rid, r in router.snapshot()["replicas"].items()}
    inflight = [loop.submit(a) for a in pool[:4]]
    report = loop.maybe_finetune()
    assert report is not None and report["shipped"], report
    assert all(np.isfinite(f.result(timeout=60)["energy"]) for f in inflight)
    snap = router.snapshot()
    assert {rid: r["compile_count"] for rid, r in snap["replicas"].items()} == compiles
    assert router.model_id != "pair" and snap["stats"]["failed"] == 0
    dispatched = sum(r["dispatched_total"] for r in snap["replicas"].values())
    served = router.submit(pool[0]).result(timeout=60)
    assert sum(r["dispatched_total"] for r in router.snapshot()["replicas"].values()) == \
        dispatched + 1
    ref = BatchedPotential(model, ens.params, device="cpu").calculate([pool[0]])[0]
    assert served["energy"] == pytest.approx(ref["energy"], abs=1e-6)
    router.close()
    tel.close()
    kinds = {r.kind for r in sink.records}
    assert {"active_escalate", "active_finetune", "active_swap", "fleet_request"} <= kinds
    rep = aggregate(sink.records)
    act = rep.counters["active"]
    assert act["swaps"] == 1 and act["shipped"] == 1 and act["member_count"] == 3
    assert "active learning (ActiveLoop)" in rep.render()


def test_active_loop_shares_the_card_and_budgets_the_finetune(monkeypatch, pair):
    """On one card the loop splits the room between the replicas and the
    ensemble lane (no budget grows), and its built-in fine-tune plans
    against the card less their budgets."""
    from types import SimpleNamespace

    from distmlip_tpu_torch.active import loop as loop_mod
    from distmlip_tpu_torch.active.trigger import FineTuneReport

    total, allocated = 80 * 2**30, 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (0, total))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: allocated)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    room = int(0.8 * total - allocated)
    card = torch.device("cuda", 0)
    pots = [SimpleNamespace(device=card, hbm_budget_bytes=room // 2) for _ in range(2)]
    router = SimpleNamespace(replicas={f"r{i}": SimpleNamespace(engine=SimpleNamespace(
        potential=p)) for i, p in enumerate(pots)})
    model, p0 = pair
    ens = SimpleNamespace(device=card, hbm_budget_bytes=room, model=model, params=p0)
    asked = {id(p): p.hbm_budget_bytes for p in pots + [ens]}
    loop = ActiveLoop(router, ens)
    granted = [p.hbm_budget_bytes for p in pots + [ens]]
    assert sum(granted) <= room
    assert all(p.hbm_budget_bytes <= asked[id(p)] for p in pots + [ens])
    seen = {}

    def finetune(model, params, samples, **kw):
        seen.update(kw)
        return FineTuneReport()

    monkeypatch.setattr(loop_mod, "run_finetune", finetune)
    loop.finetune_now()
    assert seen["hbm_budget_bytes"] == total - sum(granted)
    loop.finetune_kwargs["hbm_budget_bytes"] = 123
    loop.finetune_now()
    assert seen["hbm_budget_bytes"] == 123


def test_active_loop_sampling_policy_and_pending_bound(rng, pair):
    model, p0 = pair
    ens = EnsembleBatchedPotential(model, [p0, jitter(p0, 0.05, 1)], device="cpu")
    engine = ServeEngine(ens, max_batch=4, max_wait_s=0.005)
    loop = ActiveLoop(engine, ens, policy=EscalationPolicy(sample_rate=0.0, max_pending=2))
    pool = [make_structure(rng) for _ in range(3)]
    for f in [loop.submit(a) for a in pool]:
        f.result(timeout=60)
    assert loop.pending_escalations == 0
    for a in pool:
        loop.submit(a, escalate=True).result(timeout=60)
    assert loop.pending_escalations == 2 and loop.stats.escalation_dropped == 1
    assert loop.pump() == 2 and loop.stats.evaluated == 2
    engine.close()


# ---------------------------------------------------------------------------
# the CLI gate, and the import hygiene of the new modules
# ---------------------------------------------------------------------------


def test_load_test_cli_gate_exits_zero():
    r = subprocess.run(
        [sys.executable, "-m", "distmlip_tpu_torch.tools.load_test", "--fleet", "2",
         "--chaos", "kill-replica", "--active", "--check", "--device", "cpu", "--model",
         "pair", "--requests", "24", "--max-batch", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["check"] == "ok" and summary["device"] == "cpu"
    for k in ("zero_lost", "failover_observed", "no_dispatch_on_hits", "active_zero_lost",
              "active_no_swap_recompiles", "active_model_id_rolled", "trace_complete"):
        assert summary["checks"][k], k


def test_load_test_cli_refuses_usage_errors(monkeypatch):
    from distmlip_tpu_torch.tools import load_test

    assert load_test.main(["--fleet", "0"]) == 2
    with pytest.raises(SystemExit):
        load_test.main(["--fleet", "2", "--aot", "shared"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        load_test.main(["--fleet", "2", "--device", "cuda", "--requests", "4"])


def test_new_modules_import_without_jax():
    code = ("import sys, distmlip_tpu_torch.fleet, distmlip_tpu_torch.active, "
            "distmlip_tpu_torch.utils.health, distmlip_tpu_torch.tools.load_test; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'distmlip_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
