"""Telemetry records, JAX vs port: ``distmlip_tpu_torch.telemetry``.

- **Records from DistPotential**: the same small MACE (the port's
  ``init(0)`` carried to the JAX side as numpy) on the same crystal through
  the JAX ``DistPotential`` and the port's, at P = 1 and P = 2 with a hub,
  over ``MolecularDynamics`` steps hot enough for skin-cache hits and host
  rebuilds (``device_rebuild=False`` on both sides: the JAX package keeps
  its build-time edge count through a device refresh, the port counts the
  refreshed edges, a separate check). The record streams match field by
  field: kind, n_atoms, num_partitions, the caps, the nodes, edges and halo
  send/recv per partition, the occupancies, the cache and rebuild flags and
  ``frontier_edge_frac``. Timings, ``t_wall``, ``device_memory``, the
  compile fields, the kernel routing ("plain" here, "xla" there) and the
  fields the JAX package reads from its jaxpr audit (A13) are not compared.
- **No effect**: the same MD without a hub gives bit-for-bit the same
  positions and velocities; with no hub no record is built.
- ``DeviceMD``'s chunk records, a batched and a served pair-model batch
  (``bucket_key``, ``batch_size``, ``padding_waste_frac``,
  ``batch_occupancy``) and a ``Trainer``'s ``TrainRecord`` stream against
  the JAX package's (losses and gradient norm within rel 1e-5: float32
  programs summing in another order).
- **Reports**: a JSONL written by either package renders to the same text
  in both packages' reports; the CLI's exit codes.
- The trace annotations, ``device_trace`` on the CPU, ``StepTimer``, the
  sinks, ``peak_flops_per_device``, ``mfu`` and ``hbm_usage_frac``.
"""

import functools
import io
import json

import jax
import numpy as np
import optax
import pytest
import torch

from distmlip_tpu import telemetry as jtel
from distmlip_tpu import train as jtrain
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import BatchedPotential as JBatchedPotential
from distmlip_tpu.calculators import DeviceMD as JDeviceMD
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.calculators import MolecularDynamics as JMolecularDynamics
from distmlip_tpu.models import MACE as JMACE
from distmlip_tpu.models import MACEConfig as JMACEConfig
from distmlip_tpu.models import PairConfig as JPairConfig
from distmlip_tpu.models import PairPotential as JPairPotential
from distmlip_tpu.serve import ServeEngine as JServeEngine
from distmlip_tpu.telemetry import report as jreport
from distmlip_tpu.utils import memory as jmemory
from distmlip_tpu_torch import telemetry, train
from distmlip_tpu_torch.calculators import (Atoms, BatchedPotential, DeviceMD, DistPotential,
                                            MolecularDynamics, calculator)
from distmlip_tpu_torch.models import MACE, MACEConfig, PairConfig, PairPotential
from distmlip_tpu_torch.serve import ServeEngine
from distmlip_tpu_torch.telemetry import report, trace
from distmlip_tpu_torch.utils import flops, memory, profiling
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.torch_train_common import CUTOFF, both_samples, jax_model, numpy_tree, port_model
from tests.torch_train_common import species_fn as train_species_fn
from tests.utils import make_crystal

MACE_CFG = dict(num_species=4, channels=8, l_max=1, a_lmax=1, hidden_lmax=1, correlation=2,
                num_interactions=2, num_bessel=4, radial_mlp=8, cutoff=3.0,
                avg_num_neighbors=12.0, edge_chunk=0)
MD_STEPS = 5
RECORD_FIELDS = ("kind", "n_atoms", "num_partitions", "n_cap", "e_cap", "b_cap",
                 "n_nodes_per_part", "n_edges_per_part", "halo_send_per_part",
                 "halo_recv_per_part", "node_occupancy", "edge_occupancy", "graph_reused",
                 "rebuild", "prefetch_adopted", "rebuild_count", "rebuild_on_device",
                 "rebuild_overflow_count", "frontier_edge_frac", "spatial_parts",
                 "batch_parts", "mesh_shape", "step")
LJ_PARAMS = {"eps": np.float32(0.05), "sigma": np.float32(2.0)}


class Keep(telemetry.TelemetrySink):
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


class JKeep(jtel.TelemetrySink):
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _crystal():
    # 4 x 2 x 2 cells of 3.5 Å: 14 Å along x, two slabs of 7 Å > 2 (3.0 + 0.3)
    return make_crystal(np.random.default_rng(1), reps=(4, 2, 2), a=3.5, noise=0.05,
                        n_species=3)


def _md(side, P, hub, path=None):
    """MACE MolecularDynamics on one side ("jax" or "port"); returns
    (atoms, records, jsonl path)."""
    cart, lat, spec = _crystal()
    params = _numpy(MACE(MACEConfig(**MACE_CFG)).init(0))
    if side == "jax":
        A, Pot, MD, Keeper = JAtoms, JDistPotential, JMolecularDynamics, JKeep
        pot = Pot(JMACE(JMACEConfig(**MACE_CFG)), params, num_partitions=P, skin=0.3,
                  kernels=False, device_rebuild=False)
        sinks = [Keeper()] + ([jtel.JsonlSink(path)] if path else [])
        tel = jtel.Telemetry(sinks) if hub else None
    else:
        A, MD, Keeper = Atoms, MolecularDynamics, Keep
        pot = DistPotential(MACE(MACEConfig(**MACE_CFG)), params, num_partitions=P, skin=0.3,
                            device="cpu", device_rebuild=False)
        sinks = [Keeper()] + ([telemetry.JsonlSink(path)] if path else [])
        tel = telemetry.Telemetry(sinks) if hub else None
    atoms = A(numbers=spec + 1, positions=cart.copy(), cell=lat,
              masses=np.full(len(cart), 6.94))
    atoms.set_maxwell_boltzmann_velocities(1500.0, rng=np.random.default_rng(3))
    MD(atoms, pot, ensemble="nve", timestep=2.0, telemetry=tel).run(MD_STEPS)
    if tel is not None:
        tel.close()
    return atoms, (sinks[0].records if hub else None), pot


@pytest.fixture(scope="module")
def md_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jsonl")
    out = {}
    for P in (1, 2):
        for side in ("jax", "port"):
            out[(side, P)] = _md(side, P, True, str(d / f"{side}{P}.jsonl"))
            out[(side, P, "path")] = str(d / f"{side}{P}.jsonl")
        out[("port", P, "nohub")] = _md("port", P, False)
    return out


@pytest.mark.parametrize("P", [1, 2])
def test_distpotential_records_match_jax(md_runs, P):
    _, jrecs, _ = md_runs[("jax", P)]
    atoms, recs, pot = md_runs[("port", P)]
    assert len(recs) == len(jrecs) == MD_STEPS + 1 == pot._step_counter
    for r, jr in zip(recs, jrecs):
        got, want = r.to_dict(), jr.to_dict()
        for k in RECORD_FIELDS:
            assert got[k] == want[k], (r.step, k, got[k], want[k])
        assert (r.kernel_mode, r.kernel_coverage) == ("plain", 0.0)
        assert r.flops_per_step == jr.flops_per_step > 0 and r.mfu == 0.0
        assert r.device_memory == {} and set(jtel.PHASE_KEYS) - {"rebuild_s"} <= set(r.timings)
    # the run had cache hits and host rebuilds after the first build
    assert recs[0].rebuild and recs[0].compiled and recs[0].compile_kind == "fresh"
    assert any(r.graph_reused for r in recs) and sum(r.rebuild for r in recs) >= 2
    if P == 2:
        assert all(sum(r.halo_send_per_part) > 0 for r in recs)


@pytest.mark.parametrize("P", [1, 2])
def test_a_hub_changes_no_number(md_runs, P):
    a, _, _ = md_runs[("port", P)]
    b, _, pot = md_runs[("port", P, "nohub")]
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.velocities, b.velocities)
    assert pot.telemetry is None and pot._step_counter == MD_STEPS + 1


def test_no_record_is_built_without_a_hub(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a record was built")

    monkeypatch.setattr(calculator, "StepRecord", refuse)
    cart, lat, _ = make_crystal(np.random.default_rng(2), reps=(2, 2, 2), a=3.8, noise=0.03)
    pot = DistPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                        device="cpu", skin=0.3)
    pot.calculate(Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat))
    # a closed hub emits nothing either
    hub = telemetry.Telemetry([Keep()])
    hub.close()
    pot.attach_telemetry(hub)
    pot.calculate(Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat))
    assert hub.sinks[0].records == []


def test_device_refresh_counts_the_refreshed_edges():
    cart, lat, _ = make_crystal(np.random.default_rng(2), reps=(3, 3, 3), a=3.8, noise=0.03)
    keep = Keep()
    pot = DistPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                        device="cpu", skin=0.3, telemetry=telemetry.Telemetry([keep]))
    atoms = Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat)
    pot.calculate(atoms)
    atoms.positions = atoms.positions + np.random.default_rng(4).normal(0, 0.12, cart.shape)
    pot.calculate(atoms)
    r = keep.records[-1]
    assert r.rebuild_on_device == 1 and r.timings["rebuild_s"] >= 0.0
    assert r.n_edges_per_part == [pot.last_stats["n_edges"]]
    assert r.edge_occupancy == pot.last_stats["n_edges"] / r.e_cap


def test_ensemble_forwards_the_hub():
    from distmlip_tpu_torch.calculators import EnsemblePotential

    cart, lat, _ = make_crystal(np.random.default_rng(2), reps=(2, 2, 2), a=3.8, noise=0.03)
    atoms = Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat)
    model = PairPotential(PairConfig(cutoff=3.0, kind="lj"))
    members = [LJ_PARAMS, {"eps": np.float32(0.06), "sigma": np.float32(2.0)}]
    for stacked, kinds in ((True, ["ensemble_calculate"]),
                           (False, ["calculate", "calculate", "ensemble_calculate"])):
        keep = Keep()
        ens = EnsemblePotential(model, members, stacked=stacked, device="cpu")
        ens.attach_telemetry(telemetry.Telemetry([keep]))
        assert ens.telemetry is ens.members[0].telemetry
        ens.calculate(atoms)
        assert [r.kind for r in keep.records] == kinds
        assert keep.records[-1].member_count == 2
        assert keep.records[-1].n_atoms == (len(atoms) if stacked else 0)


def _lj_atoms(cls):
    from distmlip_tpu_torch import geometry

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * 3.8, (3, 3, 3))
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.03, (len(frac), 3))
    atoms = cls(numbers=np.full(len(cart), 14), positions=cart, cell=lattice)
    atoms.set_maxwell_boltzmann_velocities(300.0, rng=np.random.default_rng(7))
    return atoms


@pytest.mark.parametrize("P", [1, 2])
def test_device_md_chunk_records_match_jax(P):
    recs = {}
    for side in ("jax", "port"):
        if side == "jax":
            keep = JKeep()
            pot = JDistPotential(JPairPotential(JPairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                                 num_partitions=P, skin=0.4)
            md = JDeviceMD(pot, _lj_atoms(JAtoms), timestep=1.0,
                           telemetry=jtel.Telemetry([keep]))
        else:
            keep = Keep()
            pot = DistPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                                num_partitions=P, skin=0.4, device="cpu")
            md = DeviceMD(pot, _lj_atoms(Atoms), timestep=1.0,
                          telemetry=telemetry.Telemetry([keep]))
        md.run(40, max_chunk=20)
        recs[side] = keep.records
    assert len(recs["port"]) == len(recs["jax"]) >= 2
    for r, jr in zip(recs["port"], recs["jax"]):
        for k in ("kind", "n_atoms", "num_partitions", "n_cap", "e_cap", "rebuild_count",
                  "rebuild_on_device", "rebuild_overflow_count"):
            assert getattr(r, k) == getattr(jr, k), k
        for k in ("steps_done", "steps_total", "chunk_overflow", "zero_progress"):
            assert r.extra.get(k) == jr.extra.get(k), k
        assert r.kind == "md_chunk" and r.timings["device_s"] > 0
    assert sum(r.extra["steps_done"] for r in recs["port"]) == 40


def _pair_pool(cls, n=4):
    out = []
    for i in range(n):
        cart, lat, _ = make_crystal(np.random.default_rng(10 + i), reps=(2, 2, 1 + i % 2),
                                    a=3.8, noise=0.03)
        out.append(cls(numbers=np.full(len(cart), 14), positions=cart, cell=lat))
    return out


BATCH_FIELDS = ("bucket_key", "batch_size", "padding_waste_frac", "batch_occupancy", "n_atoms",
                "n_cap", "e_cap", "node_occupancy", "edge_occupancy", "graph_reused", "rebuild",
                "n_edges_per_part", "n_nodes_per_part")


def test_batched_records_match_jax():
    recs = {}
    for side, Pot, Model, Cfg, Tel, Keeper, A, kw in (
            ("jax", JBatchedPotential, JPairPotential, JPairConfig, jtel.Telemetry, JKeep,
             JAtoms, {"kernels": False}),
            ("port", BatchedPotential, PairPotential, PairConfig, telemetry.Telemetry, Keep,
             Atoms, {"device": "cpu"})):
        keep = Keeper()
        pot = Pot(Model(Cfg(cutoff=3.0, kind="lj")), LJ_PARAMS, skin=0.3, telemetry=Tel([keep]),
                  **kw)
        pool = _pair_pool(A)
        pot.calculate(pool)
        for a in pool:
            a.positions = a.positions + 0.01
        pot.calculate(pool)
        pot.calculate(pool[:3])
        recs[side] = keep.records
    assert len(recs["port"]) == len(recs["jax"]) == 3
    for r, jr in zip(recs["port"], recs["jax"]):
        assert r.kind == jr.kind == "batched_calculate"
        for k in BATCH_FIELDS:
            assert getattr(r, k) == getattr(jr, k), k
    assert [r.compiled for r in recs["port"]] == [True, False, True]
    assert [r.graph_reused for r in recs["port"]] == [False, True, False]


def test_served_batch_records_match_jax():
    recs = {}
    for side in ("jax", "port"):
        if side == "jax":
            keep, pool = JKeep(), _pair_pool(JAtoms)
            pot = JBatchedPotential(JPairPotential(JPairConfig(cutoff=3.0, kind="lj")),
                                    LJ_PARAMS, kernels=False)
            engine = JServeEngine(pot, max_batch=4, telemetry=jtel.Telemetry([keep]),
                                  start=False)
        else:
            keep, pool = Keep(), _pair_pool(Atoms)
            pot = BatchedPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                                   device="cpu")
            engine = ServeEngine(pot, max_batch=4, telemetry=telemetry.Telemetry([keep]),
                                 start=False)
        futs = [engine.submit(a) for a in pool]
        engine.start()
        assert engine.drain(timeout=120)
        [f.result() for f in futs]
        engine.close()
        recs[side] = keep.records
    kinds = [r.kind for r in recs["port"]]
    assert kinds == [r.kind for r in recs["jax"]] == ["batched_calculate", "serve_batch"]
    r, jr = recs["port"][1], recs["jax"][1]
    for k in ("bucket_key", "batch_size", "padding_waste_frac", "batch_occupancy", "n_atoms",
              "queue_depth", "reject_count", "deadline_miss_count", "shed_count"):
        assert getattr(r, k) == getattr(jr, k), k
    assert len(r.queue_wait_s) == len(r.request_latency_s) == 4
    assert r.batch_size == 4 and 0 < r.batch_occupancy <= 1


def test_trainer_records_match_jax():
    port, jx = both_samples(n=4)
    kw = dict(micro_batch_size=2, loader_kwargs={"species_fn": train_species_fn, "seed": 13})
    keep, jkeep = Keep(), JKeep()
    model = port_model("tensornet")
    t = train.Trainer(model.energy_fn, model.init(0), functools.partial(torch.optim.Adam, lr=3e-3),
                      port, CUTOFF, device="cpu", telemetry=telemetry.Telemetry([keep]), **kw)
    t.fit(steps=3)
    jt = jtrain.Trainer(jax_model("tensornet").energy_fn,
                        jax.tree.map(jax.numpy.asarray, numpy_tree(model.init(0))),
                        optax.adam(3e-3), jx, CUTOFF, kernels=False,
                        telemetry=jtel.Telemetry([jkeep]), **kw)
    jt.fit(steps=3)
    t.close()
    jt.close()
    assert len(keep.records) == len(jkeep.records) == 3
    for r, jr in zip(keep.records, jkeep.records):
        assert isinstance(r, telemetry.TrainRecord) and r.kind == jr.kind == "train_step"
        for k in ("step", "epoch", "skipped", "accum_steps", "micro_batch_size", "batch_size",
                  "n_atoms", "bucket_key", "tier", "padding_waste_frac", "edge_balance",
                  "compiled", "compile_kind"):
            assert getattr(r, k) == getattr(jr, k), k
        for k in ("loss", "loss_energy", "loss_force", "loss_stress", "grad_norm",
                  "loss_scale"):
            np.testing.assert_allclose(getattr(r, k), getattr(jr, k), rtol=1e-5, err_msg=k)
        assert np.isnan(r.val_loss) and set(r.timings) == {"data_s", "device_s", "total_s"}



def _render(mod, path):
    return mod.aggregate(mod.read_jsonl(path)).render()


@pytest.mark.parametrize("P", [1, 2])
def test_reports_render_either_jsonl_alike(md_runs, P):
    for side in ("jax", "port"):
        path = md_runs[(side, P, "path")]
        text = _render(report, path)
        assert text == _render(jreport, path)
        assert f"records={MD_STEPS + 1}" in text and "phase" in text
    port_rep = report.aggregate(report.read_jsonl(md_runs[("port", P, "path")]))
    assert port_rep.counters["kernel_modes"] == ["plain"]
    assert port_rep.to_dict()["n_records"] == MD_STEPS + 1


def test_report_cli(md_runs, tmp_path, capsys):
    path = md_runs[("port", 1, "path")]
    rc = report.main([path, "--json", str(tmp_path / "r.json"), "--stall-factor", "1000"])
    out = capsys.readouterr().out
    assert rc in (0, 4) and "records=" in out
    with open(tmp_path / "r.json") as f:
        assert json.load(f)["n_records"] == MD_STEPS + 1
    assert report.main([]) == 2
    assert report.main([str(tmp_path / "missing.jsonl")]) == 1
    # a killed run's truncated last line is skipped
    bad = tmp_path / "bad.jsonl"
    with open(path) as f, open(bad, "w") as g:
        g.write(f.read() + '{"kind": "calc')
    assert len(report.read_jsonl(str(bad))) == MD_STEPS + 1


def test_sinks_and_rotation(tmp_path):
    path = str(tmp_path / "r.jsonl")
    sink = telemetry.JsonlSink(path, max_bytes=600, keep=2)
    agg = telemetry.AggregatingSink(max_samples=4)
    err = io.StringIO()
    tel = telemetry.Telemetry([sink, agg, telemetry.StderrSummarySink(every=3, stream=err)])
    for i in range(10):
        tel.emit(telemetry.StepRecord(step=i, timings={"device_s": 0.01 * (i + 1)},
                                      node_occupancy=0.5, rebuild=i == 0))
    tel.close()
    assert sink.stats()["rotations"] >= 1 and len(sink.rotated_paths()) <= 2
    assert agg.counts["device_s"] == 10 and agg.rebuilds == 1
    assert "records=10" in agg.summary() and err.getvalue().count("# telemetry") == 4
    tel.emit(telemetry.StepRecord())  # after close: a no-op
    rec = telemetry.TrainRecord(loss=1.5)
    back = telemetry.StepRecord.from_json(rec.to_json())
    assert telemetry.TrainRecord.training_field(back, "loss") == 1.5
    assert jtel.StepRecord.from_json(rec.to_json()).extra["loss"] == 1.5


def test_annotations_and_device_trace(tmp_path):
    assert trace.annotate("x") is trace.scope("y")  # the shared null context
    with torch.profiler.profile() as prof:
        with trace.scope("mace/interaction0"):
            torch.ones(3).sum()
    assert any(e.key == "mace/interaction0" for e in prof.key_averages())
    trace.set_tracing(True)
    try:
        with trace.annotate("distmlip/potential") as r:
            assert r is not None
    finally:
        trace.set_tracing(False)
    with telemetry.device_trace(str(tmp_path / "cap")):
        assert trace.tracing_enabled()
        with trace.annotate("distmlip/potential"):
            torch.ones(8).cumsum(0)
    assert not trace.tracing_enabled()
    with open(tmp_path / "cap" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "distmlip/potential" in names
    timer = profiling.StepTimer()
    with timer.phase("a"):
        pass
    timer.add({"a": 0.5, "b": 0.25})
    assert timer.counts["a"] == 2 and "calls" in timer.summary()


def test_peak_mfu_and_memory():
    assert flops.peak_flops_per_device("float32", "NVIDIA H100 80GB HBM3") == 67e12
    assert flops.peak_flops_per_device("bfloat16", "NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops_per_device("float32", "Tesla V100") == 0.0
    assert flops.peak_flops_per_device() == 0.0  # no card here
    assert flops.mfu(1e12, 0.1, 1) == 0.0
    assert flops.mfu(6.7e12, 1.0, 1, peak=67e12) == pytest.approx(0.1)
    assert flops.mfu(1e12, 0.1, 1, peak=989e12, dtype="bfloat16") > 0
    stats = {"dev0_bytes_in_use": 10, "dev0_peak_bytes_in_use": 30, "dev0_bytes_limit": 100,
             "dev1_bytes_in_use": 50, "dev1_peak_bytes_in_use": 60, "dev1_bytes_limit": 80}
    assert memory.hbm_usage_frac(stats) == jmemory.hbm_usage_frac(stats) == 50 / 80
    assert memory.hbm_usage_frac({}) is None and memory.hbm_usage_frac() is None
