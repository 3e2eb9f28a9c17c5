"""The end of the main path: ``MolecularDynamics`` and ``Relaxer``, JAX vs port.

Drivers alone: one deterministic numpy potential (harmonic springs to
lattice sites that follow the cell, plus a volume term, with its stress) is
handed to the JAX package's drivers and to the port's, so the only
difference is the driver. Both integrate in float64 numpy with the same
arithmetic, so positions, velocities, cells and energies must be equal bit
for bit: all 9 ensembles for 5 seeded steps, all 5 optimizers with a fixed
cell and with the ``unit`` and ``exp`` cell filters, and ``traj_file``
files of a converged and a non-converged relaxation.

End to end: a small TensorNet (the one of ``test_torch_tensornet.py``) on a
32-atom crystal of light atoms through the JAX ``DistPotential(
num_partitions=1, skin=0.5)`` and the port's ``DistPotential(device="cpu",
skin=0.5)`` with the same parameters, 5 ``nvt_langevin`` steps and a
10-step FIRE relaxation. Both sides serve their skin-cache invalidations
with their on-device neighbor rebuild. Both compute in float32 and sum in
different orders, so energies agree to rel 1e-5 and positions to 1e-5 Å.
The JAX side runs once per module.
"""

import jax
import numpy as np
import pytest

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.calculators import MolecularDynamics as JMolecularDynamics
from distmlip_tpu.calculators import Relaxer as JRelaxer
from distmlip_tpu.models import TensorNet as JTensorNet
from distmlip_tpu.models import TensorNetConfig as JTensorNetConfig
from distmlip_tpu_torch import calculators
from distmlip_tpu_torch.calculators import (ENSEMBLES, Atoms, DistPotential,
                                            MolecularDynamics, Relaxer, RelaxResult,
                                            TrajectoryObserver)
from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401


class SpringPotential:
    """E = k/2 sum |x_i - s_i|^2 + B/2 (V - V0)^2 / V0 with the sites
    s = frac0 @ cell; forces -k d, stress (k d^T d + B (V - V0) / V0 V I) / V
    (ASE sign: dE/d(strain) / V)."""

    compute_stress = True

    def __init__(self, frac0, v0, k=2.0, bulk=0.5):
        self.frac0, self.v0, self.k, self.bulk = frac0, v0, k, bulk
        self.calls = 0

    def calculate(self, atoms):
        self.calls += 1
        d = atoms.positions - self.frac0 @ atoms.cell
        vol = abs(np.linalg.det(atoms.cell))
        dv = (vol - self.v0) / self.v0
        energy = 0.5 * self.k * float(np.sum(d * d)) + 0.5 * self.bulk * (vol - self.v0) * dv
        stress = (self.k * d.T @ d + self.bulk * dv * vol * np.eye(3)) / vol
        return {"energy": energy, "forces": -self.k * d, "stress": stress}


def _spring_case(atoms_cls, seed=3):
    rng = np.random.default_rng(seed)
    cart, lat, _ = make_crystal(rng, reps=(2, 2, 2), a=4.0, noise=0.1)
    frac0 = np.linalg.solve(lat.T, (cart - rng.normal(0, 0.1, cart.shape)).T).T
    atoms = atoms_cls(numbers=np.full(len(cart), 14), positions=cart, cell=lat * 1.02)
    atoms.set_maxwell_boltzmann_velocities(500.0, rng=np.random.default_rng(seed + 1))
    return atoms, SpringPotential(frac0, abs(np.linalg.det(lat)))


def _assert_same_atoms(a, b):
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.velocities, b.velocities)
    np.testing.assert_array_equal(a.cell, b.cell)


def test_exports():
    for name in ("MolecularDynamics", "TrajectoryObserver", "ENSEMBLES", "Relaxer",
                 "RelaxResult"):
        assert name in calculators.__all__
    assert len(ENSEMBLES) == 9


@pytest.mark.parametrize("ensemble", ENSEMBLES)
def test_md_driver_matches_jax_bit_for_bit(ensemble):
    trajs = []
    for atoms_cls, md_cls in ((JAtoms, JMolecularDynamics), (Atoms, MolecularDynamics)):
        atoms, pot = _spring_case(atoms_cls)
        obs = TrajectoryObserver(atoms)
        md = md_cls(atoms, pot, ensemble=ensemble, timestep=1.0, temperature=400.0,
                    pressure=0.5, taut=20.0, taup=50.0, andersen_prob=0.2, seed=11,
                    trajectory=obs)
        md.run(5)
        assert pot.calls == 6 and md.nsteps == 5
        trajs.append((atoms, obs, md))
    (ja, jobs, jmd), (ta, tobs, tmd) = trajs
    _assert_same_atoms(ja, ta)
    assert jobs.energies == tobs.energies
    np.testing.assert_array_equal(np.array(jobs.cells), np.array(tobs.cells))
    assert jmd._nh_xi == tmd._nh_xi and jmd._mtk_eps_p == tmd._mtk_eps_p
    if ensemble.startswith("npt"):
        assert not np.array_equal(ta.cell, _spring_case(Atoms)[0].cell)


@pytest.mark.parametrize("cell", [None, "unit", "exp"])
@pytest.mark.parametrize("optimizer", ["fire", "lbfgs", "bfgs", "mdmin", "cg"])
def test_relaxer_matches_jax_bit_for_bit(optimizer, cell):
    kw = dict(optimizer=optimizer, relax_cell=cell is not None,
              cell_filter=cell or "unit", fmax=1e-3, smax=1e-4)
    outs = []
    for atoms_cls, relaxer_cls in ((JAtoms, JRelaxer), (Atoms, Relaxer)):
        atoms, pot = _spring_case(atoms_cls)
        outs.append(relaxer_cls(pot, **kw).relax(atoms, steps=12, record=True))
    ref, res = outs
    assert isinstance(res, RelaxResult)
    _assert_same_atoms(ref.atoms, res.atoms)
    assert (res.converged, res.nsteps, res.energy) == (ref.converged, ref.nsteps, ref.energy)
    np.testing.assert_array_equal(res.forces, ref.forces)
    np.testing.assert_array_equal(res.stress, ref.stress)
    assert [t["energy"] for t in res.trajectory] == [t["energy"] for t in ref.trajectory]
    assert res.energy < res.trajectory[0]["energy"]


@pytest.mark.parametrize("fmax,interval,converged", [(0.5, 1, True), (1e-6, 2, False)])
def test_relaxer_traj_file_matches_jax(tmp_path, fmax, interval, converged):
    files = []
    for atoms_cls, relaxer_cls, tag in ((JAtoms, JRelaxer, "jax"), (Atoms, Relaxer, "port")):
        atoms, pot = _spring_case(atoms_cls)
        path = str(tmp_path / f"{tag}.npz")
        out = relaxer_cls(pot, optimizer="fire", fmax=fmax).relax(
            atoms, steps=40, traj_file=path, interval=interval)
        assert out.converged is converged
        files.append(np.load(path))
    ref, res = files
    assert sorted(res.files) == sorted(ref.files)
    for key in ref.files:
        np.testing.assert_array_equal(res[key], ref[key])
    assert res["energies"][-1] == out.energy  # the last frame is the result


def test_telemetry_hub_is_refused():
    """Once refused, a hub is now routed to the potential (its own hub
    wins); a potential without ``attach_telemetry`` just runs."""
    from distmlip_tpu_torch.telemetry import Telemetry, TelemetrySink

    class Keep(TelemetrySink):
        def __init__(self):
            self.records = []

        def emit(self, record):
            self.records.append(record)

    atoms, spring = _spring_case(Atoms)
    MolecularDynamics(atoms, spring, telemetry=Telemetry([Keep()])).run(1)
    Relaxer(spring, telemetry=Telemetry([Keep()]))
    cart, lat, _ = make_crystal(np.random.default_rng(0), reps=(2, 2, 2), a=3.4, noise=0.05)
    model = TensorNet(TensorNetConfig(num_species=4, units=8, num_rbf=4, cutoff=3.0))
    for drive in ("md", "relax"):
        keep = Keep()
        hub = Telemetry([keep])
        pot = DistPotential(model, model.init(0), device="cpu", skin=0.3)
        atoms = Atoms(numbers=np.full(len(cart), 3), positions=cart.copy(), cell=lat)
        if drive == "md":
            MolecularDynamics(atoms, pot, ensemble="nve", telemetry=hub).run(2)
        else:
            Relaxer(pot, telemetry=hub).relax(atoms, steps=2)
        assert pot.telemetry is hub and len(keep.records) == pot._step_counter
        assert pot._step_counter >= (3 if drive == "md" else 1)
        assert {r.kind for r in keep.records} == {"calculate"}
        pot.attach_telemetry(Telemetry([Keep()]))  # the first hub stays
        assert pot.telemetry is hub


# ---------------------------------------------------------------------------
# end to end: TensorNet through both DistPotentials
# ---------------------------------------------------------------------------

CFG = dict(num_species=4, units=16, num_rbf=8, num_layers=2, cutoff=4.0)
MD_KW = dict(ensemble="nvt_langevin", timestep=2.0, temperature=1000.0, seed=0)
RELAX_KW = dict(optimizer="fire", fmax=1e-4)


def _light_crystal(atoms_cls):
    cart, lat, _ = make_crystal(np.random.default_rng(1), reps=(2, 2, 2), a=4.0)
    numbers = np.random.default_rng(2).integers(1, 4, len(cart))  # H, He, Li
    atoms = atoms_cls(numbers=numbers, positions=cart, cell=lat)
    atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(3))
    return atoms


def _run(atoms_cls, md_cls, relaxer_cls, pot):
    atoms = _light_crystal(atoms_cls)
    energies = []

    class Record:
        def record(self, results):
            energies.append(results["energy"])

    md = md_cls(atoms, pot, trajectory=Record(), **MD_KW)
    md.run(5)
    md_counts = (pot.rebuild_count, pot.rebuild_on_device_count)
    relaxed = relaxer_cls(pot, **RELAX_KW).relax(_light_crystal(atoms_cls), steps=10,
                                                 record=True)
    return {"md_positions": atoms.positions.copy(), "md_energies": energies,
            "md_counts": md_counts, "relax": relaxed,
            "counts": (pot.rebuild_count, pot.rebuild_on_device_count,
                       pot.rebuild_overflow_count)}


@pytest.fixture(scope="module")
def jax_run():
    params = jax.tree.map(np.array, JTensorNet(JTensorNetConfig(**CFG)).init(
        jax.random.PRNGKey(0)))
    pot = JDistPotential(JTensorNet(JTensorNetConfig(**CFG)), params, num_partitions=1,
                         skin=0.5)
    return params, _run(JAtoms, JMolecularDynamics, JRelaxer, pot)


@pytest.fixture(scope="module")
def port_run(jax_run):
    params, _ = jax_run
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params, device="cpu", skin=0.5)
    return _run(Atoms, MolecularDynamics, Relaxer, pot)


def test_md_end_to_end_matches_jax(jax_run, port_run):
    _, ref = jax_run
    res = port_run
    # both took their device refresh during the trajectory
    assert ref["md_counts"][1] >= 1 and res["md_counts"] == ref["md_counts"]
    assert len(res["md_energies"]) == 5
    np.testing.assert_allclose(res["md_energies"], ref["md_energies"], rtol=1e-5)
    np.testing.assert_allclose(res["md_positions"], ref["md_positions"], rtol=0, atol=1e-5)


def test_relax_end_to_end_matches_jax(jax_run, port_run):
    _, ref = jax_run
    res = port_run
    assert res["relax"].nsteps == ref["relax"].nsteps == 10
    assert res["counts"] == ref["counts"] and res["counts"][2] == 0
    np.testing.assert_allclose([t["energy"] for t in res["relax"].trajectory],
                               [t["energy"] for t in ref["relax"].trajectory], rtol=1e-5)
    assert abs(res["relax"].energy - ref["relax"].energy) < 1e-5 * abs(ref["relax"].energy)
    np.testing.assert_allclose(res["relax"].atoms.positions, ref["relax"].atoms.positions,
                               rtol=0, atol=1e-5)
