"""``DeviceMD``, the device-resident MD loop, JAX vs port.

The Lennard-Jones crystal of the JAX package's DeviceMD tests
(``tests/test_device_neighbors.py:196`` ``_lj_setup``: 108 Si-mass atoms,
fcc a = 3.8 Å, 3 x 3 x 3 cells rattled by 0.03 Å, ``PairPotential(kind=
"lj")`` at cutoff 3.0 with eps 0.05, sigma 2.0) goes through the JAX
``DeviceMD`` and the port's ``DeviceMD(device="cpu")`` from the same
velocities:

- P = 1 with the in-loop device refresh (skin 0.4, 40 steps; the refresh
  fires);
- P = 2 on the host-rebuild stepper;
- the warm-cache drift budget (``tests/test_calculators.py:500``), at P = 2
  (the cache is dropped) and at P = 1 with the host stepper (the cache is
  kept and refreshed on the device by ``_mark_cache_stale``);
- Berendsen NVT at skin 0.3 (``tests/test_calculators.py:532``);
- the overflow fallback with ``cell_capacity=1``
  (``tests/test_device_neighbors.py:427``).

Then a small MACE (2 interactions, 8 channels) on 32 light atoms, 10 steps
with refreshes, against the JAX ``DeviceMD`` at ``kernels=False``.

Bars: positions and velocities within 2e-4 Å and Å/fs (the JAX DeviceMD
tests' own, ``tests/test_calculators.py:492-495``), each chunk's energy
within rel 1e-5, and ``steps_done``, ``rebuilds``, ``rebuilds_on_device``
and ``rebuild_overflows`` equal to JAX's. Both sides integrate in float32
on the device and sum forces in other orders.
"""

import numpy as np
import pytest

from distmlip_tpu import geometry
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DeviceMD as JDeviceMD
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import MACE as JMACE
from distmlip_tpu.models import MACEConfig as JMACEConfig
from distmlip_tpu.models import PairConfig as JPairConfig
from distmlip_tpu.models import PairPotential as JPairPotential
from distmlip_tpu_torch import calculators
from distmlip_tpu_torch.calculators import (Atoms, DeviceMD, DistPotential,
                                            MolecularDynamics)
from distmlip_tpu_torch.models import MACE, MACEConfig, PairConfig, PairPotential
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.utils import make_crystal

LJ_PARAMS = {"eps": np.float32(0.05), "sigma": np.float32(2.0)}
COUNTERS = ("steps_done", "rebuilds", "rebuilds_on_device", "rebuild_overflows")


def _lj_atoms(cls, temperature=300.0, velocity_seed=7, seed=0):
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * 3.8, (3, 3, 3))
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.03, (len(frac), 3))
    atoms = cls(numbers=np.full(len(cart), 14), positions=cart, cell=lattice)
    if temperature:
        atoms.set_maxwell_boltzmann_velocities(
            temperature, rng=np.random.default_rng(velocity_seed))
    return atoms


def _lj_pair(P, skin, **kw):
    """(JAX potential, port potential) of the LJ model."""
    return (JDistPotential(JPairPotential(JPairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                           num_partitions=P, skin=skin, **kw),
            DistPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                          num_partitions=P, skin=skin, device="cpu", **kw))


def _assert_same_run(jmd, ja, md, a):
    assert [getattr(md, k) for k in COUNTERS] == [getattr(jmd, k) for k in COUNTERS]
    np.testing.assert_allclose(a.positions, ja.positions, rtol=0, atol=2e-4)
    np.testing.assert_allclose(a.velocities, ja.velocities, rtol=0, atol=2e-4)
    assert len(md.energies) == len(jmd.energies)
    np.testing.assert_allclose(md.energies, jmd.energies, rtol=1e-5)
    assert abs(md.results["energy"] - jmd.results["energy"]) <= 1e-5 * abs(
        jmd.results["energy"])
    assert abs(md.results["kinetic"] - jmd.results["kinetic"]) <= 1e-5 * abs(
        jmd.results["kinetic"])


def _run_both(P, skin, steps, md_kw=None, pot_kw=None, temperature=300.0):
    md_kw, pot_kw = md_kw or {}, pot_kw or {}
    jpot, pot = _lj_pair(P, skin, **pot_kw)
    ja, a = _lj_atoms(JAtoms, temperature), _lj_atoms(Atoms, temperature)
    jmd = JDeviceMD(jpot, ja, timestep=1.0, **md_kw)
    md = DeviceMD(pot, a, timestep=1.0, **md_kw)
    jmd.run(steps)
    md.run(steps)
    _assert_same_run(jmd, ja, md, a)
    return jmd, md, a


def test_exports():
    for name in ("DeviceMD", "EnsemblePotential"):
        assert name in calculators.__all__


def test_in_loop_refresh_matches_jax():
    """P = 1: every invalidation refreshed in the loop, one chunk, one host
    build; one flag read a step plus one a refresh."""
    jmd, md, _ = _run_both(1, 0.4, 40)
    assert md.device_rebuild and jmd.device_rebuild
    assert md.rebuilds == 1 and md.rebuilds_on_device >= 1
    assert md.host_reads == 40 + md.rebuilds_on_device
    assert md.pot.rebuild_count == 1  # the loop's refreshes bypass the potential
    # the refreshed graph went back into the skin cache at its build positions
    assert np.isfinite(md.pot._cache[2]).all()


def test_host_rebuild_stepper_at_two_partitions_matches_jax():
    jmd, md, _ = _run_both(2, 0.4, 40)
    assert not md.device_rebuild
    assert md.rebuilds >= 2 and md.rebuilds_on_device == 0


@pytest.mark.parametrize("P,md_kw", [(2, {}), (1, {"device_rebuild": False})])
def test_warm_cache_drift_budget(P, md_kw):
    """A cache warmed by calculate() at positions then drifted ~0.23 Å (near
    the 0.25 Å budget) must not double-spend the drift: the first chunk
    stops early, and the trajectory matches a cold-start host MD."""
    jpot, pot = _lj_pair(P, 0.5)
    ja, a = _lj_atoms(JAtoms, 0.0), _lj_atoms(Atoms, 0.0)
    for atoms, p in ((ja, jpot), (a, pot)):
        p.calculate(atoms)
        atoms.positions = atoms.positions + 0.23 / np.sqrt(3)
        atoms.set_maxwell_boltzmann_velocities(300.0, rng=np.random.default_rng(9))
    cold = a.copy()
    jmd = JDeviceMD(jpot, ja, timestep=1.0, **md_kw)
    md = DeviceMD(pot, a, timestep=1.0, **md_kw)
    jmd.run(20)
    md.run(20)
    _assert_same_run(jmd, ja, md, a)
    if P == 1:  # the spent cache was kept and refreshed on the device
        assert md.rebuilds == 0 and md.rebuilds_on_device >= 1
    host = MolecularDynamics(cold, DistPotential(
        PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS, num_partitions=P,
        skin=0.5, device="cpu"), ensemble="nve", timestep=1.0)
    host.run(20)
    np.testing.assert_allclose(a.positions, cold.positions, rtol=0, atol=2e-4)


def test_berendsen_small_skin_matches_jax():
    jmd, md, a = _run_both(2, 0.3, 60, md_kw=dict(temperature=300.0, taut=25.0),
                           temperature=600.0)
    assert md.rebuilds >= 1 and md.steps_done == 60
    assert a.temperature() < 650.0


def test_overflow_falls_back_and_matches_jax():
    """An in-loop cell overflow returns the uncommitted state; the host
    rebuilds and the run completes, as the JAX driver's does."""
    jmd, md, a = _run_both(1, 0.4, 40, md_kw=dict(device_rebuild=True, cell_capacity=1),
                           pot_kw=dict(device_rebuild=False))
    assert md.rebuild_overflows >= 1 and md.steps_done == 40
    _, clean = _lj_pair(1, 0.4, device_rebuild=False)
    b = _lj_atoms(Atoms)
    DeviceMD(clean, b, timestep=1.0).run(40)
    np.testing.assert_allclose(a.positions, b.positions, rtol=0, atol=2e-3)


def test_stall_guard_and_refusals():
    _, pot = _lj_pair(1, 0.0)
    with pytest.raises(ValueError, match="skin > 0"):
        DeviceMD(pot, _lj_atoms(Atoms))
    _, pot = _lj_pair(1, 0.4)
    with pytest.raises(NotImplementedError, match="A12"):
        DeviceMD(pot, _lj_atoms(Atoms), telemetry=object())
    with pytest.raises(TypeError, match="device_rebuild"):
        DeviceMD(pot, _lj_atoms(Atoms), device_rebuild="yes")
    assert DeviceMD(pot, _lj_atoms(Atoms)).device_rebuild
    assert not DeviceMD(pot, _lj_atoms(Atoms), device_rebuild=False).device_rebuild
    _, off = _lj_pair(1, 0.4, device_rebuild=False)
    assert not DeviceMD(off, _lj_atoms(Atoms)).device_rebuild
    assert DeviceMD(off, _lj_atoms(Atoms), device_rebuild=True).device_rebuild
    # one dt past skin/2 on a fresh build cannot progress
    _, tight = _lj_pair(2, 0.01)
    a = _lj_atoms(Atoms, 3000.0)
    with pytest.raises(RuntimeError, match="increase skin"):
        DeviceMD(tight, a, timestep=5.0).run(3)
    md = DeviceMD(pot, _lj_atoms(Atoms))
    md.run(0)
    assert md.steps_done == 0 and md.energies == []


def test_mark_cache_stale_keeps_the_graph_only_where_the_refresh_serves():
    atoms = _lj_atoms(Atoms)
    _, pot = _lj_pair(1, 0.4)
    pot._mark_cache_stale()  # no cache: a no-op
    assert pot._cache is None
    pot.calculate(atoms)
    graph = pot._cache[0]
    pot._mark_cache_stale()
    assert pot._cache[0] is graph and np.isinf(pot._cache[2]).all()
    ref = DistPotential(PairPotential(PairConfig(cutoff=3.0, kind="lj")), LJ_PARAMS,
                        device="cpu").calculate(atoms)
    res = pot.calculate(atoms)
    assert pot.rebuild_on_device_count == 1 and pot.rebuild_count == 2
    assert np.array_equal(pot._cache[2], atoms.positions)
    assert abs(res["energy"] - ref["energy"]) <= 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=1e-5)
    for P, kw in ((2, {}), (1, {"device_rebuild": False})):
        _, other = _lj_pair(P, 0.4, **kw)
        other.calculate(atoms)
        other._mark_cache_stale()
        assert other._cache is None


MACE_CFG = dict(num_species=4, channels=8, l_max=1, a_lmax=1, hidden_lmax=1, correlation=2,
                num_interactions=2, num_bessel=4, radial_mlp=8, cutoff=3.0,
                avg_num_neighbors=12.0, edge_chunk=0)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def test_mace_device_md_matches_jax():
    """10 steps of a small MACE on 32 light atoms (Li, 1000 K) at skin 0.3:
    the in-loop refresh fires; the port against the JAX DeviceMD."""
    cart, lat, spec = make_crystal(np.random.default_rng(1), reps=(2, 2, 2), a=3.5,
                                   noise=0.05, n_species=3)
    # the port's init as numpy: its layout is the JAX model's, and the JAX
    # init of MACE costs ~10 s here
    params = _numpy(MACE(MACEConfig(**MACE_CFG)).init(0))
    runs = []
    for cls, pot in ((JAtoms, JDistPotential(JMACE(JMACEConfig(**MACE_CFG)), params,
                                             num_partitions=1, skin=0.3, kernels=False)),
                     (Atoms, DistPotential(MACE(MACEConfig(**MACE_CFG)), params,
                                           device="cpu", skin=0.3))):
        atoms = cls(numbers=spec + 1, positions=cart.copy(), cell=lat,
                    masses=np.full(len(cart), 6.94))
        atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(3))
        md = (JDeviceMD if cls is JAtoms else DeviceMD)(pot, atoms, timestep=1.0)
        md.run(10)
        runs.append((md, atoms))
    (jmd, ja), (md, a) = runs
    assert md.rebuilds_on_device >= 1
    _assert_same_run(jmd, ja, md, a)
