"""Slab graph parallelism end to end: ``DistPotential(num_partitions=P)``,
JAX vs port, TensorNet and CHGNet (bond and line graphs, magmoms).

The structure is a long rattled fcc cell (a = 3.5 Å, 1 x 2 x 8 cells, 64
atoms, 28 Å along the slab axis), so P = 2, 3 and 4 slabs are all wider
than twice the 3.0 Å cutoff. JAX side: ``distmlip_tpu.calculators.
DistPotential(num_partitions=P, kernels=False)``, its partitions on the
8-virtual-device CPU mesh (``tests/conftest.py``), with its own initialised
parameters (reference energies off their defaults, so a dropped term
shows).
Port side: ``DistPotential(num_partitions=P, device="cpu")``, the P
partitions as one flattened graph, with those parameters; it is also held
against itself at P = 1. Forces on border atoms (those a partition sends
to a peer) are checked apart: they are the ones whose halo share comes back
through the exchange. Both sides compute in float32 and sum in different
orders: rel dE < 1e-5, max |dF| < 1e-4 eV/Å, max |dS| < 1e-4 eV/Å^3, max
|dm| < 1e-4. Last, 5 ``nvt_langevin`` steps at P = 2 equal P = 1 within
the same bar, skin-cache invalidations rebuilt on the host (the JAX
package's rule at P > 1).

``tests/test_torch_parallel_mace.py`` and ``test_torch_parallel_escn.py``
run the same checks for MACE and eSCN through the helpers here.
"""

import jax
import numpy as np
import pytest

from distmlip_tpu import models as jmodels
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu_torch import geometry, models
from distmlip_tpu_torch.calculators import Atoms, DistPotential, MolecularDynamics
from distmlip_tpu_torch.neighbors import neighbor_list
from distmlip_tpu_torch.partition import build_plan
from tests.torch_threads import one_intra_op_thread  # noqa: F401

# family -> (model class name, config, potential keywords, atoms.info)
FAMILIES = {
    "tensornet": ("TensorNet", dict(num_species=4, units=16, num_rbf=8, num_layers=2,
                                    cutoff=3.0), {}, {}),
    "chgnet": ("CHGNet", dict(num_species=4, units=16, num_rbf=6, num_angle=4, num_blocks=3,
                              cutoff=3.0, bond_cutoff=2.6), {"compute_magmom": True}, {}),
    "mace": ("MACE", dict(num_species=4, channels=8, l_max=2, a_lmax=2, hidden_lmax=1,
                          correlation=2, num_interactions=2, cutoff=3.0, edge_chunk=128),
             {}, {}),
    "escn": ("ESCN", dict(num_species=4, channels=8, l_max=2, num_layers=2, num_bessel=6,
                          num_experts=4, cutoff=3.0, avg_num_neighbors=12.0,
                          edge_chunk=128), {}, {"charge": 1, "spin": 2, "dataset": 1}),
}


def structure(seed=1):
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (1, 2, 8))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.08, (len(frac), 3))
    return cart, lat, rng.integers(0, 4, len(cart)).astype(np.int32)


def _model(family, jax_side):
    name, cfg, _, _ = FAMILIES[family]
    pkg = jmodels if jax_side else models
    return getattr(pkg, name)(getattr(pkg, name + "Config")(**cfg))


def jax_params(family):
    params = jax.tree.map(np.array, _model(family, True).init(jax.random.PRNGKey(0)))
    # reference energies off their defaults and negative, as trained ones
    # are: a total that cancels to a fraction of an eV over 64 atoms would
    # make the relative bar a test of summation order alone
    rng = np.random.default_rng(7)
    ref = params["species_ref"]["w"]
    params["species_ref"]["w"] = (-1.0 - rng.random(ref.shape)).astype(ref.dtype)
    return params


def jax_calculate(family, params, P, struct):
    cart, lat, spec = struct
    _, _, kw, info = FAMILIES[family]
    pot = JDistPotential(_model(family, True), params, num_partitions=P, kernels=False, **kw)
    return pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat, info=dict(info)))


def port_calculate(family, params, P, struct):
    cart, lat, spec = struct
    _, _, kw, info = FAMILIES[family]
    pot = DistPotential(_model(family, False), params, num_partitions=P, device="cpu", **kw)
    res = pot.calculate(Atoms(numbers=spec, positions=cart.copy(), cell=lat, info=dict(info)))
    assert pot.last_stats["num_partitions"] == P
    if P > 1:
        assert pot.last_stats["e_split"] < pot.last_stats["e_cap"]  # split layout
        assert min(pot.last_stats["halo_per_part"]) > 0
    return res


def border_atoms(family, P, struct):
    """Atoms a partition sends to a peer (the port's plan at the cutoff)."""
    cart, lat, _ = struct
    r = FAMILIES[family][1]["cutoff"]
    plan = build_plan(neighbor_list(cart, lat, [1, 1, 1], r), lat, [1, 1, 1], P, r)
    border = np.nonzero(plan.nodes_to_partition >= 0)[0]
    assert 0 < len(border) < len(cart)
    return border


def assert_close(res, ref, border):
    """The repo's float32 bar; forces on border atoms apart."""
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 5e-3  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"][border], ref["forces"][border], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=1e-4)
    if "magmoms" in ref:
        np.testing.assert_allclose(res["magmoms"], ref["magmoms"], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def cases():
    """Per family: the parameters and the port's P = 1 result, made once."""
    struct = structure()
    out = {}

    def get(family):
        if family not in out:
            params = jax_params(family)
            out[family] = (params, port_calculate(family, params, 1, struct))
        return out[family]

    return struct, get


def check_family_at(cases, family, P):
    struct, get = cases
    params, p1 = get(family)
    ref = jax_calculate(family, params, P, struct)
    res = port_calculate(family, params, P, struct)
    border = border_atoms(family, P, struct)
    assert_close(res, ref, border)
    assert_close(res, p1, border)
    if "magmoms" in ref:
        assert np.abs(ref["magmoms"]).max() > 1e-3


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("family", ["tensornet", "chgnet"])
def test_parallel_matches_jax_and_p1(cases, family, P):
    check_family_at(cases, family, P)


def test_md_at_p2_equals_p1():
    """5 ``nvt_langevin`` steps of TensorNet on light atoms (H, He, Li at
    1000 K, skin 0.5 Å): positions and energies at P = 2 equal P = 1; the
    skin invalidations at P = 2 are rebuilt on the host, in the step
    (``async_rebuild=False``: an adopted background build has part of its
    skin budget spent, so it invalidates at other steps than P = 1's
    refreshes; tests/test_torch_prefetch.py holds that path)."""
    cart, lat, _ = structure()
    numbers = np.random.default_rng(2).integers(1, 4, len(cart))
    params = _model("tensornet", False).init(0)
    out = {}
    for P in (1, 2):
        atoms = Atoms(numbers=numbers, positions=cart.copy(), cell=lat)
        atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(3))
        pot = DistPotential(_model("tensornet", False), params, num_partitions=P,
                            device="cpu", skin=0.5, async_rebuild=False)
        energies = []

        class Record:
            def record(self, results):
                energies.append(results["energy"])

        MolecularDynamics(atoms, pot, trajectory=Record(), ensemble="nvt_langevin",
                          timestep=2.0, temperature=1000.0, seed=0).run(5)
        out[P] = (atoms.positions.copy(), np.array(energies), pot)
    (x1, e1, pot1), (x2, e2, pot2) = out[1], out[2]
    assert pot2.rebuild_count > 1 and pot2.rebuild_on_device_count == 0
    assert pot1.rebuild_count == pot2.rebuild_count  # the same invalidations
    np.testing.assert_allclose(x2, x1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(e2, e1, rtol=1e-5, atol=0)
