"""The slice end to end: MACE through ``DistPotential`` at P=1, JAX vs port.

A small MACE (channels 16, l_max = a_lmax = 3, hidden_lmax 1,
correlation 3, 2 interactions) with ``edge_chunk=64`` and ``node_chunk=16``
so that several edge and node chunks run, on a 32-atom perturbed crystal.
JAX side: ``distmlip_tpu.calculators.DistPotential(num_partitions=1,
kernels=False)`` with its own initialised parameters. Port side:
``DistPotential(device="cpu")`` with those parameters carried across by
``params_from_numpy`` and, once more, through ``save_params`` ->
``load_params``.

Tolerances: both sides compute in float32 with the same arithmetic but sum
in different orders (XLA's fused reductions vs PyTorch's kernels). Energy
is a sum of ~32 site energies, so rel < 1e-5; forces and stress are
gradients through two interactions of O(1) magnitude, so max abs < 1e-4.
"""

import jax
import numpy as np
import pytest

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import MACE as JMACE
from distmlip_tpu.models import MACEConfig as JMACEConfig
from distmlip_tpu.utils.checkpoint import save_params
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import MACE, MACEConfig
from distmlip_tpu_torch.utils import load_params, params_from_numpy
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(num_species=4, channels=16, l_max=3, a_lmax=3, hidden_lmax=1,
           correlation=3, num_interactions=2, num_bessel=6, radial_mlp=16,
           cutoff=4.0, avg_num_neighbors=12.0, edge_chunk=64, node_chunk=16)


def _structure(seed=1):
    cart, lat, spec = make_crystal(np.random.default_rng(seed), reps=(2, 2, 2), a=4.0,
                                   n_species=3)
    return cart, lat, spec


def _jax_params(cfg_kw):
    """The JAX model's own initialised parameters as writable numpy arrays,
    with the correlation-3 weights amplified so the cubic term is well above
    float32 resolution and the comparison exercises it."""
    params = jax.tree.map(np.array, JMACE(JMACEConfig(**cfg_kw)).init(
        jax.random.PRNGKey(0)))
    for inter in params["interactions"]:
        for wts in inter["product"].values():
            wts["w3"] *= 10.0
    return params


def _jax_calculate(cfg_kw, params, cart, lat, spec):
    pot = JDistPotential(JMACE(JMACEConfig(**cfg_kw)), params, num_partitions=1,
                         kernels=False)
    return pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat))


@pytest.fixture(scope="module")
def jax_case():
    cart, lat, spec = _structure()
    params = _jax_params(CFG)
    return (cart, lat, spec), params, _jax_calculate(CFG, params, cart, lat, spec)


def _assert_close(res, ref):
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 1e-2  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], atol=1e-4)
    np.testing.assert_allclose(res["stress_GPa"], ref["stress_GPa"], atol=1e-4 * 160.3)


def test_mace_matches_jax_params_from_numpy(jax_case):
    (cart, lat, spec), params, ref = jax_case
    pot = DistPotential(MACE(MACEConfig(**CFG)), params_from_numpy(params),
                        device="cpu")
    res = pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat))
    _assert_close(res, ref)
    assert res["free_energy"] == res["energy"]
    assert res["forces"].shape == (len(cart), 3)


def test_mace_matches_jax_through_checkpoint(jax_case, tmp_path):
    (cart, lat, spec), params, ref = jax_case
    path = str(tmp_path / "mace.npz")
    save_params(path, params)
    pot = DistPotential(MACE(MACEConfig(**CFG)), load_params(path), device="cpu",
                        kernels=False)
    _assert_close(pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat)), ref)
    # a checkpoint from another layout era is refused
    data = dict(np.load(path))
    data["__distmlip_layout_version__"] = np.int64(1)
    np.savez(str(tmp_path / "old.npz"), **data)
    with pytest.raises(ValueError, match="layout version 1"):
        load_params(str(tmp_path / "old.npz"))


def test_skin_cache_reuses_graph_and_stays_exact(jax_case):
    """3 small moves after the first call reuse the graph (no rebuild) and
    give the same numbers as a fresh build at each step; a large move
    rebuilds."""
    (cart, lat, spec), params, _ = jax_case
    model = MACE(MACEConfig(**CFG))
    cached = DistPotential(model, params, device="cpu", skin=0.5)
    fresh = DistPotential(model, params, device="cpu", skin=0.0)
    rng = np.random.default_rng(7)
    atoms = Atoms(numbers=spec, positions=cart.copy(), cell=lat)
    cached.calculate(atoms)
    assert cached.rebuild_count == 1
    for _ in range(3):
        atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        a, b = cached.calculate(atoms), fresh.calculate(atoms)
        assert abs(a["energy"] - b["energy"]) < 1e-5 * abs(b["energy"])
        np.testing.assert_allclose(a["forces"], b["forces"], atol=1e-4)
        np.testing.assert_allclose(a["stress"], b["stress"], atol=1e-4)
    assert cached.rebuild_count == 1
    atoms.positions[0] += 0.4  # past skin/2
    cached.calculate(atoms)
    assert cached.rebuild_count == 2


def test_multi_head_selects_head_one():
    cart, lat, spec = _structure(seed=2)
    kw = dict(CFG, num_heads=2, head=1)
    pnp = _jax_params(kw)
    # distinct per-head E0s/scale/shift so selecting the wrong head shows
    pnp["species_ref"]["w"][1] = np.array([0.5, -1.0, 2.0, 0.3], np.float32)
    pnp["scale"][1], pnp["shift"][1] = 1.7, -0.4
    ref = _jax_calculate(kw, pnp, cart, lat, spec)
    pot = DistPotential(MACE(MACEConfig(**kw)), pnp, device="cpu")
    _assert_close(pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat)), ref)
    head0 = DistPotential(MACE(MACEConfig(**dict(kw, head=0))), pnp, device="cpu")
    e0 = head0.calculate(Atoms(numbers=spec, positions=cart, cell=lat))["energy"]
    assert abs(e0 - ref["energy"]) > 1e-2
