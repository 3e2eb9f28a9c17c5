"""The batched engine: the port's packing, runtime, calculator and drivers
against the JAX package's.

- ``BucketPolicy`` / ``FixedCaps``: rung for rung and byte estimate for byte
  estimate (pure Python on both sides).
- ``pack_structures``: array for array (both packs search with their
  native FPIS, one C++ source, so edges come in one order), with and without
  CHGNet's bond and line graphs, on a batch with a 1-atom structure that
  has no edge and an empty padded slot (3 structures in 4 slots).
- The sentinel slot: padded node rows carry ``struct_id == batch_size``;
  ``structure_sum`` and the batched runtime drop them and leave the empty
  slot at 0 (energy and strain gradient).
- ``BatchedPotential`` against the JAX ``BatchedPotential`` (``kernels=
  False``) for the pair model, a small TensorNet and eSCN's batched MOLE
  gate; MACE and CHGNet (magmoms) against the port's own ``DistPotential``
  per structure, which the earlier slices hold against the JAX package.
- The skin cache and the packed device refresh against a host repack, the
  packed search element for element against the JAX one, and the overflow
  path.
- ``BatchedRelaxer`` and ``BatchedMD`` step for step against the JAX drivers
  on the pair model.

The learned families' weights are the port's ``init(0)``, carried to the
JAX side as numpy (the two packages share the parameter tree layout).

Tolerances: float32 on both sides with sums in different orders, so rel dE
< 1e-5, max |dF| and max |dS| < 1e-4 (eV/Å, eV/Å^3), max |dm| < 1e-4;
positions after the driver steps within 1e-5 Å.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import BatchedMD as JBatchedMD
from distmlip_tpu.calculators import BatchedPotential as JBatchedPotential
from distmlip_tpu.calculators import BatchedRelaxer as JBatchedRelaxer
from distmlip_tpu.models import ESCN as JESCN
from distmlip_tpu.models import ESCNConfig as JESCNConfig
from distmlip_tpu.models import PairConfig as JPairConfig
from distmlip_tpu.models import PairPotential as JPairPotential
from distmlip_tpu.models import TensorNet as JTensorNet
from distmlip_tpu.models import TensorNetConfig as JTensorNetConfig
from distmlip_tpu.neighbors.device import build_packed_spec as jax_packed_spec
from distmlip_tpu.neighbors.device import device_packed_neighbor_list as jax_packed_nl
from distmlip_tpu.partition import BucketPolicy as JBucketPolicy
from distmlip_tpu.partition import fixed_caps_for_batches as jax_fixed_caps
from distmlip_tpu.partition import geometric_bucket as jax_geometric_bucket
from distmlip_tpu.partition import pack_structures as jax_pack
from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.calculators import (Atoms, BatchedMD, BatchedPotential,
                                            BatchedRelaxer, DistPotential)
from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                       MACEConfig, PairConfig, PairPotential, TensorNet,
                                       TensorNetConfig)
from distmlip_tpu_torch.neighbors.device import (build_packed_spec,
                                                 device_packed_neighbor_list)
from distmlip_tpu_torch.parallel import local_graph_from_stacked, make_batched_potential_fn
from distmlip_tpu_torch.partition import (BucketPolicy, FixedCaps, fixed_caps_for_batches,
                                          geometric_bucket, pack_structures)
from distmlip_tpu_torch.partition.graph import ARRAY_FIELDS
from distmlip_tpu_torch.utils import params_from_numpy

PAIR_CUTOFF = 4.0
TN_CFG = dict(num_species=4, units=16, num_rbf=8, num_layers=2, cutoff=4.0)
ESCN_CFG = dict(num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6,
                num_experts=4, cutoff=3.2, avg_num_neighbors=12.0)
CHG_CFG = dict(num_species=4, units=16, num_rbf=6, num_angle=4, num_blocks=3, cutoff=3.2,
               bond_cutoff=2.6)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This module's tensors are tiny: one intra-op thread avoids
    oversubscribing the CPU when test files run in parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fcc(rng, reps, a=3.5, noise=0.05, numbers=None):
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * a, reps)
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, noise, (len(frac), 3))
    z = (rng.integers(1, 4, len(cart)) if numbers is None
         else np.full(len(cart), numbers))
    return cart, lattice, z


def _mixed(seed=0, a=3.5, noise=0.05, numbers=None, triclinic=True):
    """3 structures (4 slots, one empty): an fcc cell, a 1-atom structure
    with no edge (12 Å box) and a 16-atom triclinic-sheared supercell."""
    rng = np.random.default_rng(seed)
    s0 = _fcc(rng, (1, 1, 1), a, noise, numbers)
    cart, lat, z = _fcc(rng, (2, 2, 1), a, noise, numbers)
    if triclinic:
        shear = np.eye(3)
        shear[1, 0] = 0.15
        cart, lat = cart @ shear, lat @ shear
    one = (np.array([[0.3, 0.2, 0.1]]), np.eye(3) * 12.0,
           np.array([2 if numbers is None else numbers]))
    return [s0, one, (cart, lat, z)]


def _port_atoms(structs):
    return [Atoms(numbers=z, positions=c.copy(), cell=l) for c, l, z in structs]


def _jax_atoms(structs):
    return [JAtoms(numbers=z, positions=c.copy(), cell=l) for c, l, z in structs]


def _assert_results(res, refs, magmoms=False):
    assert len(res) == len(refs)
    for r, ref in zip(res, refs):
        assert abs(r["energy"] - ref["energy"]) <= 1e-5 * max(abs(ref["energy"]), 1e-6)
        np.testing.assert_allclose(r["forces"], ref["forces"], atol=1e-4)
        np.testing.assert_allclose(r["stress"], ref["stress"], atol=1e-4)
        if magmoms:
            np.testing.assert_allclose(r["magmoms"], ref["magmoms"], atol=1e-4)


# ---------------------------------------------------------------------------
# BucketPolicy / FixedCaps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("growth", [2.0 ** 0.5, 1.25, 2.0])
def test_bucket_policy_rungs_match_jax(growth):
    sizes = list(range(0, 3000, 7)) + [128, 129, 181, 256, 362, 512, 10 ** 5]
    for base, multiple in ((128, 128), (1, 1), (32, 8)):
        port, jpol = BucketPolicy(base, growth, multiple), JBucketPolicy(base, growth, multiple)
        assert [geometric_bucket(n, base, growth, multiple) for n in sizes] == \
            [jax_geometric_bucket(n, base, growth, multiple) for n in sizes]
        assert [port.get("nodes", n) for n in sizes] == [jpol.get("nodes", n) for n in sizes]
        assert [port.get_small(n) for n in range(1, 40)] == \
            [jpol.get_small(n) for n in range(1, 40)]
        for lo, hi, mb in ((1, 100, 8), (30, 5000, 4), (200, 200, 1)):
            assert port.max_rungs(lo, hi) == jpol.max_rungs(lo, hi)
            assert port.ladder_bound(lo, hi, mb) == jpol.ladder_bound(lo, hi, mb)
        # the bytes model: none, one, then several measured rungs
        assert port.estimate_batch_bytes(50) is None is jpol.estimate_batch_bytes(50)
        for cap, peak in ((256, 10 ** 6), (1024, 3 * 10 ** 6), (256, 2 * 10 ** 6)):
            port.calibrate_bytes(cap, peak)
            jpol.calibrate_bytes(cap, peak)
            for n in (1, 100, 300, 900, 2000, 9000):
                assert port.estimate_batch_bytes(n) == jpol.estimate_batch_bytes(n)
                assert port.has_calibrated_rung(n) == jpol.has_calibrated_rung(n)


def test_fixed_caps_match_jax():
    rng = np.random.default_rng(5)
    needs = [{"nodes": int(n), "edges": int(40 * n), "bonds": int(3 * n)}
             for n in rng.integers(1, 300, 40)]
    for b in (1, 3, 8):
        assert fixed_caps_for_batches(needs, b).as_dict() == \
            jax_fixed_caps(needs, b).as_dict()
    caps = FixedCaps({"nodes": 128})
    assert caps.get("nodes", 100) == 128
    with pytest.raises(ValueError, match="cannot hold"):
        caps.get("nodes", 129)
    with pytest.raises(KeyError):
        caps.get("edges", 1)
    assert FixedCaps({}, fallback=BucketPolicy()).get("edges", 300) == 384


# ---------------------------------------------------------------------------
# pack_structures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bond_graph", [False, True], ids=["plain", "bond_graph"])
def test_pack_structures_matches_jax(bond_graph):
    # both packs search with their native FPIS, which order edges alike
    structs = _mixed(1, noise=0.1)
    kw = dict(cutoff=3.2, bond_cutoff=2.6 if bond_graph else 0.0,
              use_bond_graph=bond_graph, skin=0.5)
    g, h = pack_structures(_port_atoms(structs), caps=BucketPolicy(), **kw)
    jg, jh = jax_pack(_jax_atoms(structs), caps=JBucketPolicy(), **kw)
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(g, name), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    for k in ("charge", "spin", "dataset"):
        assert int(g.system[k]) == int(jg.system[k])
    for name in ("n_cap", "e_cap", "e_split", "b_cap", "batch_size", "has_bond_graph"):
        assert getattr(g, name) == getattr(jg, name), name
    for name in ("node_offsets", "n_atoms", "volumes"):
        np.testing.assert_array_equal(getattr(h, name), getattr(jh, name))
    stats = dict(jh.stats)
    stats.pop("halo_send_per_part", None)
    assert h.stats == stats
    # the batch: 3 structures in 4 slots, the 1-atom one without an edge
    assert g.batch_size == 4 and int((g.struct_id == 4).sum()) == g.n_cap - h.n_atoms.sum()
    assert not np.any(g.edge_mask[0] & (g.edge_dst[0] == h.node_offsets[1]))
    if bond_graph:
        assert g.bond_map_mask.sum() > 0 and g.line_mask.sum() > 0


def test_pack_rejects_conflicts_and_mesh():
    atoms = _port_atoms(_mixed(2))
    atoms[0].info["charge"] = 1
    with pytest.raises(ValueError, match="conflicting"):
        pack_structures(atoms, 3.2)
    pack_structures(atoms, 3.2, system={"charge": 1, "spin": 0, "dataset": 0})
    with pytest.raises(NotImplementedError, match="A7"):
        pack_structures(atoms, 3.2, spatial_parts=2, system={"charge": 1})
    with pytest.raises(NotImplementedError, match="A7"):
        make_batched_potential_fn(PairPotential().energy_fn, mesh=object())


def test_sentinel_slot_is_dropped():
    """Padded rows (struct_id == batch_size) and the empty slot: the sums
    over them must neither index past the slots nor leak into a slot."""
    atoms = _port_atoms(_mixed(3))
    graph, host = pack_structures(atoms, PAIR_CUTOFF, caps=BucketPolicy())
    g = graph.to("cpu")
    assert int(g.struct_id.max()) == g.batch_size == 4
    lg = local_graph_from_stacked(g, kernels=False)
    ones = torch.ones(g.n_cap, dtype=torch.float64)
    np.testing.assert_array_equal(lg.structure_sum(ones).numpy(), [4, 1, 16, 0])
    model = PairPotential(PairConfig(cutoff=PAIR_CUTOFF))
    pos = torch.as_tensor(host.scatter_positions([a.positions for a in atoms]))
    out = make_batched_potential_fn(model.energy_fn, kernels=False)(
        params_from_numpy(model.init()), g, pos)
    assert out["energies"].shape == (4,) and out["strain_grad"].shape == (4, 3, 3)
    assert out["energies"][1] == 0 and out["energies"][3] == 0  # no edge; empty slot
    assert torch.all(out["strain_grad"][3] == 0) and torch.all(out["strain_grad"][1] == 0)
    assert torch.all(out["forces"][0, int(host.n_atoms.sum()):] == 0)
    assert torch.isfinite(out["forces"]).all()


# ---------------------------------------------------------------------------
# BatchedPotential against the JAX package and against DistPotential
# ---------------------------------------------------------------------------


def _numpy_tree(params):
    """The port's parameters (the JAX package's tree layout) as numpy, for
    the JAX side: the same weights without a JAX init."""
    return jax.tree.map(lambda x: x.numpy(), params)


@pytest.mark.parametrize("family", ["pair", "tensornet"])
def test_batched_potential_matches_jax(family):
    structs = _mixed(4, numbers=None if family == "tensornet" else 14)
    if family == "pair":
        jmodel = JPairPotential(JPairConfig(cutoff=PAIR_CUTOFF))
        jparams, model = jmodel.init(), PairPotential(PairConfig(cutoff=PAIR_CUTOFF))
    else:
        jmodel, model = JTensorNet(JTensorNetConfig(**TN_CFG)), TensorNet(TensorNetConfig(**TN_CFG))
        jparams = _numpy_tree(model.init(0))
    refs = JBatchedPotential(jmodel, jparams, kernels=False).calculate(_jax_atoms(structs))
    pot = BatchedPotential(model, params_from_numpy(jax.tree.map(np.asarray, jparams)),
                           device="cpu")
    res = pot.calculate(_port_atoms(structs))
    _assert_results(res, refs)
    assert np.abs(refs[2]["forces"]).max() > 1e-2  # non-degeneracy
    assert res[1]["energy"] == pytest.approx(refs[1]["energy"], abs=1e-6)
    assert pot.compile_count == 1 and pot.last_stats["batch_slots"] == 4
    assert pot.hbm_budget_bytes is None  # no budget on the CPU


def test_escn_batched_gate_matches_jax():
    """Per-structure MOLE gates: the same structure alone and in a batch
    with a different composition must give the same energy, and the batch
    must match the JAX package's batched gate."""
    rng = np.random.default_rng(6)
    structs = [_fcc(rng, (1, 1, 2), 3.5, 0.1, numbers=1),
               _fcc(rng, (1, 1, 1), 3.5, 0.1),
               _fcc(rng, (2, 1, 1), 3.5, 0.1, numbers=3)]
    model = ESCN(ESCNConfig(**ESCN_CFG))
    params = model.init(0)
    refs = JBatchedPotential(JESCN(JESCNConfig(**ESCN_CFG)), _numpy_tree(params),
                             kernels=False).calculate(_jax_atoms(structs))
    res = BatchedPotential(model, params, device="cpu").calculate(_port_atoms(structs))
    _assert_results(res, refs)
    single = DistPotential(model, params, device="cpu")
    _assert_results(res, [single.calculate(a) for a in _port_atoms(structs)])


@pytest.mark.parametrize("family", ["mace", "chgnet"])
def test_batched_matches_dist_potential(family):
    structs = _port_atoms(_mixed(7, noise=0.1))
    if family == "mace":
        model = MACE(MACEConfig(num_species=4, channels=8, l_max=2, a_lmax=2, hidden_lmax=1,
                                correlation=2, cutoff=3.2, edge_chunk=64, node_chunk=16))
        kw = {}
    else:
        model, kw = CHGNet(CHGNetConfig(**CHG_CFG)), {"compute_magmom": True}
    params = model.init(0)
    res = BatchedPotential(model, params, device="cpu", skin=0.5, **kw).calculate(structs)
    single = DistPotential(model, params, device="cpu", skin=0.5, **kw)
    _assert_results(res, [single.calculate(a) for a in structs], magmoms=bool(kw))
    if family == "chgnet":
        assert all(r["magmoms"].shape == (len(a),) for r, a in zip(res, structs))


def test_unported_options_raise():
    model = PairPotential()
    with pytest.raises(NotImplementedError, match="A7"):
        BatchedPotential(model, model.init(), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        BatchedPotential(model, model.init(), device="cpu", telemetry=object())
    with pytest.raises(ValueError, match="energy_and_aux_fn"):
        BatchedPotential(model, model.init(), device="cpu", compute_magmom=True)
    atoms = _port_atoms(_mixed(8))
    atoms[0].info["charge"] = 1
    with pytest.raises(ValueError, match="conflicting"):
        BatchedPotential(model, model.init(), device="cpu").calculate(atoms)


# ---------------------------------------------------------------------------
# skin cache and the packed device refresh
# ---------------------------------------------------------------------------


def test_packed_search_matches_jax():
    atoms = _port_atoms(_mixed(9, noise=0.2))
    graph, host = pack_structures(atoms, 3.2, skin=0.5, caps=BucketPolicy())
    args = (host.cells, host.pbcs, host.n_atoms, host.node_offsets, 3.7, graph.n_cap,
            graph.e_cap)
    static, arrays = build_packed_spec(*args)
    jstatic, jarrays = jax_packed_spec(*args)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    pos = host.scatter_positions([a.positions for a in atoms])[0]
    src, dst, off, n, ovf = device_packed_neighbor_list(static, arrays, pos)
    jsrc, jdst, joff, jn, jovf = jax_packed_nl(jstatic, jarrays, pos)
    n = int(n)
    assert n == int(jn) == int(graph.edge_mask.sum()) and not bool(ovf) and not bool(jovf)
    np.testing.assert_array_equal(src.numpy()[:n], np.asarray(jsrc)[:n])
    np.testing.assert_array_equal(dst.numpy()[:n], np.asarray(jdst)[:n])
    np.testing.assert_allclose(off.numpy()[:n], np.asarray(joff)[:n], atol=1e-5)
    assert np.all(np.diff(dst.numpy()[:n]) >= 0)


def test_skin_cache_and_device_refresh_match_host_repack():
    model = PairPotential(PairConfig(cutoff=PAIR_CUTOFF))
    params = model.init()
    structs = _port_atoms(_mixed(10, numbers=14))
    pot = BatchedPotential(model, params, device="cpu", skin=0.5)
    pot.calculate(structs)
    for a in structs:  # inside skin/2: a cache hit
        a.positions += 0.05
    pot.calculate(structs)
    assert (pot.rebuild_count, pot.rebuild_on_device_count) == (1, 0)
    rng = np.random.default_rng(0)
    for a in structs:  # past skin/2: the structure list is the same
        a.positions += rng.normal(0, 0.2, a.positions.shape)
    res = pot.calculate(structs)
    assert (pot.rebuild_count, pot.rebuild_on_device_count) == (2, 1)
    assert "rebuild_s" in pot.last_timings and pot.last_stats["rebuild_on_device"] == 1
    fresh = BatchedPotential(model, params, device="cpu").calculate(structs)
    _assert_results(res, fresh)
    # a tight edge ladder (e_cap within 0.1% of the edges): a move that adds
    # pairs overflows the refresh and the host repacks
    structs = _port_atoms(_mixed(10, numbers=14))
    ladder = BucketPolicy(base=1, growth=1.001, multiple=1)
    tight = BatchedPotential(model, params, device="cpu", skin=0.5, caps=ladder)
    tight.calculate(structs)
    e_cap = tight.last_stats["e_cap"]
    structs[2].positions *= 0.95  # moves up to 0.40 Å, past skin/2
    assert int(pack_structures(structs, PAIR_CUTOFF, skin=0.5)[0].edge_mask.sum()) > e_cap
    res = tight.calculate(structs)
    assert tight.rebuild_overflow_count == 1 and tight.rebuild_on_device_count == 0
    assert tight.rebuild_count == 2
    _assert_results(res, BatchedPotential(model, params, device="cpu").calculate(structs))
    # a different structure list repacks on the host
    tight.calculate(structs[:2])
    assert tight.rebuild_count == 3 and tight.rebuild_on_device_count == 0


def test_skin_cache_keys_on_the_conditioning_scalars():
    """A changed charge/spin/dataset in ``atoms.info`` is a different
    structure list: the pack (which bakes the system dict in) is rebuilt on
    the host, on a cache hit and past skin/2 alike, and equals a fresh pack."""
    model = ESCN(ESCNConfig(**ESCN_CFG))
    params = model.init(0)
    structs = _port_atoms(_mixed(11))
    pot = BatchedPotential(model, params, device="cpu", skin=0.5)
    first = pot.calculate(structs)
    for a in structs:  # same geometry, another charge
        a.info["charge"] = 2
    res = pot.calculate(structs)
    assert (pot.rebuild_count, pot.rebuild_on_device_count) == (2, 0)
    assert abs(res[0]["energy"] - first[0]["energy"]) > 1e-3
    _assert_results(res, BatchedPotential(model, params, device="cpu").calculate(structs))
    rng = np.random.default_rng(1)
    for a in structs:  # past skin/2 with another spin: no device refresh
        a.positions += rng.normal(0, 0.2, a.positions.shape)
        a.info["spin"] = 3
    res = pot.calculate(structs)
    assert (pot.rebuild_count, pot.rebuild_on_device_count) == (3, 0)
    _assert_results(res, BatchedPotential(model, params, device="cpu").calculate(structs))


def test_device_rebuild_true_refuses_a_bond_graph():
    model = CHGNet(CHGNetConfig(**CHG_CFG))
    with pytest.raises(ValueError, match="bond graph"):
        BatchedPotential(model, model.init(0), device="cpu", skin=0.5, device_rebuild=True)
    for ok in ("auto", False):
        pot = BatchedPotential(model, model.init(0), device="cpu", skin=0.5,
                               device_rebuild=ok)
        assert not pot._device_refresh_eligible()


# ---------------------------------------------------------------------------
# drivers, step for step against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_pots():
    """One JAX potential for the module (its compiled buckets are reused:
    it keeps no skin cache) and a fresh port potential per driver."""
    jmodel = JPairPotential(JPairConfig(cutoff=PAIR_CUTOFF))
    jparams = jmodel.init()
    jpot = JBatchedPotential(jmodel, jparams, kernels=False)
    return (lambda: jpot,
            lambda: BatchedPotential(PairPotential(PairConfig(cutoff=PAIR_CUTOFF)),
                                     params_from_numpy(jax.tree.map(np.asarray, jparams)),
                                     device="cpu", skin=0.3))


def _driver_structs(seed):
    structs = _mixed(seed, a=3.6, noise=0.12, numbers=14)
    return _jax_atoms(structs), _port_atoms(structs)


@pytest.mark.parametrize("optimizer", ["fire", "gd"])
def test_batched_relaxer_matches_jax(pair_pots, optimizer):
    jpot, pot = pair_pots
    jatoms, atoms = _driver_structs(11)
    jout = JBatchedRelaxer(jpot(), optimizer=optimizer, fmax=0.02).relax(jatoms, steps=12)
    out = BatchedRelaxer(pot(), optimizer=optimizer, fmax=0.02).relax(atoms, steps=12)
    for r, j in zip(out, jout):
        assert (r.converged, r.nsteps) == (j.converged, j.nsteps)
        np.testing.assert_allclose(r.atoms.positions, j.atoms.positions, atol=1e-5)
        assert r.energy == pytest.approx(j.energy, rel=1e-5, abs=1e-6)
    assert out[1].converged and out[1].nsteps == 0  # the 1-atom structure feels no force


@pytest.mark.parametrize("ensemble", ["nve", "nvt_berendsen", "nvt_langevin"])
def test_batched_md_matches_jax(pair_pots, ensemble):
    jpot, pot = pair_pots
    jatoms, atoms = _driver_structs(12)
    rng = np.random.default_rng(3)
    for ja, a in zip(jatoms, atoms):
        a.set_maxwell_boltzmann_velocities(400.0, rng)
        ja.velocities = a.velocities.copy()
    kw = dict(ensemble=ensemble, timestep=2.0, temperature=[300.0, 450.0, 600.0], seed=4)
    jmd, md = JBatchedMD(jatoms, jpot(), **kw), BatchedMD(atoms, pot(), **kw)
    jmd.run(6)
    md.run(6)
    for a, ja in zip(md.atoms_list, jmd.atoms_list):
        np.testing.assert_allclose(a.positions, ja.positions, atol=1e-5)
        np.testing.assert_allclose(a.velocities, ja.velocities, atol=1e-5)
    np.testing.assert_allclose(md.temperatures(), jmd.temperatures(), rtol=1e-5)
    with pytest.raises(ValueError, match="fixed-cell"):
        BatchedMD(atoms, md.potential, ensemble="npt_berendsen")
