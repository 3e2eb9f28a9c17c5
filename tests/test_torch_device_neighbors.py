"""The on-device neighbor rebuild of the port: cell list, edge swap, calculator.

- ``device_neighbor_list`` against ``neighbor_list_numpy`` (exact pair
  sets, float64, across the PBC edge cases of ``tests/test_device_neighbors.py``)
  and against the JAX package's ``device_neighbor_list`` (equal arrays,
  element for element, on the same float32 inputs: both sort stably and
  compact in order);
- the edge and cell overflow flags, the edge count exact past ``e_cap``;
- ``refresh_edges``' padding contract and refusals, and a refreshed graph
  through a potential against a fresh host build;
- ``DistPotential``: skin-cache invalidations served on the device, against
  ``device_rebuild=False`` and against the JAX package's potential on the
  same moves (float32 bar: rel dE < 1e-5, max |dF| < 1e-4 eV/Å, max |dS|
  < 1e-4 eV/Å^3); a forced cell overflow takes the host rebuild; CHGNet
  (a bond graph) never refreshes on the device.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import TensorNet as JTensorNet
from distmlip_tpu.models import TensorNetConfig as JTensorNetConfig
from distmlip_tpu.neighbors.device import build_cell_list_spec as jax_build_cell_list_spec
from distmlip_tpu.neighbors.device import device_neighbor_list as jax_device_neighbor_list
from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, TensorNet, TensorNetConfig
from distmlip_tpu_torch.neighbors import (build_cell_list_spec, device_neighbor_list,
                                          neighbor_list_numpy)
from distmlip_tpu_torch.parallel import make_potential_fn
from distmlip_tpu_torch.partition import (CapacityPolicy, build_partitioned_graph,
                                          build_plan, device_refresh_graph, refresh_edges)
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TRICLINIC = np.array([[8.0, 0, 0], [2.5, 7.0, 0], [1.5, -2.0, 6.5]])


def _case(name):
    """(cart, lattice, pbc, r, n_cap, e_cap) of each edge case."""
    rng = np.random.default_rng(42)
    if name == "cubic":
        lat = np.eye(3) * 8.0
        return rng.random((40, 3)) @ lat, lat, [1, 1, 1], 3.0, None, 8192
    if name == "triclinic":
        return rng.random((30, 3)) @ TRICLINIC, TRICLINIC, [1, 1, 1], 3.2, None, 8192
    if name == "tiny_cell_multi_image":
        return (np.array([[0.5, 0.5, 0.5], [1.2, 0.4, 1.7]]), np.eye(3) * 2.0, [1, 1, 1],
                2.9, None, 8192)
    if name == "one_atom":
        return np.array([[0.5, 0.5, 0.5]]), np.eye(3) * 2.0, [1, 1, 1], 2.9, None, 8192
    if name == "partial_pbc_unwrapped":
        cart = rng.random((30, 3)) @ TRICLINIC + rng.integers(-3, 4, (30, 3)) @ TRICLINIC
        return cart, TRICLINIC, [1, 1, 0], 3.0, None, 8192
    if name == "padded_rows":
        lat = np.eye(3) * 7.0
        return rng.random((25, 3)) @ lat, lat, [1, 1, 1], 2.8, 64, 8192
    seed = int(name[len("sweep"):])
    r = np.random.default_rng(seed)
    n = int(r.integers(5, 70))
    box = float(r.uniform(3.0, 10.0))
    lat = np.eye(3) * box
    lat[0, 1] = r.uniform(-0.3, 0.3) * box
    lat[1, 2] = r.uniform(-0.3, 0.3) * box
    return r.random((n, 3)) @ lat, lat, [1, 1, 1], float(r.uniform(1.5, 3.5)), None, 16384


CASES = ["cubic", "triclinic", "tiny_cell_multi_image", "one_atom",
         "partial_pbc_unwrapped", "padded_rows"] + [f"sweep{s}" for s in range(5)]


def _padded(cart, n_cap, dtype):
    pos = np.zeros((n_cap or len(cart), 3), dtype)
    pos[:len(cart)] = cart
    return pos


def _pairs(src, dst, off):
    return set(zip(src.tolist(), dst.tolist(), map(tuple, off.tolist())))


@pytest.mark.parametrize("name", CASES)
def test_pair_set_matches_numpy_in_float64(name):
    cart, lat, pbc, r, n_cap, e_cap = _case(name)
    static, arrays = build_cell_list_spec(lat, pbc, r, len(cart), n_cap or len(cart), e_cap,
                                          positions=cart, dtype=np.float64)
    src, dst, off, n_edges, overflow = device_neighbor_list(
        static, arrays, _padded(cart, n_cap, np.float64))
    assert not bool(overflow)
    ne = int(n_edges)
    assert src.dtype == dst.dtype == off.dtype == torch.int32
    assert np.all(np.diff(dst[:ne].numpy()) >= 0)  # dst (the center) nondecreasing
    assert not src[ne:].any() and not dst[ne:].any() and not off[ne:].any()
    nl = neighbor_list_numpy(cart, lat, pbc, r)
    assert _pairs(src[:ne].numpy(), dst[:ne].numpy(), off[:ne].numpy()) == \
        _pairs(nl.src, nl.dst, nl.offsets)
    if name == "one_atom":
        assert ne > 0  # self-image neighbors exist


@pytest.mark.parametrize("name", CASES)
def test_arrays_match_jax_element_for_element(name):
    cart, lat, pbc, r, n_cap, e_cap = _case(name)
    n_cap = n_cap or len(cart)
    pos = _padded(cart, n_cap, np.float32)
    jstatic, jarrays = jax_build_cell_list_spec(lat, pbc, r, len(cart), n_cap, e_cap,
                                                positions=cart)
    static, arrays = build_cell_list_spec(lat, pbc, r, len(cart), n_cap, e_cap,
                                          positions=cart)
    assert dataclasses.asdict(static) == dataclasses.asdict(jstatic)
    ref = jax_device_neighbor_list(jstatic, jarrays, pos)
    got = device_neighbor_list(static, arrays, torch.from_numpy(pos))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_edge_overflow_flag_and_exact_count():
    rng = np.random.default_rng(42)
    lat = np.eye(3) * 6.0
    cart = rng.random((30, 3)) @ lat
    static, arrays = build_cell_list_spec(lat, [1, 1, 1], 3.0, 30, 30, 8,
                                          positions=cart)  # e_cap=8: tiny
    src, dst, off, n_edges, overflow = device_neighbor_list(
        static, arrays, cart.astype(np.float32))
    assert bool(overflow) and src.shape == (8,)
    # the count still reports the true need, so the caller can grow the cap
    assert int(n_edges) == len(neighbor_list_numpy(cart, lat, [1, 1, 1], 3.0).src)


def test_cell_overflow_flag():
    rng = np.random.default_rng(42)
    lat = np.eye(3) * 6.0
    cart = rng.random((30, 3)) @ lat
    static, arrays = build_cell_list_spec(lat, [1, 1, 1], 3.0, 30, 30, 8192,
                                          positions=cart, cell_cap=1)
    *_rest, overflow = device_neighbor_list(static, arrays, cart.astype(np.float32))
    assert bool(overflow)


# ---------------------------------------------------------------------------
# in-place refresh: padding contract, refusals, exactness through a potential
# ---------------------------------------------------------------------------

CFG = dict(num_species=4, units=16, num_rbf=8, num_layers=2, cutoff=3.0)


def _fcc(reps=(3, 3, 3), seed=5):
    """108 atoms of a rattled fcc crystal (a = 3.8 Å), 3 species."""
    rng = np.random.default_rng(seed)
    cart, lat, spec = make_crystal(rng, reps=reps, a=3.8, noise=0.03, n_species=3)
    return cart, lat, spec


def _host_graph(cart, lat, spec, r, caps=None, bond_r=0.0):
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r, bond_r=bond_r)
    plan = build_plan(nl, lat, [1, 1, 1], 1, r, bond_r, bond_r > 0)
    return build_partitioned_graph(plan, nl, spec, lat, caps=caps)


def test_refresh_contract_and_exactness():
    """The refreshed graph keeps the padding contract and gives a fresh host
    build's energy, forces and stress within the float32 bar."""
    cart, lat, spec = _fcc()
    r, caps = 3.0, CapacityPolicy()
    graph, host = _host_graph(cart, lat, spec, r, caps)
    static, arrays = build_cell_list_spec(lat, [1, 1, 1], r, len(cart), graph.n_cap,
                                          graph.e_cap, positions=cart)
    drift = cart + np.random.default_rng(6).normal(0, 0.25, cart.shape)
    pos = torch.from_numpy(host.scatter_global(drift.astype(np.float32), graph.n_cap))
    graph_t = graph.to("cpu")
    graph2, n_edges, overflow = device_refresh_graph(
        static, {k: torch.from_numpy(v) for k, v in arrays.items()}, graph_t, pos)
    assert not bool(overflow)
    ne = int(n_edges)
    dst, mask = graph2.edge_dst[0].numpy(), graph2.edge_mask[0].numpy()
    assert graph2.edge_dst.shape == graph_t.edge_dst.shape and graph2.e_cap == graph.e_cap
    assert mask.sum() == ne and mask[:ne].all()
    assert np.all(np.diff(dst) >= 0)                 # nondecreasing
    assert np.all(dst[ne:] == dst[ne - 1])           # padding repeats the last
    assert not graph2.edge_src[0, ne:].any() and not graph2.edge_offset[0, ne:].any()
    assert graph2.edge_offset.dtype == torch.float32 and graph2.edge_src.dtype == torch.int32

    model = TensorNet(TensorNetConfig(**CFG))
    params = model.init(0)
    pot = make_potential_fn(model.energy_fn)
    out_dev = pot(params, graph2, pos)
    graph3, host3 = _host_graph(drift, lat, spec, r, caps)
    graph3 = graph3.to("cpu")
    out_host = pot(params, graph3, graph3.positions)
    e_ref = float(out_host["energy"])
    assert abs(float(out_dev["energy"]) - e_ref) < 1e-5 * abs(e_ref)
    f_dev = host.gather_owned(out_dev["forces"].detach().numpy(), len(cart))
    f_host = host3.gather_owned(out_host["forces"].detach().numpy(), len(cart))
    assert np.abs(f_host).max() > 1e-2
    np.testing.assert_allclose(f_dev, f_host, atol=1e-4)
    np.testing.assert_allclose(out_dev["stress"].detach().numpy(),
                               out_host["stress"].detach().numpy(), atol=1e-4)


def test_refresh_refuses_unsupported_graphs():
    """More than one partition, a split edge layout and a bond graph refuse
    the in-place swap (their other arrays would go stale)."""
    cart, lat, spec = _fcc((2, 2, 2))
    graph, _ = _host_graph(cart, lat, spec, 3.0)
    graph = graph.to("cpu")
    z = torch.zeros((graph.e_cap,), dtype=torch.int32)
    zo = torch.zeros((graph.e_cap, 3))
    assert graph.e_split == graph.e_cap
    refresh_edges(graph, z, z, zo, 0)  # the unsplit single-partition graph is taken
    with pytest.raises(ValueError, match="single-partition"):
        refresh_edges(dataclasses.replace(graph, num_partitions=2), z, z, zo, 0)
    with pytest.raises(ValueError, match="unsplit"):
        refresh_edges(dataclasses.replace(graph, e_split=graph.e_cap - 1), z, z, zo, 0)
    bond_graph, _ = _host_graph(cart, lat, spec, 3.0, bond_r=2.0)
    with pytest.raises(ValueError, match="bond"):
        refresh_edges(bond_graph.to("cpu"), z, z, zo, 0)


# ---------------------------------------------------------------------------
# DistPotential
# ---------------------------------------------------------------------------

MOVES = 4


def _moves():
    rng = np.random.default_rng(8)
    return [rng.normal(0, 0.12, (108, 3)) for _ in range(MOVES)]


def _drive(pot, atoms_cls):
    cart, lat, spec = _fcc()
    atoms = atoms_cls(numbers=spec, positions=cart, cell=lat)
    out = []
    for step in [None] + _moves():
        if step is not None:
            atoms.positions = atoms.positions + step
        out.append(pot.calculate(atoms))
    return out


def _assert_close(res, ref):
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], atol=1e-4)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.array, JTensorNet(JTensorNetConfig(**CFG)).init(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_refresh(params):
    pot = JDistPotential(JTensorNet(JTensorNetConfig(**CFG)), params, num_partitions=1,
                         skin=0.5)
    return _drive(pot, JAtoms), pot.rebuild_on_device_count


@pytest.fixture(scope="module")
def port_refresh(params):
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params, device="cpu", skin=0.5)
    return _drive(pot, Atoms), pot


def test_distpotential_refresh_matches_host_rebuild(params, port_refresh):
    results, pot = port_refresh
    host_pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params, device="cpu",
                             skin=0.5, device_rebuild=False)
    for res, ref in zip(results, _drive(host_pot, Atoms)):
        _assert_close(res, ref)
    assert pot.rebuild_on_device_count >= 2
    assert pot.rebuild_count == 1 + pot.rebuild_on_device_count
    assert host_pot.rebuild_on_device_count == 0 and host_pot.rebuild_count >= 3
    assert pot.rebuild_overflow_count == 0
    # the last call refreshed on the device: no host search, its own timing
    assert pot.last_build_fresh
    assert pot.last_timings["neighbor_s"] == 0.0 and "rebuild_s" in pot.last_timings
    assert pot.last_stats["n_edges"] == int(pot._cache[0].edge_mask.sum())


def test_distpotential_refresh_matches_jax(jax_refresh, port_refresh):
    ref, jax_on_device = jax_refresh
    results, pot = port_refresh
    assert pot.rebuild_on_device_count == jax_on_device
    for res, r in zip(results, ref):
        _assert_close(res, r)


def test_cell_overflow_takes_the_host_rebuild(params, port_refresh):
    """A cell table too small for the moved atoms overflows: the refresh is
    discarded, the host rebuilds with the cell capacity grown, and later
    invalidations refresh on the device again."""
    reference, _ = port_refresh
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params, device="cpu", skin=0.5)
    cart, lat, spec = _fcc()
    atoms = Atoms(numbers=spec, positions=cart, cell=lat)
    results = [pot.calculate(atoms)]
    static, arrays = pot._nbr_spec
    pot._nbr_spec = (dataclasses.replace(static, cell_cap=1), arrays)
    for step in _moves():
        atoms.positions = atoms.positions + step
        results.append(pot.calculate(atoms))
    assert pot.rebuild_overflow_count == 1
    assert pot._cell_cap_floor == 4 and pot._nbr_spec[0].cell_cap >= 4
    assert pot.rebuild_on_device_count == MOVES - 1
    assert pot.rebuild_count == 2 + MOVES - 1
    for res, ref in zip(results, reference):
        _assert_close(res, ref)


def test_chgnet_never_refreshes_on_the_device():
    model = CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_angle=4,
                                num_blocks=3, cutoff=3.2, bond_cutoff=2.6))
    pot = DistPotential(model, model.init(0), device="cpu", skin=0.5)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    atoms = Atoms(numbers=np.arange(32) % 4, positions=frac @ lat, cell=lat)
    for _ in range(3):
        pot.calculate(atoms)
        atoms.positions = atoms.positions + 0.2
    assert pot.rebuild_count == 3 and pot.rebuild_on_device_count == 0
    assert pot._nbr_spec is None


def test_device_rebuild_takes_only_auto_true_false():
    model = TensorNet(TensorNetConfig(**CFG))
    params = model.init(0)
    for ok in ("auto", True, False):
        DistPotential(model, params, device="cpu", skin=0.5, device_rebuild=ok)
    for bad in ("yes", 1, None):
        with pytest.raises(TypeError, match="device_rebuild"):
            DistPotential(model, params, device="cpu", skin=0.5, device_rebuild=bad)
