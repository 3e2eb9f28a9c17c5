"""The port's host graph layer and tables against the JAX package's.

Neighbor lists, the P=1 partition plan and the capacity-padded graph are
numpy on both sides and must agree bit for bit; so must the chunk layout,
the Clebsch-Gordan tensors and MACE's U bases (the port reads its own copy
of the tracked U cache). The torch device helpers (spherical harmonics,
radial bases, strain, edge vectors) agree with the JAX ones to float32
roundoff.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distmlip_tpu.ops.so3 as jso3
import distmlip_tpu_torch.ops.so3 as tso3
from distmlip_tpu import geometry as jgeom
from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.ops import radial as jradial
from distmlip_tpu.ops.chunk import chunk_layout as jax_chunk_layout
from distmlip_tpu.parallel.halo import local_graph_from_stacked as jax_local_graph
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu_torch import geometry as tgeom
from distmlip_tpu_torch.neighbors import neighbor_list_numpy as port_nl
from distmlip_tpu_torch.ops import radial as tradial
from distmlip_tpu_torch.ops.chunk import chunk_layout as port_chunk_layout
from distmlip_tpu_torch.parallel import local_graph_from_stacked
from distmlip_tpu_torch.partition import CapacityPolicy, build_partitioned_graph, build_plan
from distmlip_tpu_torch.partition.graph import ARRAY_FIELDS
from tests.utils import make_crystal


def _structures():
    rng = np.random.default_rng(3)
    cart, lat, spec = make_crystal(rng, reps=(2, 2, 2), a=4.0)
    tri = np.array([[6.0, 0, 0], [1.5, 5.5, 0], [0.7, -1.1, 6.2]])
    cart2 = rng.random((17, 3)) @ tri
    return {"crystal": (cart, lat, spec, 5.0),
            "triclinic": (cart2, tri, rng.integers(0, 3, 17).astype(np.int32), 4.2),
            "tiny_cell": (np.array([[0.1, 0.2, 0.3]]), np.eye(3) * 2.0,
                          np.zeros(1, np.int32), 2.9)}


STRUCTS = _structures()


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_neighbor_list_and_p1_graph_bit_for_bit(name):
    cart, lat, spec, r = STRUCTS[name]
    a, b = jax_nl(cart, lat, [1, 1, 1], r), port_nl(cart, lat, [1, 1, 1], r)
    for k in ("src", "dst", "offsets", "distances", "bond_mask", "wrapped_cart", "shift"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    jg, jh = jax_build_graph(jax_build_plan(a, lat, [1, 1, 1], 1, r), a, spec, lat,
                             caps=JCaps())
    tg, th = build_partitioned_graph(build_plan(b, lat, [1, 1, 1], 1, r), b, spec, lat,
                                     caps=CapacityPolicy())
    for k in ("num_partitions", "n_cap", "e_cap"):
        assert getattr(jg, k) == getattr(tg, k), k
    assert jg.e_split == jg.e_cap and tuple(jg.shifts) == ()  # P=1: unsplit, no halo
    for k in ARRAY_FIELDS:
        x, y = np.asarray(getattr(jg, k)), np.asarray(getattr(tg, k))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    np.testing.assert_array_equal(jh.owned_counts, th.owned_counts)
    # host reassembly round-trips; .to() keeps dtypes
    pos = np.arange(len(cart) * 3, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(
        th.gather_owned(th.scatter_global(pos, tg.n_cap), len(cart)), pos)
    dev = tg.to("cpu")
    assert dev.edge_dst.dtype == torch.int32 and dev.edge_mask.dtype == torch.bool
    np.testing.assert_array_equal(dev.edge_offset.numpy(), tg.edge_offset)
    # the LocalGraph edge reduction over this graph matches the JAX one
    data = np.random.default_rng(1).normal(size=(tg.e_cap, 3)).astype(np.float32)
    want = np.asarray(jax_local_graph(jg, None)[0].aggregate_edges(
        jnp.asarray(data), jnp.asarray(jg.edge_mask[0])))
    got = local_graph_from_stacked(dev).aggregate_edges(
        torch.from_numpy(data), dev.edge_mask[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_p_gt_1_and_bond_graph_raise():
    cart, lat, spec, r = STRUCTS["crystal"]
    nl = port_nl(cart, lat, [1, 1, 1], r)
    with pytest.raises(NotImplementedError, match="P>1"):
        build_plan(nl, lat, [1, 1, 1], 2, r)
    with pytest.raises(NotImplementedError, match="CHGNet"):
        build_plan(nl, lat, [1, 1, 1], 1, r, use_bond_graph=True)


@pytest.mark.parametrize("e_cap,chunk,split", [
    (1000, 64, None), (1000, 0, None), (640, 64, None), (1000, 64, 300),
    (0, 64, None), (50, 64, None),
])
def test_chunk_layout_matches(e_cap, chunk, split):
    a, b = jax_chunk_layout(e_cap, chunk, split), port_chunk_layout(e_cap, chunk, split)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]


def test_u_basis_and_cg_match_jax():
    """MACE's U bases for the test and benchmark configs (a_ls = 0..3,
    l_out in {0, 1}, nu = 1..3): the port's equal the JAX package's, and
    the port ships byte-identical cache files, read from its own folder."""
    for l_out in (0, 1):
        for nu in (1, 2, 3):
            ju = jso3.symmetric_coupling_basis((0, 1, 2, 3), l_out, nu)
            tu = tso3.symmetric_coupling_basis((0, 1, 2, 3), l_out, nu)
            np.testing.assert_array_equal(ju, tu)
    jdir = os.path.join(os.path.dirname(jso3.__file__), "_u_cache")
    tdir = os.path.join(os.path.dirname(tso3.__file__), "_u_cache")
    assert jdir != tdir
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors
    for ls in ((0, 1, 1), (1, 1, 2), (2, 3, 1), (3, 3, 2)):
        np.testing.assert_array_equal(jso3.real_clebsch_gordan(*ls),
                                      tso3.real_clebsch_gordan(*ls))


def test_device_helpers_match_jax():
    rng = np.random.default_rng(5)
    u = rng.normal(size=(40, 3))
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    for l in range(6):
        np.testing.assert_allclose(
            tso3.spherical_harmonics(l, torch.from_numpy(u)).numpy(),
            np.asarray(jso3.spherical_harmonics(l, jnp.asarray(u))), atol=2e-5)
    d = np.concatenate([[0.0], rng.uniform(0.5, 6.0, 30)]).astype(np.float32)
    np.testing.assert_allclose(
        tradial.spherical_bessel_basis(torch.from_numpy(d), 5.0, 8).numpy(),
        np.asarray(jradial.spherical_bessel_basis(jnp.asarray(d), 5.0, 8)), atol=2e-5)
    np.testing.assert_allclose(
        tradial.polynomial_cutoff(torch.from_numpy(d), 5.0, 6).numpy(),
        np.asarray(jradial.polynomial_cutoff(jnp.asarray(d), 5.0, 6)), atol=2e-6)
    pos = rng.normal(size=(6, 3)).astype(np.float32)
    lat = (np.eye(3) * 4 + rng.normal(0, 0.1, (3, 3))).astype(np.float32)
    eps = rng.normal(0, 0.01, (3, 3)).astype(np.float32)
    for x, y in zip(tgeom.apply_strain(*map(torch.from_numpy, (pos, lat, eps))),
                    jgeom.apply_strain(*map(jnp.asarray, (pos, lat, eps)))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    src, dst = np.array([0, 1, 5]), np.array([2, 2, 3])
    off = np.array([[0, 0, 1], [-1, 0, 0], [0, 1, 1]], np.float32)
    np.testing.assert_allclose(
        tgeom.edge_vectors(*map(torch.from_numpy, (pos, lat, src, dst, off))).numpy(),
        np.asarray(jgeom.edge_vectors(*map(jnp.asarray, (pos, lat, src, dst, off)))),
        atol=1e-6)
