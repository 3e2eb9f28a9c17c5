"""The port's host graph layer and tables against the JAX package's.

Neighbor lists, the P=1 partition plan and the capacity-padded graph,
CHGNet's bond and line graphs included, are numpy on both sides and must
agree bit for bit; so must the chunk layout,
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
from distmlip_tpu_torch.partition import (CapacityPolicy, PartitionError,
                                          build_partitioned_graph, build_plan)
from distmlip_tpu_torch.partition.graph import ARRAY_FIELDS
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401


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
    for k in ("num_partitions", "n_cap", "e_cap", "e_split"):
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
    """What is not ported raises: block plans (grid=), with a bond graph
    too; slab plans at P>1 build (their parity is
    tests/test_torch_partition.py), and so does a P=1 bond graph. The
    native partitioner (``impl="native"``) builds the numpy plan, with and
    without bonds (every field: tests/test_torch_native.py)."""
    cart, lat, spec, r = STRUCTS["crystal"]
    nl = port_nl(cart, lat, [1, 1, 1], r, bond_r=3.0)
    long_cart, long_lat, _ = make_crystal(np.random.default_rng(4), reps=(2, 2, 6), a=4.0)
    long_nl = port_nl(long_cart, long_lat, [1, 1, 1], 3.5, bond_r=2.5)
    for bonds in (False, True):
        native = build_plan(long_nl, long_lat, [1, 1, 1], 2, 3.5, 2.5, bonds, impl="native")
        ref = build_plan(long_nl, long_lat, [1, 1, 1], 2, 3.5, 2.5, bonds, impl="numpy")
        for name in ("global_ids", "node_markers", "edge_ids", "src_local", "dst_local",
                     "bond_global_edge", "line_src", "line_dst", "line_center_local"):
            assert len(getattr(native, name)) == len(getattr(ref, name))
            for a, b in zip(getattr(native, name), getattr(ref, name)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(native.nodes_to_partition, ref.nodes_to_partition)
        assert native.has_bond_graph == ref.has_bond_graph == bonds
    with pytest.raises(NotImplementedError, match="block plans"):
        build_plan(nl, lat, [1, 1, 1], 2, r, 3.0, use_bond_graph=True, grid=(2, 1, 1))
    with pytest.raises(NotImplementedError, match="block plans"):
        build_plan(nl, lat, [1, 1, 1], 1, r, 3.0, use_bond_graph=True, grid=(1, 1, 1))
    with pytest.raises(ValueError, match="impl"):
        build_plan(nl, lat, [1, 1, 1], 1, r, impl="c++")
    assert build_plan(nl, lat, [1, 1, 1], 1, r, 3.0, use_bond_graph=True).has_bond_graph
    # the 8 Å crystal holds two slabs of 4 Å, each thinner than the 5 Å cutoff
    with pytest.raises(PartitionError, match="Slab width"):
        build_plan(nl, lat, [1, 1, 1], 2, r)


BOND_STRUCTS = {
    # fcc a = 3.5 (nn 2.47 Å) rattled by 0.1 Å, CHGNet's test cutoffs
    # (3.2 / 2.6 Å) plus a 0.5 Å skin: skin-shell edges AND bonds
    "fcc_skin": (make_crystal(np.random.default_rng(1), reps=(2, 2, 2), a=3.5, noise=0.1,
                              n_species=4), 3.7, 3.1),
    "triclinic": (STRUCTS["triclinic"][:3], 4.2, 3.0),
    "crystal_no_skin": (STRUCTS["crystal"][:3], 5.0, 3.0),
}


@pytest.mark.parametrize("name", sorted(BOND_STRUCTS))
def test_bond_graph_bit_for_bit(name):
    """The plan's bond section (markers, bond edges, line joins, maps) and
    the graph's (b_cap, line_*, bond_map_* and their caps l_cap, m_cap)
    equal the JAX package's; the LocalGraph remaps do what the JAX ones do."""
    (cart, lat, spec), r, br = BOND_STRUCTS[name]
    a = jax_nl(cart, lat, [1, 1, 1], r, bond_r=br)
    b = port_nl(cart, lat, [1, 1, 1], r, bond_r=br)
    np.testing.assert_array_equal(a.bond_mask, b.bond_mask)
    jp = jax_build_plan(a, lat, [1, 1, 1], 1, r, br, True)
    tp = build_plan(b, lat, [1, 1, 1], 1, r, br, True)
    assert jp.has_bond_graph and tp.has_bond_graph
    for k in ("bond_markers", "bond_global_edge", "bond_needs_in_line", "line_src",
              "line_dst", "line_center_local", "bond_mapping_edge", "bond_mapping_bond"):
        x, y = getattr(jp, k)[0], getattr(tp, k)[0]
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    jg, _ = jax_build_graph(jp, a, spec, lat, caps=JCaps())
    tg, _ = build_partitioned_graph(tp, b, spec, lat, caps=CapacityPolicy())
    assert jg.has_bond_graph and tg.has_bond_graph and jg.b_cap == tg.b_cap
    assert tg.line_src.shape[1] > 0 and tg.line_mask.sum() > 0
    for k in ARRAY_FIELDS:
        x, y = np.asarray(getattr(jg, k)), np.asarray(getattr(tg, k))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    if name == "fcc_skin":  # bonds and edges in the skin shell
        assert (b.distances[b.bond_mask] > 2.6).any() and (b.distances > 3.2).any()
    # edge_to_bond / bond_to_edge set the same rows as the JAX scatters
    jl = jax_local_graph(jg, None)[0]
    tl = local_graph_from_stacked(tg.to("cpu"))
    rng = np.random.default_rng(2)
    ef = rng.normal(size=(tg.e_cap, 3)).astype(np.float32)
    bf = rng.normal(size=(tg.b_cap, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.edge_to_bond(torch.from_numpy(ef), torch.from_numpy(bf)).numpy(),
        np.asarray(jl.edge_to_bond(jnp.asarray(ef), jnp.asarray(bf))))
    np.testing.assert_array_equal(
        tl.bond_to_edge(torch.from_numpy(bf), torch.from_numpy(ef)).numpy(),
        np.asarray(jl.bond_to_edge(jnp.asarray(bf), jnp.asarray(ef))))


def test_bond_remaps_have_set_semantics_in_autograd():
    """An overwritten target row gets no gradient; each written row's
    gradient goes to its source row; masked map rows move nothing."""
    from distmlip_tpu_torch.parallel.halo import _set_rows

    target = torch.randn(5, 2, dtype=torch.float64, requires_grad=True)
    vals = torch.randn(4, 2, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([3, 0, 1, 0], dtype=torch.int32)
    mask = torch.tensor([True, True, False, False])
    out = _set_rows(target, idx, mask, vals)
    want = target.detach().clone()
    want[3], want[0] = vals.detach()[0], vals.detach()[1]
    torch.testing.assert_close(out, want)
    g = torch.arange(10, dtype=torch.float64).reshape(5, 2)
    gt, gv = torch.autograd.grad(out, (target, vals), g)
    torch.testing.assert_close(gt, g * torch.tensor([0, 1, 1, 0, 1.0])[:, None])
    torch.testing.assert_close(gv, torch.stack([g[3], g[0], torch.zeros(2), torch.zeros(2)]))
    assert torch.autograd.gradcheck(lambda t, v: _set_rows(t, idx, mask, v), (target, vals))


def test_self_loop_bond_warns_like_jax():
    """A cell smaller than the bond cutoff gives self-loop bonds: both
    packages warn."""
    cart, lat = np.array([[0.1, 0.2, 0.3]]), np.eye(3) * 2.0
    nl = port_nl(cart, lat, [1, 1, 1], 2.9, bond_r=2.5)
    with pytest.warns(UserWarning, match="self-loop"):
        build_plan(nl, lat, [1, 1, 1], 1, 2.9, 2.5, True)
    with pytest.warns(UserWarning, match="self-loop"):
        jax_build_plan(jax_nl(cart, lat, [1, 1, 1], 2.9, bond_r=2.5), lat, [1, 1, 1], 1,
                       2.9, 2.5, True)


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


def test_chgnet_bases_match_jax():
    """matgl's bessel basis (learnable frequencies, safe at d = 0), the
    interleaved Fourier expansion and the unclamped polynomial cutoff on
    negative, in-range and beyond-cutoff values."""
    rng = np.random.default_rng(6)
    d = np.concatenate([[0.0], rng.uniform(0.3, 6.5, 40)]).astype(np.float32)
    freq = (np.pi * np.arange(1, 8) * rng.uniform(0.9, 1.1, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tradial.radial_bessel(torch.from_numpy(d), torch.from_numpy(freq), 6.0).numpy(),
        np.asarray(jradial.radial_bessel(jnp.asarray(d), jnp.asarray(freq), 6.0)),
        atol=2e-6)
    theta = rng.uniform(0, np.pi, 30).astype(np.float32)
    fa = np.arange(0, 5, dtype=np.float32) * rng.uniform(0.9, 1.1, 5).astype(np.float32)
    np.testing.assert_allclose(
        tradial.matgl_fourier_expansion(torch.from_numpy(theta), torch.from_numpy(fa)).numpy(),
        np.asarray(jradial.matgl_fourier_expansion(jnp.asarray(theta), jnp.asarray(fa))),
        atol=2e-6)
    x = np.concatenate([rng.uniform(-2.0, 7.0, 40), [6.0]]).astype(np.float32)
    got = tradial.matgl_polynomial_cutoff(torch.from_numpy(x), 6.0, 5).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jradial.matgl_polynomial_cutoff(jnp.asarray(x), 6.0, 5)),
        rtol=1e-5, atol=1e-5)
    assert not got[x > 6.0].any() and (got[x < 0] > 1).all()


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
