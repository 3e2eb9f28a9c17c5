"""The port's slab plans and P>1 graphs against the JAX package's.

Both sides are numpy, so the plan (walls, owners, the [pure | to | from]
layout, the edge assignment, the bond graph and its halo sections), the
capacity-padded stacked (P, ...) graph, the halo tables and the ring shifts
must be equal element for element: the JAX side through
``build_plan(..., impl="numpy")`` and ``build_partitioned_graph``, at P in
{2, 3, 4}, with and without the bond graph. The flattened view that the
port runs (``PartitionedGraph.flat``) has no JAX counterpart; it is checked
here against the stacked arrays it is made from. The two slab errors
(slabs thinner than the cutoff, a node that reaches two peers) raise
``PartitionError`` on both sides.
"""

import warnings

import numpy as np
import pytest

from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import PartitionError as JPartitionError
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu_torch.neighbors import neighbor_list_numpy as port_nl
from distmlip_tpu_torch.partition import (CapacityPolicy, PartitionError,
                                          build_partitioned_graph, build_plan)
from distmlip_tpu_torch.partition.graph import ARRAY_FIELDS
from tests.torch_threads import one_intra_op_thread  # noqa: F401

R, BOND_R = 3.0, 2.0
PLAN_LISTS = ("global_ids", "node_markers", "g2l", "edge_ids", "src_local", "dst_local",
              "edge_offsets")
BOND_LISTS = ("bond_markers", "bond_global_edge", "bond_needs_in_line", "line_src",
              "line_dst", "line_center_local", "bond_mapping_edge", "bond_mapping_bond")


def _cell(P, seed=0):
    """A random, slightly sheared cell whose longest axis holds P slabs of
    7 Å (> 2 R, so every border node reaches one peer); ~0.04 atoms/Å^3."""
    rng = np.random.default_rng(seed + P)
    lat = np.diag([8.0, 7.5, 7.0 * P])
    lat[0, 1] = 0.4
    n = int(0.04 * abs(np.linalg.det(lat)))
    cart = rng.random((n, 3)) @ lat
    return cart, lat, rng.integers(0, 3, n).astype(np.int32)


def _both(P, bond, cell=None):
    cart, lat, spec = cell or _cell(P)
    a = jax_nl(cart, lat, [1, 1, 1], R, bond_r=BOND_R)
    b = port_nl(cart, lat, [1, 1, 1], R, bond_r=BOND_R)
    jp = jax_build_plan(a, lat, [1, 1, 1], P, R, BOND_R, bond, impl="numpy")
    tp = build_plan(b, lat, [1, 1, 1], P, R, BOND_R, bond)
    return (a, jp), (b, tp), spec, lat


def _equal(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape, what
    np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("bond", [False, True])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_slab_plan_and_graph_equal_jax(P, bond):
    (a, jp), (b, tp), spec, lat = _both(P, bond)
    assert tp.kind == "slab" and tp.num_partitions == P and tp.axis == jp.axis == 2
    for k in ("walls", "node_part", "nodes_to_partition"):
        _equal(getattr(jp, k), getattr(tp, k), k)
    assert (tp.nodes_to_partition >= 0).any()  # the cell has border nodes
    for k in PLAN_LISTS + (BOND_LISTS if bond else ()):
        for p in range(P):
            _equal(getattr(jp, k)[p], getattr(tp, k)[p], f"{k}[{p}]")
    _equal(jp.owned_counts, tp.owned_counts, "owned_counts")
    for p in range(P):
        _equal(jp.edge_is_frontier(p), tp.edge_is_frontier(p), "edge_is_frontier")
        for q in range(P):
            for kind in ("to", "from"):
                assert jp.section(p, kind, q) == tp.section(p, kind, q)
                if bond:
                    assert jp.bond_section(p, kind, q) == tp.bond_section(p, kind, q)
    assert tp.summary() == jp.summary()

    jg, jh = jax_build_graph(jp, a, spec, lat, caps=JCaps())
    tg, th = build_partitioned_graph(tp, b, spec, lat, caps=CapacityPolicy())
    for k in ("num_partitions", "n_cap", "e_cap", "e_split", "b_cap", "has_bond_graph"):
        assert getattr(jg, k) == getattr(tg, k), k
    assert tuple(jg.shifts) == tuple(tg.shifts)
    assert tg.e_split < tg.e_cap  # split into interior | frontier
    for k in ARRAY_FIELDS:
        _equal(getattr(jg, k), getattr(tg, k), k)
    _equal(jh.owned_counts, th.owned_counts, "host owned_counts")
    pos = np.arange(len(spec) * 3, dtype=np.float32).reshape(-1, 3)
    local = th.scatter_global(pos, tg.n_cap)
    _equal(jh.scatter_global(pos, jg.n_cap), local, "scatter_global")
    np.testing.assert_array_equal(th.gather_owned(local, len(spec)), pos)


def test_p2_keeps_one_shift_and_p3_two():
    """At P = 2 the shifts +1 and -1 reach the same peer: one shift; at
    P = 3 both directions are shifts of their own."""
    for P, want in ((2, (1,)), (3, (1, 2))):
        (a, jp), (b, tp), spec, lat = _both(P, True)
        tg, _ = build_partitioned_graph(tp, b, spec, lat, caps=CapacityPolicy())
        assert tg.shifts == want
        assert tg.halo_send_idx.shape[:2] == tg.bond_halo_send_idx.shape[:2] == (len(want), P)


@pytest.mark.parametrize("P,bond", [(2, True), (3, True), (4, False)])
def test_flat_view_is_the_stacked_graph_side_by_side(P, bond):
    """Every real edge of partition p appears once in the flattened edge
    list with ids shifted by p n_cap, interior edges in the first segment,
    frontier edges in the second; each segment and the line graph are
    nondecreasing in dst, with all their padding at the tail (one repeated
    dst row, as in a P=1 graph); each bond maps onto the flat edge of its
    own global edge; the halo vectors pair each recv slot with its owner's
    row."""
    _, (b, tp), spec, lat = _both(P, bond)
    g, _ = build_partitioned_graph(tp, b, spec, lat, caps=CapacityPolicy())
    f, n, s, e = g.flat, g.n_cap, g.e_split, g.e_cap
    assert len(f["edge_src"]) == P * e
    for seg in (slice(0, P * s), slice(P * s, P * e)):
        m = f["edge_mask"][seg]
        assert np.all(np.diff(f["edge_dst"][seg]) >= 0)
        assert np.all(m[:m.sum()]) and not m[m.sum():].any()  # padding at the tail
        assert len(set(f["edge_dst"][seg][m.sum():].tolist())) <= 1
    want, got = set(), set()
    for p in range(P):
        for k in range(e):
            if g.edge_mask[p, k]:
                seg = 0 if k < s else 1
                want.add((seg, p * n + int(g.edge_src[p, k]), p * n + int(g.edge_dst[p, k]),
                          tuple(g.edge_offset[p, k])))
    for i in np.nonzero(f["edge_mask"])[0]:
        got.add((int(i >= P * s), int(f["edge_src"][i]), int(f["edge_dst"][i]),
                 tuple(f["edge_offset"][i])))
    assert got == want and int(f["edge_mask"].sum()) == int(g.edge_mask.sum())
    # interior edges read owned rows only
    owned = g.owned_mask.reshape(-1)
    assert owned[f["edge_src"][:P * s][f["edge_mask"][:P * s]]].all()
    assert not owned[f["edge_src"][P * s:][f["edge_mask"][P * s:]]].any()
    # halo vectors: recv rows are halo rows, send rows owned, same global atom
    gid = np.full(P * n, -1)
    for p in range(P):
        gid[p * n:p * n + len(tp.global_ids[p])] = tp.global_ids[p]
    hs, hr = f["halo_send"], f["halo_recv"]
    assert len(hr) == len(set(hr.tolist())) == sum(
        int(m[-1] - m[1 + P]) for m in tp.node_markers)
    assert owned[hs].all() and not owned[hr].any()
    np.testing.assert_array_equal(gid[hs], gid[hr])
    if bond:
        lm = f["line_mask"]
        assert np.all(np.diff(f["line_dst"]) >= 0)
        assert np.all(lm[:lm.sum()]) and not lm[lm.sum():].any()
        assert int(lm.sum()) == sum(len(x) for x in tp.line_src)
        m = f["bond_map_mask"]
        bm_e, bm_b = f["bond_map_edge"][m], f["bond_map_bond"][m]
        bgid = np.concatenate([np.pad(tp.bond_global_edge[p],
                                      (0, g.b_cap - len(tp.bond_global_edge[p])),
                                      constant_values=-1) for p in range(P)])
        w = bgid[bm_b]  # the global edge of each owned bond
        assert f["edge_mask"][bm_e].all()
        np.testing.assert_array_equal(gid[f["edge_src"][bm_e]], b.src[w])
        np.testing.assert_array_equal(gid[f["edge_dst"][bm_e]], b.dst[w])
        np.testing.assert_array_equal(f["edge_offset"][bm_e], b.offsets[w])
        bs, br = f["bond_halo_send"], f["bond_halo_recv"]
        assert len(br) > 0
        np.testing.assert_array_equal(bgid[bs], bgid[br])


def test_slab_errors_match_jax():
    """Slabs thinner than the cutoff, and a node reaching two peers (slab
    width between R and 2 R at P = 4), raise PartitionError on both numpy
    paths with the same message (the native partitioners name the node
    alone: tests/test_torch_native.py); P < 1 raises too."""
    rng = np.random.default_rng(5)
    lat = np.eye(3) * 16.0
    cart = rng.random((200, 3)) @ lat
    a, b = jax_nl(cart, lat, [1, 1, 1], R), port_nl(cart, lat, [1, 1, 1], R)
    for P, match in ((8, "Slab width"), (4, "exactly one peer")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(JPartitionError, match=match) as je:
                jax_build_plan(a, lat, [1, 1, 1], P, R, impl="numpy")
            with pytest.raises(PartitionError, match=match) as te:
                build_plan(b, lat, [1, 1, 1], P, R, impl="numpy")
        assert str(je.value) == str(te.value)
    with pytest.raises(PartitionError, match=">= 1"):
        build_plan(b, lat, [1, 1, 1], 0, R)
