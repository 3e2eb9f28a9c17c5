"""Spatial graph partitioner (numpy): one partition, or P slabs with halos.

Splits the periodic atom graph into P slabs along the longest periodic
lattice vector and assigns every directed edge to the partition owning
its destination node (zero-redundancy owner-computes; the JAX package's
``distmlip_tpu/partition/partitioner.py``, its numpy path). At P=1 the
whole structure is one partition: every node is owned, there is no halo,
and every edge is local. With ``use_bond_graph`` the plan also carries
CHGNet's bond graph (edges within the bond cutoff), its directed line
graph and the bond halo sections.

Invariants (``tests/test_torch_partition.py`` holds them against the JAX
package): owned nodes are a disjoint cover of all nodes; every edge lands
on exactly one partition; a border node is sent to exactly ONE other
partition (a node that reaches two peers raises: lower P); to/from halo
sections are index-aligned between the two sides of every pair, so the
halo exchange is a slot-to-slot copy.

The native C++/OpenMP partitioner (``neighbors/native.py``,
``neighbors/src/partition.cpp``) builds the same plans array for array;
``build_plan`` takes it by default. Not ported (ROADMAP.md): block plans
over a grid of blocks (queue A, A4).
"""

from __future__ import annotations

import numpy as np

from .. import geometry
from ..neighbors.python_ref import NeighborList
from .plan import PartitionPlan

EPSILON = 1e-10


class PartitionError(RuntimeError):
    pass


def choose_axis(lattice: np.ndarray, pbc) -> int:
    """Slab axis = the Cartesian-longest periodic lattice vector."""
    lengths = np.linalg.norm(np.asarray(lattice, dtype=np.float64), axis=1)
    pbc_mask = np.asarray(pbc, dtype=bool)
    lengths = np.where(pbc_mask, lengths, -np.inf)
    return int(np.argmax(lengths))


def make_walls(frac_axis: np.ndarray, num_partitions: int) -> np.ndarray:
    """P-1 equally spaced fractional walls, nudged off atoms by EPSILON.

    Perfect supercells place whole atom planes exactly at k/P fractions;
    the nudge searches both directions (smallest excursion first), and
    every wall is kept strictly above the previous one and strictly below
    min(1, base + half a slab), so the order never inverts.
    """
    P = int(num_partitions)
    base_walls = np.arange(1, P) / P
    walls = np.empty_like(base_walls)
    half = 0.5 / P  # max excursion: half a slab width
    step = 10 * EPSILON
    prev = 0.0
    for i, base in enumerate(base_walls):
        lo = max(prev + step, base - half)
        hi = min(1.0, base + half)

        def clear(w):
            return lo <= w < hi and not np.any(np.abs(frac_axis - w) < EPSILON)

        chosen = base if clear(base) else None
        k = 1
        while chosen is None:
            if k * step > half:
                raise PartitionError(
                    f"could not nudge wall {i} (base {base:.6f}) off atom "
                    f"planes within its slab; reduce num_partitions."
                )
            for cand in (base + k * step, base - k * step):
                if clear(cand):
                    chosen = cand
                    break
            k += 1
        walls[i] = prev = chosen
    return walls


def which_partition(walls: np.ndarray, frac_axis: np.ndarray) -> np.ndarray:
    return np.searchsorted(walls, frac_axis, side="right").astype(np.int64)


def check_partition_size(lattice, axis, num_partitions, r, bond_r) -> None:
    """Raise when slabs are thinner than the interaction range; warn when
    they are thinner than twice it."""
    width = geometry.plane_spacings(lattice)[axis] / num_partitions
    if width <= r:
        raise PartitionError(
            f"Slab width {width:.3f} Å <= cutoff {r:.3f} Å with P={num_partitions}: "
            "border regions would overlap beyond adjacent slabs. Reduce the number "
            "of partitions or enlarge the cell."
        )
    if width <= 2 * max(r, bond_r):
        import warnings

        warnings.warn(
            f"Slab width {width:.3f} Å <= 2x cutoff: halo regions may dominate.",
            stacklevel=2,
        )


def build_plan(
    nl: NeighborList,
    lattice: np.ndarray,
    pbc,
    num_partitions: int,
    r: float,
    bond_r: float = 0.0,
    use_bond_graph: bool = False,
    impl: str = "auto",
    grid: tuple | None = None,
) -> PartitionPlan:
    """Partition a neighbor graph into ``num_partitions`` slabs with halos.

    ``use_bond_graph`` adds the bond and line graphs over the edges the
    neighbor list marks within ``bond_r`` (``nl.bond_mask``), with their
    halo sections at P > 1.

    ``impl``: ``"auto"`` and ``"native"`` take the native C++
    partitioner, ``"numpy"`` the numpy path; their plans are equal array
    for array (P = 1 builds the one-partition plan on either). ``grid``
    (a block decomposition) raises ``NotImplementedError`` (ROADMAP.md
    queue A, A4).
    """
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"impl={impl!r}: expected 'auto', 'numpy' or 'native'")
    if grid is not None:
        raise NotImplementedError(
            f"grid={tuple(grid)}: block plans are not ported (ROADMAP.md queue "
            "A, A4); slab plans take num_partitions alone")
    lattice = np.asarray(lattice, dtype=np.float64)
    n = nl.wrapped_cart.shape[0]
    P = int(num_partitions)
    src, dst = nl.src, nl.dst

    if P == 1:
        return _single_partition_plan(nl, use_bond_graph)
    if P < 1:
        raise PartitionError("num_partitions must be >= 1")
    axis = choose_axis(lattice, pbc)
    check_partition_size(lattice, axis, P, r, max(bond_r, 0.0))

    frac = geometry.cart_to_frac(nl.wrapped_cart, lattice)
    walls = make_walls(frac[:, axis], P)
    if impl != "numpy":
        return _build_plan_native(nl, frac[:, axis], axis, walls, P, use_bond_graph)
    node_part = which_partition(walls, frac[:, axis])

    # --- border classification: src must be visible wherever its edges land ---
    cross = node_part[src] != node_part[dst]
    ntp = np.full(n, -1, dtype=np.int64)  # nodes_to_partition
    if np.any(cross):
        cs, cd = src[cross], node_part[dst[cross]]
        order = np.argsort(cs, kind="stable")
        cs, cd = cs[order], cd[order]
        uniq, start = np.unique(cs, return_index=True)
        for k, u in enumerate(uniq):
            end = start[k + 1] if k + 1 < len(uniq) else len(cs)
            dests = np.unique(cd[start[k]:end])
            if len(dests) > 1:
                raise PartitionError(
                    f"Node {u} has neighbors in {len(dests)} other partitions "
                    f"({dests.tolist()}); slab decomposition requires border nodes to "
                    "reach exactly one peer. Reduce num_partitions."
                )
            ntp[u] = dests[0]

    plan = PartitionPlan(P, axis, walls, node_part, ntp)

    # --- per-partition node layout [pure | to_* | from_*] ---
    for p in range(P):
        owned = np.nonzero(node_part == p)[0]
        is_border = ntp[owned] != -1
        pure = owned[~is_border]
        sections = [pure]
        counts = [len(pure)]
        for q in range(P):
            to_q = owned[is_border & (ntp[owned] == q)]
            sections.append(to_q)
            counts.append(len(to_q))
        for q in range(P):
            if q == p:
                from_q = np.zeros(0, dtype=np.int64)
            else:
                q_owned = np.nonzero(node_part == q)[0]
                from_q = q_owned[ntp[q_owned] == p]
            sections.append(from_q)
            counts.append(len(from_q))
        gids = np.concatenate(sections)
        markers = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        g2l = np.full(n, -1, dtype=np.int64)
        g2l[gids] = np.arange(len(gids))
        plan.global_ids.append(gids)
        plan.node_markers.append(markers)
        plan.g2l.append(g2l)

    # --- owner-computes edge assignment + localization ---
    edge_part = node_part[dst]
    for p in range(P):
        eids = np.nonzero(edge_part == p)[0]
        ls = plan.g2l[p][src[eids]]
        ld = plan.g2l[p][dst[eids]]
        if np.any(ls < 0) or np.any(ld < 0):
            raise PartitionError("internal error: edge endpoint missing from partition")
        plan.edge_ids.append(eids)
        plan.src_local.append(ls)
        plan.dst_local.append(ld)
        plan.edge_offsets.append(nl.offsets[eids])

    if use_bond_graph:
        _build_bond_graph(plan, nl)
    return plan


def _build_plan_native(nl, frac_axis, axis, walls, P, use_bond_graph) -> PartitionPlan:
    """The slab plan from the native partitioner
    (``distmlip_tpu/partition/partitioner.py:224-281``): the C++ side returns
    the per-partition layout; the fields it does not return (``g2l``,
    ``edge_offsets``, ``nodes_to_partition``, ``bond_needs_in_line``) are
    derived here as the numpy path derives them."""
    from ..neighbors import native

    try:
        parts = native.native_partition(nl.src, nl.dst, frac_axis, walls, P,
                                        nl.bond_mask if use_bond_graph else None,
                                        use_bond_graph)
    except native.MultiPeerNode as e:
        raise PartitionError(str(e)) from e
    n = nl.wrapped_cart.shape[0]
    plan = PartitionPlan(P, axis, walls, which_partition(walls, frac_axis),
                         np.full(n, -1, dtype=np.int64))
    for d in parts:
        gids, markers = d["global_ids"], d["node_markers"]
        g2l = np.full(n, -1, dtype=np.int64)
        g2l[gids] = np.arange(len(gids))
        plan.global_ids.append(gids)
        plan.node_markers.append(markers)
        plan.g2l.append(g2l)
        plan.edge_ids.append(d["edge_ids"])
        plan.src_local.append(d["src_local"])
        plan.dst_local.append(d["dst_local"])
        plan.edge_offsets.append(nl.offsets[d["edge_ids"]])
        for q in range(P):
            plan.nodes_to_partition[gids[markers[1 + q]:markers[2 + q]]] = q
    if use_bond_graph:
        W = np.nonzero(nl.bond_mask)[0]
        if np.any(nl.src[W] == nl.dst[W]):
            import warnings

            warnings.warn(
                "Found self-loop edge within bond cutoff (cell smaller than bond "
                "graph cutoff); line-graph results may be incorrect.",
                stacklevel=3,
            )
        plan.has_bond_graph = True
        for d in parts:
            needs_in_line = np.zeros(len(d["bond_global_edge"]), dtype=bool)
            needs_in_line[:int(d["bond_markers"][1 + P])] = True  # pure + to sections
            plan.bond_markers.append(d["bond_markers"])
            plan.bond_global_edge.append(d["bond_global_edge"])
            plan.bond_needs_in_line.append(needs_in_line)
            plan.line_src.append(d["line_src"])
            plan.line_dst.append(d["line_dst"])
            plan.line_center_local.append(d["line_center"])
            plan.bond_mapping_edge.append(d["bm_edge"])
            plan.bond_mapping_bond.append(d["bm_bond"])
    return plan


def _line_graph_join(g2l, src, dst, b_edge, needs_in_line):
    """Directed line-graph join: a.dst == b.src, b locally computed, no
    backtracking; returns (line_src, line_dst, center_local)."""
    a_src, a_dst = src[b_edge], dst[b_edge]
    nb = len(b_edge)
    nil_idx = np.nonzero(needs_in_line)[0]
    if nb == 0 or len(nil_idx) == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    b_src_nil = a_src[nil_idx]
    order = np.argsort(b_src_nil, kind="stable")
    sorted_bsrc = b_src_nil[order]
    grp_start = np.searchsorted(sorted_bsrc, a_dst, side="left")
    grp_end = np.searchsorted(sorted_bsrc, a_dst, side="right")
    cnt = grp_end - grp_start
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    a_rep = np.repeat(np.arange(nb), cnt)
    starts_rep = np.repeat(grp_start, cnt)
    csum = np.concatenate([[0], np.cumsum(cnt)])
    intra = np.arange(total) - np.repeat(csum[:-1], cnt)
    b_sel = nil_idx[order[starts_rep + intra]]
    keep = a_dst[b_sel] != a_src[a_rep]
    l_src = a_rep[keep].astype(np.int64)
    l_dst = b_sel[keep].astype(np.int64)
    centers = g2l[a_src[l_dst]]
    if np.any(centers < 0):
        raise PartitionError("internal error: line-graph center atom not local")
    return l_src, l_dst, centers.astype(np.int64)


def _single_partition_plan(nl: NeighborList, use_bond_graph: bool = False) -> PartitionPlan:
    n = nl.wrapped_cart.shape[0]
    plan = PartitionPlan(
        1, 0, np.zeros(0), np.zeros(n, np.int64), np.full(n, -1, np.int64)
    )
    gids = np.arange(n, dtype=np.int64)
    plan.global_ids.append(gids)
    plan.node_markers.append(np.array([0, n, n, n], dtype=np.int64))
    plan.g2l.append(gids.copy())
    eids = np.arange(nl.num_edges, dtype=np.int64)
    plan.edge_ids.append(eids)
    plan.src_local.append(nl.src.astype(np.int64))
    plan.dst_local.append(nl.dst.astype(np.int64))
    plan.edge_offsets.append(nl.offsets)
    if use_bond_graph:
        _build_bond_graph(plan, nl)
    return plan


def _build_bond_graph(plan: PartitionPlan, nl: NeighborList) -> None:
    """Directed line graph over the edges within the bond cutoff.

    Bond-graph node = directed atom-graph edge with d <= bond_r, in edge
    order. Line-graph edge a->b exists when a = (s->d), b = (d->k), k != s
    (no backtracking), and b is computed locally (``needs_in_line``); the
    angle's center atom is d. A bond node lives wherever its dst atom is
    visible, in the layout [pure | to_* | from_*] of its dst atom's
    section; owned bonds (pure + to) are computed here and map back onto
    their local edge, halo bonds (from) receive their features by the bond
    exchange. At P=1 every bond node is owned.
    """
    P = plan.num_partitions
    src, dst = nl.src, nl.dst
    ntp = plan.nodes_to_partition
    node_part = plan.node_part
    W = np.nonzero(nl.bond_mask)[0]  # global edge ids within bond_r, edge order
    if np.any(src[W] == dst[W]):
        import warnings

        warnings.warn(
            "Found self-loop edge within bond cutoff (cell smaller than bond "
            "graph cutoff); line-graph results may be incorrect.",
            stacklevel=3,
        )

    plan.has_bond_graph = True
    for p in range(P):
        g2l = plan.g2l[p]
        Wv = W[g2l[dst[W]] != -1]
        d_v = dst[Wv]
        is_from = ntp[d_v] == p if P > 1 else np.zeros(len(Wv), bool)
        is_to = (ntp[d_v] != -1) & (ntp[d_v] != p) if P > 1 else np.zeros(len(Wv), bool)
        is_pure = (~is_from) & (~is_to) & (node_part[d_v] == p)

        sections = [Wv[is_pure]]
        for q in range(P):
            sections.append(Wv[is_to & (ntp[d_v] == q)])
        for q in range(P):
            sections.append(Wv[is_from & (node_part[d_v] == q)] if q != p
                            else np.zeros(0, np.int64))
        b_edge = np.concatenate(sections)  # bond-node -> global edge id
        markers = np.concatenate([[0], np.cumsum([len(x) for x in sections])]).astype(np.int64)
        owned_b = int(markers[1 + P])
        needs_in_line = np.zeros(len(b_edge), dtype=bool)
        needs_in_line[:owned_b] = True  # pure + to sections are computed here

        plan.bond_markers.append(markers)
        plan.bond_global_edge.append(b_edge)
        plan.bond_needs_in_line.append(needs_in_line)

        # edge<->bond feature mapping for locally computed bond nodes
        e_g2l = np.full(nl.num_edges, -1, dtype=np.int64)
        e_g2l[plan.edge_ids[p]] = np.arange(len(plan.edge_ids[p]))
        local_e = e_g2l[b_edge[:owned_b]]
        if np.any(local_e < 0):
            raise PartitionError("internal error: owned bond node's edge not local")
        plan.bond_mapping_edge.append(local_e)
        plan.bond_mapping_bond.append(np.arange(owned_b, dtype=np.int64))

        l_src, l_dst, centers = _line_graph_join(g2l, src, dst, b_edge, needs_in_line)
        plan.line_src.append(l_src)
        plan.line_dst.append(l_dst)
        plan.line_center_local.append(centers)
