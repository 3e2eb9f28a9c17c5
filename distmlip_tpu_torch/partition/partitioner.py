"""Spatial graph partitioner, single-partition branch.

At P=1 the whole structure is one partition: every node is owned, there is
no halo, and every edge is local. With ``use_bond_graph`` the plan also
carries CHGNet's bond graph (edges within the bond cutoff) and its directed
line graph (``distmlip_tpu/partition/partitioner.py:526-650``, the P=1
branch). Multi-partition slab and block plans (the halo sets,
owner-computes edge assignment across slabs, bond halos, and the native
partitioner) are queued in ROADMAP.md ("P>1 graph parallelism").
"""

from __future__ import annotations

import numpy as np

from ..neighbors.python_ref import NeighborList
from .plan import PartitionPlan


class PartitionError(RuntimeError):
    pass


def build_plan(
    nl: NeighborList,
    lattice: np.ndarray,
    pbc,
    num_partitions: int,
    r: float,
    bond_r: float = 0.0,
    use_bond_graph: bool = False,
    grid: tuple | None = None,
) -> PartitionPlan:
    """Partition a neighbor graph; only ``num_partitions == 1`` is ported.

    ``use_bond_graph`` adds the bond and line graphs over the edges the
    neighbor list marks within ``bond_r`` (``nl.bond_mask``). Raises
    ``NotImplementedError`` for P>1 and block grids, naming the ROADMAP
    item that ports them.
    """
    if int(num_partitions) < 1:
        raise PartitionError("num_partitions must be >= 1")
    if int(num_partitions) != 1 or (grid is not None and int(np.prod(grid)) != 1):
        raise NotImplementedError(
            f"num_partitions={num_partitions}: only P=1 is ported; P>1 slab "
            "and block plans are ROADMAP.md queue A item 'P>1 graph "
            "parallelism'")
    return _single_partition_plan(nl, use_bond_graph)


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
    """Directed line graph over the edges within the bond cutoff, at P=1.

    Bond-graph node = directed atom-graph edge with d <= bond_r, in edge
    order. Line-graph edge a->b exists when a = (s->d), b = (d->k), k != s
    (no backtracking); the angle's center atom is d. At one partition every
    bond node is owned and computed here, so every one takes in-lines and
    maps back onto its own edge.
    """
    src, dst = nl.src, nl.dst
    W = np.nonzero(nl.bond_mask)[0]  # global edge ids within bond_r, edge order
    if np.any(src[W] == dst[W]):
        import warnings

        warnings.warn(
            "Found self-loop edge within bond cutoff (cell smaller than bond "
            "graph cutoff); line-graph results may be incorrect.",
            stacklevel=3,
        )
    plan.has_bond_graph = True
    nb = len(W)
    plan.bond_markers.append(np.array([0, nb, nb, nb], dtype=np.int64))
    plan.bond_global_edge.append(W)
    needs_in_line = np.ones(nb, dtype=bool)
    plan.bond_needs_in_line.append(needs_in_line)
    # edge ids are the global ones at P=1
    plan.bond_mapping_edge.append(W.astype(np.int64))
    plan.bond_mapping_bond.append(np.arange(nb, dtype=np.int64))
    l_src, l_dst, centers = _line_graph_join(plan.g2l[0], src, dst, W, needs_in_line)
    plan.line_src.append(l_src)
    plan.line_dst.append(l_dst)
    plan.line_center_local.append(centers)
