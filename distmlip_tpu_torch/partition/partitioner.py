"""Spatial graph partitioner, single-partition branch.

At P=1 the whole structure is one partition: every node is owned, there is
no halo, and every edge is local. Multi-partition slab and block plans (the
halo sets, owner-computes edge assignment across slabs, and the native
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

    Raises ``NotImplementedError`` for P>1, block grids and bond (line)
    graphs, naming the ROADMAP item that ports them.
    """
    if int(num_partitions) < 1:
        raise PartitionError("num_partitions must be >= 1")
    if int(num_partitions) != 1 or (grid is not None and int(np.prod(grid)) != 1):
        raise NotImplementedError(
            f"num_partitions={num_partitions}: only P=1 is ported; P>1 slab "
            "and block plans are ROADMAP.md queue A item 'P>1 graph "
            "parallelism'")
    if use_bond_graph:
        raise NotImplementedError(
            "bond (line) graphs are ported with CHGNet (ROADMAP.md queue A)")
    return _single_partition_plan(nl)


def _single_partition_plan(nl: NeighborList) -> PartitionPlan:
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
    return plan
