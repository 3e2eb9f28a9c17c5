"""Host-side partition plan: the output of the spatial graph partitioner.

A ``PartitionPlan`` holds, per partition, numpy arrays describing the local
node/edge layout. It is later padded to static capacities and stacked into
a ``PartitionedGraph`` by ``distmlip_tpu_torch.partition.graph``.

Layout convention (reference global-id arrays + markers,
subgraph_creation_utils.c:1102-1154, dist.py:44-51; markers are plain
cumulative-count vectors of length 2P+2):

  local node order = [ pure | to_0 .. to_{P-1} | from_0 .. from_{P-1} ]

  node_markers[p] = [0, n_pure, .. cumulative .., n_total]
    - owned nodes  = locals [0, owned_count)   (pure + all to-sections)
    - halo nodes   = locals [owned_count, total)

This port builds single-partition plans only (P=1); multi-partition slab
and block plans are queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PartitionPlan:
    num_partitions: int
    axis: int                       # slab axis (index into lattice rows)
    walls: np.ndarray               # (P-1,) fractional wall positions
    node_part: np.ndarray           # (N,) owner partition of each global node
    nodes_to_partition: np.ndarray  # (N,) partition a border node is sent to, else -1

    # per-partition node layout
    global_ids: list = field(default_factory=list)     # [p] -> (n_p,) local->global
    node_markers: list = field(default_factory=list)   # [p] -> (2P+2,) cumulative
    g2l: list = field(default_factory=list)            # [p] -> (N,) global->local or -1

    # per-partition edges (owner-computes: edge lives with its dst's owner)
    edge_ids: list = field(default_factory=list)       # [p] -> (E_p,) global edge ids
    src_local: list = field(default_factory=list)
    dst_local: list = field(default_factory=list)
    edge_offsets: list = field(default_factory=list)   # [p] -> (E_p, 3) int32

    @property
    def owned_counts(self) -> np.ndarray:
        """Number of owned (pure + to) nodes per partition."""
        P = self.num_partitions
        return np.array([m[1 + P] for m in self.node_markers])
