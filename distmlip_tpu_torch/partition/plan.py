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

The same layout is used for bond-graph nodes (directed edges within the
bond cutoff promoted to line-graph nodes); at P=1 every bond node is owned.

The port builds single-partition plans and 1-D slab plans (P > 1, per-peer
to/from marker sections). Block plans (a grid decomposition with explicit
halo send/recv lists) are queued in ROADMAP.md.
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

    # bond graph (optional)
    has_bond_graph: bool = False
    bond_markers: list = field(default_factory=list)       # [p] -> (2P+2,)
    bond_global_edge: list = field(default_factory=list)   # [p] -> (B_p,) global DE ids
    bond_needs_in_line: list = field(default_factory=list) # [p] -> (B_p,) bool
    line_src: list = field(default_factory=list)           # [p] -> (L_p,) local bond ids
    line_dst: list = field(default_factory=list)
    line_center_local: list = field(default_factory=list)  # [p] -> (L_p,) local atom ids
    bond_mapping_edge: list = field(default_factory=list)  # [p] -> (M_p,) local edge ids
    bond_mapping_bond: list = field(default_factory=list)  # [p] -> (M_p,) local bond ids

    @property
    def kind(self) -> str:
        """Layout family of this plan: ``"single"`` (P == 1) or ``"slab"``
        (1-D slabs, per-peer to/from marker sections)."""
        return "single" if self.num_partitions == 1 else "slab"

    @property
    def owned_counts(self) -> np.ndarray:
        """Number of owned (pure + to) nodes per partition."""
        P = self.num_partitions
        return np.array([m[1 + P] for m in self.node_markers])

    def edge_is_frontier(self, p: int) -> np.ndarray:
        """(E_p,) bool: edges whose src row is a halo node (dst is always
        owned under owner-computes). Interior edges (both endpoints owned)
        need no halo row; frontier edges read the exchanged rows."""
        oc = int(self.owned_counts[p])
        return np.asarray(self.src_local[p]) >= oc

    def section(self, p: int, kind: str, q: int) -> tuple[int, int]:
        """Local index range of a node section of partition ``p``: ``kind``
        in {"to", "from"}, peer ``q``."""
        return _section(self.node_markers[p], self.num_partitions, kind, q)

    def bond_section(self, p: int, kind: str, q: int) -> tuple[int, int]:
        """The same for the bond-graph nodes."""
        return _section(self.bond_markers[p], self.num_partitions, kind, q)

    def summary(self) -> str:
        """Partition-balance report: owned (pure), halo and edge counts per
        partition, and bond and line counts with a bond graph."""
        P = self.num_partitions
        lines = [f"PartitionPlan(P={P}, axis={self.axis})"]
        for p in range(P):
            m = self.node_markers[p]
            owned = m[1 + P]
            halo = m[-1] - owned
            ne = len(self.edge_ids[p]) if self.edge_ids else 0
            extra = ""
            if self.has_bond_graph:
                extra = f", bonds={self.bond_markers[p][-1]}, lines={len(self.line_src[p])}"
            lines.append(
                f"  partition {p}: owned={owned} (pure={m[1]}), halo={halo}, edges={ne}{extra}")
        return "\n".join(lines)


def _section(markers, P: int, kind: str, q: int) -> tuple[int, int]:
    if kind == "to":
        return int(markers[1 + q]), int(markers[2 + q])
    if kind == "from":
        return int(markers[1 + P + q]), int(markers[2 + P + q])
    raise ValueError(kind)
