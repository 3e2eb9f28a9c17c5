"""The LocalGraph shard view and its edge/node reductions.

At P=1 the whole graph is one shard: the halo exchange is the identity and
the global reductions are local sums. The ring exchange of P>1 slabs
(``distmlip_tpu/parallel/halo.py`` ``_exchange``/``_coalesced_round``;
``torch.distributed`` here), and with it the interior/frontier edge split,
are queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..kernels.dispatch import fused_segment_sum


@dataclass
class LocalGraph:
    """Per-shard view of a PartitionedGraph (leading P axis squeezed away).

    Passed to model functions; carries the local edge lists and masks.
    Models call the methods below instead of touching communication
    directly. ``edge_dst`` is nondecreasing (the dst-sorted layout
    contract the segment-sum kernel relies on).
    """

    n_cap: int
    e_cap: int
    species: Any
    owned_mask: Any
    edge_src: Any
    edge_dst: Any
    edge_offset: Any
    edge_mask: Any
    lattice: Any
    # True: CUDA kernels for CUDA tensors; False: the plain versions
    kernels: bool = True

    def halo_exchange(self, feats):
        """Refresh halo rows of a node feature array: the identity at P=1,
        where every row is owned."""
        return feats

    def edge_vectors(self, positions, lattice=None):
        """(E_cap, 3) displacement vectors dst - src + offsets @ lattice."""
        lat = self.lattice if lattice is None else lattice
        disp = positions[self.edge_dst] - positions[self.edge_src]
        return disp + self.edge_offset.to(positions.dtype) @ lat

    def aggregate_edges(self, data, mask=None):
        """Segment-sum per-edge rows onto their dst nodes ((n_cap, ...)),
        through the kernel dispatcher."""
        return fused_segment_sum(data, self.edge_dst, self.n_cap, mask,
                                 indices_are_sorted=True, kernels=self.kernels)

    def owned_sum(self, per_atom):
        """Sum a per-atom quantity over owned nodes."""
        m = self.owned_mask.to(per_atom.dtype)
        return (per_atom * m.reshape(m.shape + (1,) * (per_atom.ndim - 1))).sum()


def local_graph_from_stacked(g, kernels: bool = True) -> LocalGraph:
    """Build a LocalGraph from a single-partition PartitionedGraph of
    tensors (leading P=1 axis squeezed)."""
    if g.num_partitions != 1:
        raise NotImplementedError(
            f"P={g.num_partitions}: only single-partition graphs are ported "
            "(ROADMAP.md queue A item 'P>1 graph parallelism')")
    return LocalGraph(
        n_cap=g.n_cap,
        e_cap=g.e_cap,
        species=g.species[0],
        owned_mask=g.owned_mask[0],
        edge_src=g.edge_src[0],
        edge_dst=g.edge_dst[0],
        edge_offset=g.edge_offset[0],
        edge_mask=g.edge_mask[0],
        lattice=g.lattice,
        kernels=kernels,
    )
