"""The LocalGraph shard view and its edge/node reductions.

At P=1 the whole graph is one shard: the halo exchanges (atom and bond)
are the identity and the global reductions are local sums. The ring
exchange of P>1 slabs (``distmlip_tpu/parallel/halo.py``
``_exchange``/``_coalesced_round``; ``torch.distributed`` here), and with
it the interior/frontier edge split, are queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..kernels.dispatch import Gather, fused_edge_aggregate, fused_segment_sum


@dataclass
class LocalGraph:
    """Per-shard view of a PartitionedGraph (leading P axis squeezed away).

    Passed to model functions; carries the local edge lists and masks.
    Models call the methods below instead of touching communication
    directly. ``edge_dst`` is nondecreasing (the dst-sorted layout
    contract the segment-sum kernel relies on); so is ``line_dst``.
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
    # bond graph (CHGNet); b_cap = 0 and width-0 arrays without one
    has_bond_graph: bool = False
    b_cap: int = 0
    line_src: Any = None
    line_dst: Any = None
    line_mask: Any = None
    line_center: Any = None
    bond_map_edge: Any = None
    bond_map_bond: Any = None
    bond_map_mask: Any = None
    # per-system scalars {"charge", "spin", "dataset"} (0-d int32 tensors)
    system: Any = None
    # batched multi-structure packing (the JAX package's batched engine,
    # not ported): 0 / None on every graph this package builds, so a model
    # can refuse a packed graph
    batch_size: int = 0
    struct_id: Any = None

    def halo_exchange(self, feats):
        """Refresh halo rows of a node feature array: the identity at P=1,
        where every row is owned."""
        return feats

    def bond_halo_exchange(self, feats):
        """Refresh halo rows of a bond-node feature array: the identity at
        P=1."""
        return feats

    def exchange_all(self, node_feats=(), bond_feats=()):
        """Refresh several node and bond feature arrays at one sync point
        (``distmlip_tpu/parallel/halo.py:239``); returns ``(node_feats,
        bond_feats)`` tuples in input order. The identity at P=1."""
        return tuple(node_feats), tuple(bond_feats)

    def psum(self, x):
        """Sum over the partitions (``distmlip_tpu/parallel/halo.py:271``):
        the identity at P=1."""
        return x

    def edge_vectors(self, positions, lattice=None):
        """(E_cap, 3) displacement vectors dst - src + offsets @ lattice.

        ``index_select``, not ``positions[ids]``: its backward is an
        ``index_add_``, where advanced indexing's is a sort-based
        ``index_put_`` that took ~34 ms per gather at 918k edges on an
        H100 80GB HBM3 at 700 W (``tools/step_profile.py``, PERF.md)."""
        lat = self.lattice if lattice is None else lattice
        disp = (positions.index_select(0, self.edge_dst)
                - positions.index_select(0, self.edge_src))
        return disp + self.edge_offset.to(positions.dtype) @ lat

    def aggregate_edges(self, data, mask=None):
        """Segment-sum per-edge rows onto their dst nodes ((n_cap, ...)),
        through the kernel dispatcher."""
        return fused_segment_sum(data, self.edge_dst, self.n_cap, mask,
                                 indices_are_sorted=True, kernels=self.kernels)

    def aggregate_edge_messages(self, message, edge_inputs, mask=None):
        """Fused per-edge message + dst aggregation ((n_cap, ...)), through
        the kernel dispatcher (``distmlip_tpu/parallel/halo.py:308``, its
        unsplit branch: the interior/frontier split is P>1 work).

        ``message`` is a ``kernels.EdgeMessage``; ``edge_inputs`` mixes
        per-edge tensors with ``kernels.Gather`` markers. With the kernel
        the (E, ...) message tensor is never written out.
        """
        return fused_edge_aggregate(message, edge_inputs, self.edge_dst, self.n_cap,
                                    mask, indices_are_sorted=True,
                                    kernels=self.kernels)

    def overlapped_edge_sum(self, message, v_pre, v_post, edge_data=(), mask=None,
                            weights=()):
        """Per-edge messages ``message(v_post[src], v_post[dst], *edge_data)``
        summed to dst (``distmlip_tpu/parallel/halo.py:349``, its unsplit
        branch). ``v_pre`` is the node array before the halo exchange that
        gave ``v_post``; with the interior/frontier split (P>1) interior
        edges read it so their compute overlaps the exchange. ``weights``
        go to the message as explicit tensors."""
        return fused_edge_aggregate(
            message, [Gather(v_post, self.edge_src), Gather(v_post, self.edge_dst),
                      *edge_data],
            self.edge_dst, self.n_cap, mask, indices_are_sorted=True,
            kernels=self.kernels, weights=weights)

    # ---- bond-graph index remaps (distmlip_tpu/parallel/halo.py:394-425) ----
    def edge_to_bond(self, edge_feats, bond_feats):
        """Seed owned bond-node rows from their atom-graph edge features:
        ``bond_feats`` with rows ``bond_map_bond`` set to ``edge_feats``'s
        rows ``bond_map_edge``, where the map is valid."""
        return _set_rows(bond_feats, self.bond_map_bond, self.bond_map_mask,
                         edge_feats.index_select(0, self.bond_map_edge))

    def bond_to_edge(self, bond_feats, edge_feats):
        """Write owned bond-node features back onto their edges:
        ``edge_feats`` with rows ``bond_map_edge`` set to ``bond_feats``'s
        rows ``bond_map_bond``, where the map is valid. The edge ids are
        bond-ordered, not sorted."""
        return _set_rows(edge_feats, self.bond_map_edge, self.bond_map_mask,
                         bond_feats.index_select(0, self.bond_map_bond))

    def owned_sum(self, per_atom):
        """Sum a per-atom quantity over owned nodes."""
        m = self.owned_mask.to(per_atom.dtype)
        return (per_atom * m.reshape(m.shape + (1,) * (per_atom.ndim - 1))).sum()


def _set_rows(target, idx, mask, vals):
    """``target`` with rows ``idx[mask]`` set to ``vals[mask]``: the JAX
    ``target.at[where(mask, idx, len(target))].set(vals, mode="drop")``.
    Masked rows land in one extra row that is sliced off, so no host sync
    selects them; the valid ids are distinct. Out of place and
    differentiable with set semantics: an overwritten target row gets no
    gradient, each written row's gradient goes to its source row."""
    n = target.shape[0]
    ext = torch.cat([target, target.new_zeros((1,) + tuple(target.shape[1:]))])
    sink = torch.full_like(idx, n)
    ext = ext.index_copy(0, torch.where(mask, idx, sink).long(), vals)
    return ext[:n]


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
        has_bond_graph=g.has_bond_graph,
        b_cap=g.b_cap,
        line_src=g.line_src[0],
        line_dst=g.line_dst[0],
        line_mask=g.line_mask[0],
        line_center=g.line_center[0],
        bond_map_edge=g.bond_map_edge[0],
        bond_map_bond=g.bond_map_bond[0],
        bond_map_mask=g.bond_map_mask[0],
        system=g.system,
    )
