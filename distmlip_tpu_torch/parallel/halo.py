"""The LocalGraph view of a PartitionedGraph and its edge/node reductions.

At P=1 the whole graph is one partition: the halo exchanges (atom and
bond) are the identity and the global reductions are local sums.

At P > 1 the port runs the P partitions on one card as ONE flattened graph
(``partition/graph.py``, ``PartitionedGraph.flat``): partition p owns node
rows ``[p n_cap, (p+1) n_cap)``, and the edges are laid out as [interior
of every partition | frontier of every partition]. The JAX package's ring
exchange (``distmlip_tpu/parallel/halo.py`` ``_exchange`` /
``_coalesced_round``: gather, ``ppermute``, scatter) becomes one
``index_select`` of the owners' rows and one out-of-place ``index_copy``
into the halo rows, over index vectors built on the host. Autograd
carries each halo row's gradient back to its owner's row through the
copy, as JAX transposes the ``ppermute`` and as the reference's autograd
runs through device copies. The sums over partitions (``psum``) are the
identity: a sum over the flattened rows already covers every partition.

The edge aggregations honour the interior/frontier split as the JAX
package's do: each segment is dst-sorted, their concatenation is not, so
each goes to the kernel dispatcher on its own and the two partial sums are
added, interior first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..kernels.dispatch import Gather, fused_edge_aggregate, fused_segment_sum
from ..telemetry.trace import scope


def _copy_rows(feats, send, recv):
    """``feats`` with rows ``recv`` replaced by rows ``send`` (out of place,
    so autograd routes each copied row's gradient to its source row)."""
    return feats.index_copy(0, recv, feats.index_select(0, send))


@dataclass
class LocalGraph:
    """The graph a model runs on: one partition (P=1), or the P partitions
    flattened into one graph (module docstring).

    Models call the methods below instead of touching the layout or the
    exchange. Edge layout contract: ``edge_dst`` is nondecreasing within
    each of the interior ``[0, e_split)`` and frontier ``[e_split, e_cap)``
    segments (``e_split == e_cap``: one unsplit segment); each segment
    holds its real rows first and its masked padding after them, on the
    segment's last real dst (a kernel walks a dst row's whole edge range,
    padding in the middle of a segment included); interior edges read
    owned rows only, frontier edges read halo src rows. ``line_dst`` is
    nondecreasing over the whole array, its padding likewise at the tail.
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
    # block-diagonally packed batch (``partition/batch.py``): structure
    # slots and the (n_cap,) slot of each node row, the sentinel
    # ``batch_size`` on padded rows; 0 / None on a single-structure graph
    batch_size: int = 0
    struct_id: Any = None
    # interior/frontier boundary of the edge rows (== e_cap: unsplit)
    e_split: int = -1
    # halo exchange index vectors (P > 1; None at P = 1): rows copied
    # from, rows copied into; atom rows and bond rows
    halo_send: Any = None
    halo_recv: Any = None
    bond_halo_send: Any = None
    bond_halo_recv: Any = None

    @property
    def has_frontier_split(self) -> bool:
        return 0 <= self.e_split < self.e_cap

    def halo_exchange(self, feats):
        """Refresh the halo rows of a node feature array from their
        owners' rows: the identity at P=1."""
        if self.halo_send is None:
            return feats
        with scope("halo/exchange"):
            return _copy_rows(feats, self.halo_send, self.halo_recv)

    def bond_halo_exchange(self, feats):
        """Refresh the halo rows of a bond-node feature array: the identity
        at P=1 and without a bond graph."""
        if self.bond_halo_send is None or not self.has_bond_graph:
            return feats
        with scope("halo/bond_exchange"):
            return _copy_rows(feats, self.bond_halo_send, self.bond_halo_recv)

    def exchange_all(self, node_feats=(), bond_feats=()):
        """Refresh several node and bond feature arrays at one sync point
        (``distmlip_tpu/parallel/halo.py:239``); returns ``(node_feats,
        bond_feats)`` tuples in input order. One copy per array: on one
        card there is no collective to coalesce them into."""
        return (tuple(self.halo_exchange(f) for f in node_feats),
                tuple(self.bond_halo_exchange(f) for f in bond_feats))

    def psum(self, x):
        """Sum over the partitions (``distmlip_tpu/parallel/halo.py:271``):
        the identity, since the flattened rows are every partition's."""
        return x

    def edge_vectors(self, positions, lattice=None):
        """(E_cap, 3) displacement vectors dst - src + offsets @ lattice;
        with no lattice on the graph (``lattice is None``, a packed batch
        whose offsets the batched runtime made Cartesian and strained per
        structure) dst - src + offsets.

        ``index_select``, not ``positions[ids]``: its backward is an
        ``index_add_``, where advanced indexing's is a sort-based
        ``index_put_`` that took ~34 ms per gather at 918k edges on an
        H100 80GB HBM3 at 700 W (``tools/step_profile.py``, PERF.md)."""
        lat = self.lattice if lattice is None else lattice
        disp = (positions.index_select(0, self.edge_dst)
                - positions.index_select(0, self.edge_src))
        if lat is None:
            return disp + self.edge_offset.to(positions.dtype)
        return disp + self.edge_offset.to(positions.dtype) @ lat

    def _segments(self):
        """The edge row slices of the sorted segments: one, or interior
        then frontier."""
        if not self.has_frontier_split:
            return (slice(None),)
        return slice(0, self.e_split), slice(self.e_split, None)

    def aggregate_edges(self, data, mask=None):
        """Segment-sum per-edge rows onto their dst nodes ((n_cap, ...)),
        through the kernel dispatcher, once per sorted segment
        (``distmlip_tpu/parallel/halo.py:284``)."""
        out = None
        for sl in self._segments():
            part = fused_segment_sum(data[sl], self.edge_dst[sl], self.n_cap,
                                     None if mask is None else mask[sl],
                                     indices_are_sorted=True, kernels=self.kernels)
            out = part if out is None else out + part
        return out

    def aggregate_edge_messages(self, message, edge_inputs, mask=None):
        """Fused per-edge message + dst aggregation ((n_cap, ...)), through
        the kernel dispatcher, once per sorted segment
        (``distmlip_tpu/parallel/halo.py:308``).

        ``message`` is a ``kernels.EdgeMessage``; ``edge_inputs`` mixes
        per-edge tensors with ``kernels.Gather`` markers. With the kernel
        the (E, ...) message tensor is never written out.
        """
        out = None
        for sl in self._segments():
            # one slice per distinct index tensor: inputs gathered at the
            # same ids keep sharing one (the TensorNet interaction's kernel
            # takes I, A and S at one src tensor)
            idx = {}
            sliced = [Gather(i.node, idx.setdefault(id(i.idx), i.idx[sl]))
                      if isinstance(i, Gather) else i[sl] for i in edge_inputs]
            part = fused_edge_aggregate(message, sliced, self.edge_dst[sl], self.n_cap,
                                        None if mask is None else mask[sl],
                                        indices_are_sorted=True, kernels=self.kernels)
            out = part if out is None else out + part
        return out

    def overlapped_edge_sum(self, message, v_pre, v_post, edge_data=(), mask=None,
                            weights=()):
        """Per-edge messages ``message(v[src], v_pre[dst], *edge_data)``
        summed to dst (``distmlip_tpu/parallel/halo.py:349``). ``v_post`` is
        the node array after the halo exchange of ``v_pre``. The interior
        segment reads ``v_pre`` at both ends (its rows are owned, equal in
        both) and the frontier segment ``v_post`` at src and ``v_pre`` at
        dst, as in the JAX package, where the interior's work overlaps the
        exchange in flight; the partial sums are added interior first. An
        unsplit graph is one interior segment: at P=1 ``v_post is v_pre``,
        and at P > 1 no edge of it reads a halo row. ``weights`` go to the
        message as explicit tensors."""
        out = None
        for sl, v in zip(self._segments(), (v_pre, v_post)):
            part = fused_edge_aggregate(
                message, [Gather(v, self.edge_src[sl]), Gather(v_pre, self.edge_dst[sl]),
                          *[d[sl] for d in edge_data]],
                self.edge_dst[sl], self.n_cap, None if mask is None else mask[sl],
                indices_are_sorted=True, kernels=self.kernels, weights=weights)
            out = part if out is None else out + part
        return out

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

    def structure_sum(self, per_atom):
        """Per-structure sums of a per-atom quantity over the owned rows of
        a packed graph: (batch_size,) in ``per_atom``'s dtype
        (``distmlip_tpu/parallel/halo.py:428``). Padded rows carry the
        sentinel slot ``batch_size``: they sum into one extra slot that is
        dropped, as ``jax.ops.segment_sum`` drops an out-of-range id (an
        index of ``batch_size`` into ``batch_size`` slots would be a device
        assert on the card)."""
        if self.struct_id is None or self.batch_size <= 0:
            raise ValueError("structure_sum requires a packed graph (struct_id + "
                             "batch_size); build it with pack_structures()")
        e = torch.where(self.owned_mask, per_atom.reshape(-1), per_atom.new_zeros(()))
        out = per_atom.new_zeros(self.batch_size + 1).index_add(0, self.struct_id.long(), e)
        return self.psum(out[:-1])

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
    """The LocalGraph of a PartitionedGraph of tensors: its one partition
    (P=1, the leading axis squeezed), or its flattened view (P > 1)."""
    common = dict(lattice=g.lattice, kernels=kernels, has_bond_graph=g.has_bond_graph,
                  system=g.system, batch_size=g.batch_size)
    if g.num_partitions == 1:
        return LocalGraph(
            n_cap=g.n_cap, e_cap=g.e_cap, e_split=g.e_split,
            species=g.species[0], owned_mask=g.owned_mask[0],
            edge_src=g.edge_src[0], edge_dst=g.edge_dst[0],
            edge_offset=g.edge_offset[0], edge_mask=g.edge_mask[0],
            b_cap=g.b_cap, line_src=g.line_src[0], line_dst=g.line_dst[0],
            line_mask=g.line_mask[0], line_center=g.line_center[0],
            bond_map_edge=g.bond_map_edge[0], bond_map_bond=g.bond_map_bond[0],
            bond_map_mask=g.bond_map_mask[0],
            struct_id=None if g.struct_id is None else g.struct_id[0], **common)
    P, f = g.num_partitions, g.flat
    return LocalGraph(
        n_cap=P * g.n_cap, e_cap=P * g.e_cap, e_split=P * g.e_split,
        species=g.species.reshape(-1), owned_mask=g.owned_mask.reshape(-1),
        edge_src=f["edge_src"], edge_dst=f["edge_dst"], edge_offset=f["edge_offset"],
        edge_mask=f["edge_mask"], b_cap=P * g.b_cap,
        line_src=f["line_src"], line_dst=f["line_dst"], line_mask=f["line_mask"],
        line_center=f["line_center"], bond_map_edge=f["bond_map_edge"],
        bond_map_bond=f["bond_map_bond"], bond_map_mask=f["bond_map_mask"],
        halo_send=f["halo_send"], halo_recv=f["halo_recv"],
        bond_halo_send=f["bond_halo_send"], bond_halo_recv=f["bond_halo_recv"],
        **common)
