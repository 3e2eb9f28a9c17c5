"""PartitionedGraph: the capacity-padded graph, host arrays or device tensors.

All per-partition arrays keep a leading axis of size P (P=1 in this port),
so they compare like with like against the JAX package's graph. Static
shapes everywhere; validity is carried by masks. ``build_partitioned_graph``
returns numpy arrays; ``PartitionedGraph.to(device)`` turns them into torch
tensors on that device.

Only the fields a single-partition model reads are kept, among them the
bond section of CHGNet's bond and line graphs, and ``e_split`` (always
``e_cap`` at P=1). The halo tables (atom and bond), ring shifts and an
active interior/frontier split of the JAX graph serve P>1 and come with it
(ROADMAP.md queue A).

``refresh_edges`` and ``device_refresh_graph`` swap edges rebuilt on the
graph's device (``neighbors.device``) into a graph in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..neighbors.device import cell_list_neighbors
from .capacity import CapacityPolicy
from .plan import PartitionPlan

_default_caps = CapacityPolicy()

# array fields (everything but the statics)
ARRAY_FIELDS = ("positions", "species", "owned_mask", "edge_src", "edge_dst",
                "edge_offset", "edge_mask", "lattice", "line_src", "line_dst",
                "line_mask", "line_center", "bond_map_edge", "bond_map_bond",
                "bond_map_mask")


@dataclass
class PartitionedGraph:
    # --- static metadata ---
    num_partitions: int
    n_cap: int
    e_cap: int
    # interior/frontier boundary of the edge rows; e_split == e_cap is the
    # one unsplit segment that every P=1 graph has
    e_split: int

    # --- per-partition arrays, leading axis P ---
    positions: Any          # (P, N_cap, 3) owned rows valid
    species: Any            # (P, N_cap) int32
    owned_mask: Any         # (P, N_cap) bool — owned rows only
    edge_src: Any           # (P, E_cap) int32
    edge_dst: Any           # (P, E_cap) int32, nondecreasing; pads repeat the last
    edge_offset: Any        # (P, E_cap, 3) float
    edge_mask: Any          # (P, E_cap) bool
    lattice: Any            # (3, 3) replicated

    # --- bond graph (CHGNet), width 0 without one ---
    has_bond_graph: bool = False
    b_cap: int = 0
    line_src: Any = None    # (P, L_cap) int32 local bond ids
    line_dst: Any = None    # (P, L_cap) int32, nondecreasing; pads repeat the last
    line_mask: Any = None   # (P, L_cap) bool
    line_center: Any = None  # (P, L_cap) int32 local atom id of the angle's center
    bond_map_edge: Any = None  # (P, M_cap) int32 local (dst-sorted) edge id of a bond
    bond_map_bond: Any = None  # (P, M_cap) int32 local bond id
    bond_map_mask: Any = None  # (P, M_cap) bool

    # per-system replicated scalars (eSCN/UMA charge/spin/dataset
    # conditioning, distmlip_tpu/partition/graph.py:103-105):
    # {"charge", "spin", "dataset"}, () int32 each
    system: Any = None

    def to(self, device) -> "PartitionedGraph":
        """A copy whose array fields (and system scalars) are torch tensors
        on ``device`` (dtypes kept: int32 ids and scalars, bool masks, the
        build's float dtype)."""
        import torch

        def conv(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x.to(device)
            return torch.as_tensor(np.asarray(x)).to(device)

        system = (None if self.system is None
                  else {k: conv(v) for k, v in self.system.items()})
        return dataclasses.replace(
            self, system=system, **{k: conv(getattr(self, k)) for k in ARRAY_FIELDS})


@dataclass
class HostGraphData:
    """Host companions of a PartitionedGraph needed for reassembly."""

    plan: PartitionPlan
    global_ids: list = field(default_factory=list)
    owned_counts: np.ndarray | None = None
    # shape stats of the built graph (host numpy, before upload)
    stats: dict | None = None

    def scatter_global(self, global_arr: np.ndarray, n_cap: int, fill=0.0) -> np.ndarray:
        """Split a (N, ...) global array into padded (P, N_cap, ...) locals."""
        P = self.plan.num_partitions
        out = np.full((P, n_cap) + global_arr.shape[1:], fill, dtype=global_arr.dtype)
        for p in range(P):
            g = self.global_ids[p]
            out[p, : len(g)] = global_arr[g]
        return out

    def gather_owned(self, local_arr: np.ndarray, n_total: int) -> np.ndarray:
        """Reassemble a (P, N_cap, ...) owned-node array into (N, ...) global."""
        out = np.zeros((n_total,) + local_arr.shape[2:], dtype=local_arr.dtype)
        oc = self.owned_counts
        for p in range(self.plan.num_partitions):
            g = self.global_ids[p][: oc[p]]
            out[g] = local_arr[p, : oc[p]]
        return out


def build_partitioned_graph(
    plan: PartitionPlan,
    nl,
    species: np.ndarray,
    lattice: np.ndarray,
    caps: CapacityPolicy | None = None,
    dtype=np.float32,
    system: dict | None = None,
) -> tuple[PartitionedGraph, HostGraphData]:
    """Pad a single-partition plan into a PartitionedGraph (numpy arrays).

    ``system``: optional per-system scalars (charge, spin, dataset ints),
    the conditioning inputs of eSCN; missing ones default to 0.

    Edges are sorted by dst (stable) so segment reductions see sorted
    indices; padded edge rows repeat the last real dst (nondecreasing,
    in-bounds) and are masked. With a bond graph, line edges are sorted by
    dst bond (stable, padding repeating the last) and the bond map's edge
    ids follow the edge sort (``distmlip_tpu/partition/graph.py:347-382``).
    The same arrays as the JAX package's ``build_partitioned_graph`` at
    P=1, bit for bit.
    """
    if plan.num_partitions != 1:
        raise NotImplementedError(
            "build_partitioned_graph: only P=1 is ported (ROADMAP.md queue "
            "A item 'P>1 graph parallelism')")
    caps = caps or _default_caps
    P = 1
    n_cap = caps.get("nodes", int(plan.node_markers[0][-1]))
    ne = len(plan.edge_ids[0])
    e_cap = caps.get("edges", ne)

    positions = np.zeros((P, n_cap, 3), dtype=dtype)
    spec = np.zeros((P, n_cap), dtype=np.int32)
    owned_mask = np.zeros((P, n_cap), dtype=bool)
    edge_src = np.zeros((P, e_cap), dtype=np.int32)
    edge_dst = np.zeros((P, e_cap), dtype=np.int32)
    edge_offset = np.zeros((P, e_cap, 3), dtype=dtype)
    edge_mask = np.zeros((P, e_cap), dtype=bool)

    # positions live in the INPUT (unwrapped) frame — edge offsets are
    # reported relative to it, so MD positions drift out of the box freely
    input_cart = nl.wrapped_cart + nl.shift @ np.asarray(lattice, dtype=np.float64)
    owned_counts = plan.owned_counts
    g = plan.global_ids[0]
    nt = len(g)
    positions[0, :nt] = input_cart[g]
    spec[0, :nt] = species[g]
    owned_mask[0, : owned_counts[0]] = True
    perm = np.argsort(plan.dst_local[0], kind="stable")
    edge_src[0, :ne] = plan.src_local[0][perm]
    edge_dst[0, :ne] = plan.dst_local[0][perm]
    edge_offset[0, :ne] = plan.edge_offsets[0][perm]
    edge_mask[0, :ne] = True
    edge_dst[0, ne:] = plan.dst_local[0][perm[-1]] if ne else 0
    if np.any(np.diff(edge_dst[0]) < 0):
        raise RuntimeError("internal error: edge_dst must be sorted")
    # padded slot of each plan edge (the inverse of the dst sort)
    edge_perm_inv = np.empty(ne, dtype=np.int64)
    edge_perm_inv[perm] = np.arange(ne, dtype=np.int64)

    if plan.has_bond_graph:
        b_cap = caps.get("bonds", int(plan.bond_markers[0][-1]))
        l_cap = caps.get("lines", len(plan.line_src[0]))
        m_cap = caps.get("bond_map", len(plan.bond_mapping_edge[0]))
        line_src = np.zeros((P, l_cap), dtype=np.int32)
        line_dst = np.zeros((P, l_cap), dtype=np.int32)
        line_mask = np.zeros((P, l_cap), dtype=bool)
        line_center = np.zeros((P, l_cap), dtype=np.int32)
        bm_edge = np.zeros((P, m_cap), dtype=np.int32)
        bm_bond = np.zeros((P, m_cap), dtype=np.int32)
        bm_mask = np.zeros((P, m_cap), dtype=bool)
        # line edges sorted by dst bond node for sorted segment sums
        lperm = np.argsort(plan.line_dst[0], kind="stable")
        nl_0 = len(plan.line_src[0])
        line_src[0, :nl_0] = plan.line_src[0][lperm]
        line_dst[0, :nl_0] = plan.line_dst[0][lperm]
        line_dst[0, nl_0:] = plan.line_dst[0][lperm][-1] if nl_0 else 0
        line_center[0, :nl_0] = plan.line_center_local[0][lperm]
        line_mask[0, :nl_0] = True
        if np.any(np.diff(line_dst[0]) < 0):
            raise RuntimeError("internal error: line_dst must be sorted")
        nm = len(plan.bond_mapping_edge[0])
        bm_edge[0, :nm] = edge_perm_inv[plan.bond_mapping_edge[0]]
        bm_bond[0, :nm] = plan.bond_mapping_bond[0]
        bm_mask[0, :nm] = True
    else:
        b_cap = 0
        line_src = line_dst = line_center = np.zeros((P, 0), dtype=np.int32)
        line_mask = np.zeros((P, 0), dtype=bool)
        bm_edge = bm_bond = np.zeros((P, 0), dtype=np.int32)
        bm_mask = np.zeros((P, 0), dtype=bool)

    graph = PartitionedGraph(
        num_partitions=P,
        n_cap=n_cap,
        e_cap=e_cap,
        e_split=e_cap,
        positions=positions,
        species=spec,
        owned_mask=owned_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_offset=edge_offset,
        edge_mask=edge_mask,
        lattice=np.asarray(lattice, dtype=dtype),
        has_bond_graph=plan.has_bond_graph,
        b_cap=b_cap,
        line_src=line_src,
        line_dst=line_dst,
        line_mask=line_mask,
        line_center=line_center,
        bond_map_edge=bm_edge,
        bond_map_bond=bm_bond,
        bond_map_mask=bm_mask,
        system={k: np.int32((system or {}).get(k, 0))
                for k in ("charge", "spin", "dataset")},
    )
    host = HostGraphData(plan=plan, global_ids=plan.global_ids,
                         owned_counts=owned_counts)
    return graph, host


def refresh_edges(graph: PartitionedGraph, edge_src, edge_dst, edge_offset,
                  n_edges) -> PartitionedGraph:
    """Shape-preserving edge swap (``distmlip_tpu/partition/graph.py:440``).

    Swaps freshly built edge arrays (from ``neighbors.device``, on the
    graph's device) into an existing single-partition ``PartitionedGraph``
    without changing any static field: same caps, same shapes. It
    re-establishes the padding contract, so the search stays contract-free:
    padded slots are masked, their ``dst`` repeats the last real value
    (nondecreasing, in-bounds), their ``src`` and ``offset`` are zeroed.
    ``n_edges`` is a 0-d tensor or an int.

    Refuses a graph of more than one partition, a split edge layout
    (``e_split != e_cap``) and a bond graph (the line-graph arrays would
    go stale; bond-graph models keep the host rebuild).
    """
    import torch

    if graph.num_partitions != 1:
        raise ValueError(
            f"refresh_edges requires a single-partition graph (got "
            f"P={graph.num_partitions}); multi-partition graphs rebuild on "
            f"the host")
    if graph.e_split != graph.e_cap:
        raise ValueError(
            "refresh_edges requires an unsplit edge layout "
            f"(e_split={graph.e_split} != e_cap={graph.e_cap})")
    if graph.has_bond_graph:
        raise ValueError(
            "refresh_edges cannot rebuild bond/line-graph arrays; "
            "bond-graph models use the host rebuild path")
    e_cap = graph.e_cap
    dev = graph.edge_dst.device
    n_edges = torch.as_tensor(n_edges, device=dev)
    mask = torch.arange(e_cap, device=dev) < n_edges
    last = edge_dst[torch.clamp(n_edges - 1, 0, e_cap - 1)]
    dst = torch.where(mask, edge_dst, last).to(graph.edge_dst.dtype)
    src = torch.where(mask, edge_src, 0).to(graph.edge_src.dtype)
    off = torch.where(mask[:, None], edge_offset, 0).to(graph.edge_offset.dtype)
    return dataclasses.replace(graph, edge_src=src[None], edge_dst=dst[None],
                               edge_offset=off[None], edge_mask=mask[None])


def device_refresh_graph(static, arrays, graph: PartitionedGraph, positions):
    """Cell-list rebuild + in-place swap for a single-structure graph
    (``distmlip_tpu/partition/graph.py:487-517``).

    ``positions``: (1, N_cap, 3) input-frame coordinates on the graph's
    device; ``arrays`` the spec's arrays on that device. Returns ``(graph',
    n_edges, overflow)`` with 0-d tensors; on overflow the caller must
    discard ``graph'`` and rebuild on the host with grown caps.
    """
    src, dst, off, n_edges, overflow = cell_list_neighbors(
        static, arrays, positions[0])
    graph = refresh_edges(graph, src, dst, off.to(positions.dtype), n_edges)
    return graph, n_edges, overflow
