"""PartitionedGraph: the capacity-padded graph, host arrays or device tensors.

All per-partition arrays keep a leading axis of size P, so they compare
like with like against the JAX package's graph, bit for bit. Static shapes
everywhere; validity is carried by masks. ``build_partitioned_graph``
returns numpy arrays; ``PartitionedGraph.to(device)`` turns them into torch
tensors on that device.

At P > 1 the graph also carries ``flat``: the P partitions laid side by
side as ONE graph, which is what the port runs on one card
(``parallel/halo.py``). Partition p owns node rows ``[p n_cap, (p+1) n_cap)``
and bond rows ``[p b_cap, (p+1) b_cap)``; edges are laid out as
``[interior of p = 0 .. P-1 | frontier of p = 0 .. P-1]`` with ids shifted
by ``p n_cap``, so each of the two segments is dst-nondecreasing over the
flattened rows; line edges are concatenated per partition (globally
sorted); in each segment the padding rows of every partition move to its
tail, as in a P=1 graph; the halo tables become two index vectors per
graph (atom and bond), the rows to copy and the rows they land in. All of
it is built here, on the host, once per graph.

``refresh_edges`` and ``device_refresh_graph`` swap edges rebuilt on the
graph's device (``neighbors.device``) into a single-partition graph in
place; a packed batch (``partition/batch.py``) is refreshed through the
same swap.
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

# array fields (everything but the statics and ``flat``)
ARRAY_FIELDS = ("positions", "species", "node_mask", "owned_mask", "edge_src",
                "edge_dst", "edge_offset", "edge_mask", "halo_send_idx",
                "halo_send_mask", "halo_recv_idx", "lattice", "line_src", "line_dst",
                "line_mask", "line_center", "bond_map_edge", "bond_map_bond",
                "bond_map_mask", "bond_halo_send_idx", "bond_halo_send_mask",
                "bond_halo_recv_idx", "struct_id")
# the array fields a P > 1 graph reads on its device beside ``flat``
FLAT_DEVICE_FIELDS = ("positions", "species", "owned_mask", "lattice")


@dataclass
class PartitionedGraph:
    # --- static metadata ---
    num_partitions: int
    n_cap: int
    e_cap: int
    # interior/frontier boundary of the edge rows: edges [0, e_split) have
    # both endpoints owned, edges [e_split, e_cap) read a halo src row;
    # e_split == e_cap is the one unsplit segment (every P=1 graph)
    e_split: int

    # --- per-partition arrays, leading axis P ---
    positions: Any          # (P, N_cap, 3) owned rows valid
    species: Any            # (P, N_cap) int32
    owned_mask: Any         # (P, N_cap) bool — owned rows only
    edge_src: Any           # (P, E_cap) int32
    edge_dst: Any           # (P, E_cap) int32, nondecreasing within each segment
    edge_offset: Any        # (P, E_cap, 3) float
    edge_mask: Any          # (P, E_cap) bool
    lattice: Any            # (3, 3) replicated
    node_mask: Any = None   # (P, N_cap) bool — any valid row (owned + halo)
    # ring shifts of the halo exchange ((q - p) % P of every sending pair)
    shifts: tuple = ()
    # halo tables, one row per shift: (S, P, H_cap); a padded recv slot
    # is n_cap (one past the end, dropped)
    halo_send_idx: Any = None
    halo_send_mask: Any = None
    halo_recv_idx: Any = None

    # --- bond graph (CHGNet), width 0 without one ---
    has_bond_graph: bool = False
    b_cap: int = 0
    line_src: Any = None    # (P, L_cap) int32 local bond ids
    line_dst: Any = None    # (P, L_cap) int32, nondecreasing; pads repeat the last
    line_mask: Any = None   # (P, L_cap) bool
    line_center: Any = None  # (P, L_cap) int32 local atom id of the angle's center
    bond_map_edge: Any = None  # (P, M_cap) int32 local (padded) edge id of a bond
    bond_map_bond: Any = None  # (P, M_cap) int32 local bond id
    bond_map_mask: Any = None  # (P, M_cap) bool
    bond_halo_send_idx: Any = None  # (S, P, BH_cap); padded recv slot b_cap
    bond_halo_send_mask: Any = None
    bond_halo_recv_idx: Any = None

    # per-system replicated scalars (eSCN/UMA charge/spin/dataset
    # conditioning, distmlip_tpu/partition/graph.py:103-105):
    # {"charge", "spin", "dataset"}, () int32 each
    system: Any = None
    # P > 1: the flattened one-graph view (module docstring), a dict of
    # arrays; None at P = 1
    flat: Any = None
    # block-diagonally packed batch (``partition/batch.py``): structure
    # slots (0 on a single-structure graph) and (1, N_cap) int32 slot of
    # each node row, the sentinel ``batch_size`` on padded rows
    # (``distmlip_tpu/partition/graph.py:107-113``)
    batch_size: int = 0
    struct_id: Any = None

    def to(self, device, non_blocking: bool = False) -> "PartitionedGraph":
        """A copy whose array fields (system scalars, flat view and a packed
        batch's ``struct_id`` too) are torch tensors on ``device`` (dtypes
        kept: int32 ids and scalars, bool masks, the build's float dtype;
        int64 flat index vectors).

        At P > 1 only the fields the flattened graph reads move
        (``FLAT_DEVICE_FIELDS`` and ``flat``): the stacked edge, bond-graph
        and halo-table arrays stay where they are, since ``flat`` holds
        them in the layout the device runs.

        ``non_blocking`` (a CUDA ``device``): each host array is copied into
        pinned memory and uploaded asynchronously on the current stream;
        the caller orders later use after it (an event)."""
        import torch

        def conv(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x.to(device, non_blocking=non_blocking)
            t = torch.as_tensor(np.asarray(x))
            if non_blocking:
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

        system = (None if self.system is None
                  else {k: conv(v) for k, v in self.system.items()})
        flat = None if self.flat is None else {k: conv(v) for k, v in self.flat.items()}
        fields = ARRAY_FIELDS if flat is None else FLAT_DEVICE_FIELDS
        return dataclasses.replace(
            self, system=system, flat=flat,
            **{k: conv(getattr(self, k)) for k in fields})


    def tensors(self):
        """Every torch tensor the graph holds (array fields, system
        scalars, the flat view)."""
        import torch

        out = [getattr(self, k) for k in ARRAY_FIELDS]
        out += list((self.system or {}).values()) + list((self.flat or {}).values())
        return [t for t in out if isinstance(t, torch.Tensor)]


@dataclass
class HostGraphData:
    """Host companions of a PartitionedGraph needed for reassembly."""

    plan: PartitionPlan
    global_ids: list = field(default_factory=list)
    owned_counts: np.ndarray | None = None
    # shape stats of the built graph (host numpy, before upload)
    stats: dict | None = None

    def scatter_global(self, global_arr: np.ndarray, n_cap: int, fill=0.0) -> np.ndarray:
        """Split a (N, ...) global array into padded (P, N_cap, ...) locals
        (owned and halo rows; the potential refreshes the halo rows of the
        positions by the halo exchange, so gradients reach the owner)."""
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


def _halo_tables(plan: PartitionPlan, section_fn, n_cap, caps, name):
    """(S, P, H) send/recv tables of a slab plan (the JAX package's
    ``_halo_tables``, ``distmlip_tpu/partition/graph.py:167``, its slab
    branch): one gather -> copy -> scatter round per ring shift; both
    sides of a pair are ordered alike, so payload slot i lands in recv
    slot i. At P = 2 shifts +1 and -1 reach the same peer: one shift per
    (q - p) % P is kept."""
    P = plan.num_partitions

    def pair(p, kind, q):
        s_, e_ = section_fn(p, kind, q)
        return np.arange(s_, e_, dtype=np.int64)

    shift_counts: dict[int, int] = {}
    for p in range(P):
        for q in range(P):
            if q == p:
                continue
            cnt = len(pair(p, "to", q))
            if cnt:
                shift = (q - p) % P
                shift_counts[shift] = max(shift_counts.get(shift, 0), cnt)
    shifts = tuple(sorted(shift_counts))
    h_cap = caps.get(name, max(shift_counts.values(), default=0))
    S = max(len(shifts), 1)
    send_idx = np.zeros((S, P, h_cap), dtype=np.int32)
    send_mask = np.zeros((S, P, h_cap), dtype=bool)
    recv_idx = np.full((S, P, h_cap), n_cap, dtype=np.int32)  # n_cap = drop slot
    for si, s in enumerate(shifts):
        for p in range(P):
            to_idx = pair(p, "to", (p + s) % P)
            if len(to_idx):
                send_idx[si, p, : len(to_idx)] = to_idx
                send_mask[si, p, : len(to_idx)] = True
            fr_idx = pair(p, "from", (p - s) % P)
            if len(fr_idx):
                recv_idx[si, p, : len(fr_idx)] = fr_idx
    return shifts, send_idx, send_mask, recv_idx


def expand_shift_tables(tbl, used_shifts, all_shifts, fill):
    """Re-index per-shift halo tables (S, P, H) onto a union shift tuple;
    rows of shifts the table did not use are filled with ``fill`` (0,
    False or the drop slot), so the atom and bond tables share one shift
    set (``distmlip_tpu/partition/graph.py:218``)."""
    if tuple(used_shifts) == tuple(all_shifts) or not all_shifts:
        return tbl
    _, P_, H = tbl.shape
    out = np.full((max(len(all_shifts), 1), P_, H), fill, dtype=tbl.dtype)
    for i, s in enumerate(all_shifts):
        if s in used_shifts:
            out[i] = tbl[list(used_shifts).index(s)]
    return out


def _flat_halo(shifts, send_idx, send_mask, recv_idx, rows: int):
    """The (S, P, H) tables as two flattened index vectors: for shift s,
    partition q's slot ``recv_idx[s, q, i]`` receives partition
    ``(q - s) % P``'s row ``send_idx[s, (q - s) % P, i]``, rows offset by
    ``p * rows``. Masked slots are dropped here: in the tables a padded
    recv slot is ``rows``, one past the end, which in the flattened array
    would be the next partition's row 0."""
    P = send_idx.shape[1]
    send, recv = [], []
    for si, s in enumerate(shifts):
        for q in range(P):
            p = (q - s) % P
            valid = recv_idx[si, q] < rows
            if not np.array_equal(valid, send_mask[si, p]):
                raise RuntimeError("internal error: halo send and recv slots misaligned")
            send.append(p * rows + send_idx[si, p][valid].astype(np.int64))
            recv.append(q * rows + recv_idx[si, q][valid].astype(np.int64))
    empty = np.zeros(0, np.int64)
    return (np.concatenate(send) if send else empty,
            np.concatenate(recv) if recv else empty)


def _tail_padding(mask, dst, bounds):
    """Row order of a flattened array whose sorted segments ``bounds`` hold
    each partition's real rows and padding in turn: per segment, the real
    rows in order, then the padding. Returns ``(order, dst[order])`` with
    the padding's dst set to its segment's last real dst, so each segment
    stays nondecreasing and its padding is one repeated tail on one row, as
    in a P=1 graph. Left in place, partition p's padding would sit on its
    last dst row in the middle of the segment, where a kernel that walks a
    row's edge range (``kernels.csr_row_offsets`` clamps only the tail)
    would walk all of it."""
    order, out = [], []
    for a, b in zip(bounds, bounds[1:]):
        idx = np.arange(a, b)
        real, pad = idx[mask[a:b]], idx[~mask[a:b]]
        d = dst[np.concatenate([real, pad])]
        if len(real) and len(pad):
            d[len(real):] = dst[real[-1]]
        order.append(np.concatenate([real, pad]))
        out.append(d)
    return np.concatenate(order), np.concatenate(out)


def _flat_view(g: PartitionedGraph) -> dict:
    """The flattened one-graph view of a P > 1 graph (module docstring),
    host numpy. Within each sorted segment the real rows of every partition
    come first, then all the padding (``_tail_padding``). ``bond_map_edge``
    follows the edge layout."""
    P, n_cap, b_cap = g.num_partitions, g.n_cap, g.b_cap
    s, e_cap = g.e_split, g.e_cap
    part = np.arange(P, dtype=np.int64)[:, None]

    def segments(a, offset=None):
        a = np.asarray(a)
        if offset is not None:
            a = a + offset.astype(a.dtype)
        tail = a.shape[2:]
        return np.concatenate([a[:, :s].reshape((-1,) + tail),
                               a[:, s:].reshape((-1,) + tail)])

    node_off = part * n_cap
    # the interior/frontier layout before the padding moves: partition p's
    # padded edge slot k at p s + k, or P s + p (e_cap - s) + (k - s)
    mask = segments(g.edge_mask)
    order, dst = _tail_padding(mask, segments(g.edge_dst, node_off),
                               (0, P * s, P * e_cap))
    new_slot = np.empty(P * e_cap, np.int64)
    new_slot[order] = np.arange(P * e_cap)
    k = np.asarray(g.bond_map_edge).astype(np.int64)
    bm_edge = new_slot[np.where(k < s, part * s + k, P * s + part * (e_cap - s) + (k - s))]
    line_mask = np.asarray(g.line_mask).reshape(-1)
    l_order, line_dst = _tail_padding(
        line_mask, (np.asarray(g.line_dst) + (part * b_cap).astype(np.int32)).reshape(-1),
        (0, line_mask.size))
    flat = {
        "edge_src": segments(g.edge_src, node_off)[order],
        "edge_dst": dst,
        "edge_offset": segments(g.edge_offset)[order],
        "edge_mask": mask[order],
        "line_src": (np.asarray(g.line_src)
                     + (part * b_cap).astype(np.int32)).reshape(-1)[l_order],
        "line_dst": line_dst,
        "line_center": (np.asarray(g.line_center)
                        + node_off.astype(np.int32)).reshape(-1)[l_order],
        "line_mask": line_mask[l_order],
        "bond_map_edge": bm_edge.astype(np.int32).reshape(-1),
        "bond_map_bond": (np.asarray(g.bond_map_bond)
                          + (part * b_cap).astype(np.int32)).reshape(-1),
        "bond_map_mask": np.asarray(g.bond_map_mask).reshape(-1),
    }
    flat["halo_send"], flat["halo_recv"] = _flat_halo(
        g.shifts, g.halo_send_idx, g.halo_send_mask, g.halo_recv_idx, n_cap)
    empty = np.zeros(0, np.int64)
    flat["bond_halo_send"], flat["bond_halo_recv"] = _flat_halo(
        g.shifts, g.bond_halo_send_idx, g.bond_halo_send_mask, g.bond_halo_recv_idx,
        b_cap) if g.has_bond_graph else (empty, empty)
    check_segments("flattened edge", flat["edge_dst"], flat["edge_mask"],
                   (0, P * s, P * e_cap))
    check_segments("flattened line", flat["line_dst"], flat["line_mask"],
                   (0, line_mask.size))
    return flat


def check_segments(name, dst, mask, bounds):
    """Raise unless each segment ``[bounds[i], bounds[i+1])`` of a (host)
    dst array is nondecreasing and holds its real rows before its padding:
    the layout the kernels walk (``LocalGraph``'s edge contract)."""
    dst, mask = np.asarray(dst), np.asarray(mask)
    for a, b in zip(bounds, bounds[1:]):
        if np.any(np.diff(dst[a:b]) < 0):
            raise RuntimeError(f"internal error: {name} dst must be sorted within each "
                               "segment")
        if np.any(mask[a + 1:b] & ~mask[a:b - 1]):
            raise RuntimeError(f"internal error: {name} mask must hold each segment's "
                               "real rows before its padding")


def build_partitioned_graph(
    plan: PartitionPlan,
    nl,
    species: np.ndarray,
    lattice: np.ndarray,
    caps: CapacityPolicy | None = None,
    dtype=np.float32,
    system: dict | None = None,
) -> tuple[PartitionedGraph, HostGraphData]:
    """Pad + stack a PartitionPlan into a PartitionedGraph (numpy arrays):
    the JAX package's ``build_partitioned_graph``
    (``distmlip_tpu/partition/graph.py:237``), bit for bit, plus the
    flattened view at P > 1.

    ``system``: optional per-system scalars (charge, spin, dataset ints),
    the conditioning inputs of eSCN; missing ones default to 0.

    When any partition has a frontier edge, each partition's edges are laid
    out as [interior | frontier] segments (each dst-sorted, separately
    padded to its own sticky cap); otherwise, and in every P=1 graph, as
    one dst-sorted segment. Padded edge rows repeat their segment's last real dst
    (nondecreasing, in-bounds) and are masked. With a bond graph, line
    edges are sorted by dst bond (stable, padding repeating the last) and
    the bond map's edge ids follow the edge layout.
    """
    caps = caps or _default_caps
    P = plan.num_partitions
    n_cap = caps.get("nodes", max(int(m[-1]) for m in plan.node_markers))
    frontier = [plan.edge_is_frontier(p) for p in range(P)]
    split = any(f.any() for f in frontier)
    if split:
        # separate sticky caps per segment: e_cap holds the worst interior
        # AND frontier counts even when they peak on different partitions,
        # so the boundary e_split is one index shared by every partition
        e_split = caps.get("edges_interior", max(int((~f).sum()) for f in frontier))
        f_cap = caps.get("edges_frontier", max(int(f.sum()) for f in frontier))
        e_cap = e_split + f_cap
    else:
        e_cap = caps.get("edges", max(len(e) for e in plan.edge_ids))
        e_split = e_cap

    positions = np.zeros((P, n_cap, 3), dtype=dtype)
    spec = np.zeros((P, n_cap), dtype=np.int32)
    node_mask = np.zeros((P, n_cap), dtype=bool)
    owned_mask = np.zeros((P, n_cap), dtype=bool)
    edge_src = np.zeros((P, e_cap), dtype=np.int32)
    edge_dst = np.zeros((P, e_cap), dtype=np.int32)
    edge_offset = np.zeros((P, e_cap, 3), dtype=dtype)
    edge_mask = np.zeros((P, e_cap), dtype=bool)

    # positions live in the INPUT (unwrapped) frame — edge offsets are
    # reported relative to it, so MD positions drift out of the box freely
    input_cart = nl.wrapped_cart + nl.shift @ np.asarray(lattice, dtype=np.float64)
    owned_counts = plan.owned_counts
    edge_perm_inv = []
    for p in range(P):
        g = plan.global_ids[p]
        nt = len(g)
        positions[p, :nt] = input_cart[g]
        spec[p, :nt] = species[g]
        node_mask[p, :nt] = True
        owned_mask[p, : owned_counts[p]] = True
        ne = len(plan.edge_ids[p])
        perm = np.argsort(plan.dst_local[p], kind="stable")
        if split:
            # stable-partition the dst-sorted order: interior first, then
            # frontier; each segment stays dst-sorted
            perm = perm[np.argsort(frontier[p][perm], kind="stable")]
        n_int = ne - int(frontier[p].sum()) if split else ne
        # padded slot of sorted edge k: interior edges fill [0, n_int),
        # frontier edges [e_split, e_split + n_fr)
        slot = np.arange(ne, dtype=np.int64)
        slot[n_int:] += e_split - n_int
        inv = np.empty(ne, dtype=np.int64)
        inv[perm] = slot
        edge_perm_inv.append(inv)
        for seg, start, cap_end in ((perm[:n_int], 0, e_split),
                                    (perm[n_int:], e_split, e_cap)):
            k = len(seg)
            edge_src[p, start:start + k] = plan.src_local[p][seg]
            edge_dst[p, start:start + k] = plan.dst_local[p][seg]
            edge_offset[p, start:start + k] = plan.edge_offsets[p][seg]
            edge_mask[p, start:start + k] = True
            # pad dst with the segment's last real value: nondecreasing
            # and in-bounds; masked rows add nothing
            edge_dst[p, start + k:cap_end] = plan.dst_local[p][seg[-1]] if k else 0
        if np.any(np.diff(edge_dst[p, :e_split]) < 0) or np.any(
                np.diff(edge_dst[p, e_split:]) < 0):
            raise RuntimeError("internal error: edge_dst must be sorted within each segment")
        if split and np.any(plan.src_local[p][perm[:n_int]] >= owned_counts[p]):
            raise RuntimeError("internal error: interior edges must not read halo rows")

    shifts, h_send, h_smask, h_recv = _halo_tables(plan, plan.section, n_cap, caps, "halo")

    if plan.has_bond_graph:
        b_cap = caps.get("bonds", max(int(m[-1]) for m in plan.bond_markers))
        l_cap = caps.get("lines", max(len(x) for x in plan.line_src))
        m_cap = caps.get("bond_map", max(len(x) for x in plan.bond_mapping_edge))
        line_src = np.zeros((P, l_cap), dtype=np.int32)
        line_dst = np.zeros((P, l_cap), dtype=np.int32)
        line_mask = np.zeros((P, l_cap), dtype=bool)
        line_center = np.zeros((P, l_cap), dtype=np.int32)
        bm_edge = np.zeros((P, m_cap), dtype=np.int32)
        bm_bond = np.zeros((P, m_cap), dtype=np.int32)
        bm_mask = np.zeros((P, m_cap), dtype=bool)
        for p in range(P):
            # line edges sorted by dst bond node for sorted segment sums
            lperm = np.argsort(plan.line_dst[p], kind="stable")
            nl_p = len(plan.line_src[p])
            line_src[p, :nl_p] = plan.line_src[p][lperm]
            line_dst[p, :nl_p] = plan.line_dst[p][lperm]
            line_dst[p, nl_p:] = plan.line_dst[p][lperm][-1] if nl_p else 0
            line_center[p, :nl_p] = plan.line_center_local[p][lperm]
            line_mask[p, :nl_p] = True
            if np.any(np.diff(line_dst[p]) < 0):
                raise RuntimeError("internal error: line_dst must be sorted")
            nm = len(plan.bond_mapping_edge[p])
            bm_edge[p, :nm] = edge_perm_inv[p][plan.bond_mapping_edge[p]]
            bm_bond[p, :nm] = plan.bond_mapping_bond[p]
            bm_mask[p, :nm] = True
        b_shifts, b_send, b_smask, b_recv = _halo_tables(
            plan, plan.bond_section, b_cap, caps, "bond_halo")
        # the node and bond exchanges ride the same ring shifts
        all_shifts = tuple(sorted(set(shifts) | set(b_shifts)))
        b_send = expand_shift_tables(b_send, b_shifts, all_shifts, 0)
        b_smask = expand_shift_tables(b_smask, b_shifts, all_shifts, False)
        b_recv = expand_shift_tables(b_recv, b_shifts, all_shifts, b_cap)
    else:
        b_cap = 0
        line_src = line_dst = line_center = np.zeros((P, 0), dtype=np.int32)
        line_mask = np.zeros((P, 0), dtype=bool)
        bm_edge = bm_bond = np.zeros((P, 0), dtype=np.int32)
        bm_mask = np.zeros((P, 0), dtype=bool)
        b_send = np.zeros((1, P, 0), dtype=np.int32)
        b_smask = np.zeros((1, P, 0), dtype=bool)
        b_recv = np.zeros((1, P, 0), dtype=np.int32)
        all_shifts = shifts
    h_send = expand_shift_tables(h_send, shifts, all_shifts, 0)
    h_smask = expand_shift_tables(h_smask, shifts, all_shifts, False)
    h_recv = expand_shift_tables(h_recv, shifts, all_shifts, n_cap)

    graph = PartitionedGraph(
        num_partitions=P,
        n_cap=n_cap,
        e_cap=e_cap,
        e_split=e_split,
        positions=positions,
        species=spec,
        owned_mask=owned_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_offset=edge_offset,
        edge_mask=edge_mask,
        lattice=np.asarray(lattice, dtype=dtype),
        node_mask=node_mask,
        shifts=all_shifts,
        halo_send_idx=h_send,
        halo_send_mask=h_smask,
        halo_recv_idx=h_recv,
        has_bond_graph=plan.has_bond_graph,
        b_cap=b_cap,
        line_src=line_src,
        line_dst=line_dst,
        line_mask=line_mask,
        line_center=line_center,
        bond_map_edge=bm_edge,
        bond_map_bond=bm_bond,
        bond_map_mask=bm_mask,
        bond_halo_send_idx=b_send,
        bond_halo_send_mask=b_smask,
        bond_halo_recv_idx=b_recv,
        system={k: np.int32((system or {}).get(k, 0))
                for k in ("charge", "spin", "dataset")},
    )
    if P > 1:
        graph.flat = _flat_view(graph)
    host = HostGraphData(plan=plan, global_ids=plan.global_ids,
                         owned_counts=owned_counts)
    return graph, host


def graph_build_stats(graph: PartitionedGraph, n_atoms: int) -> dict:
    """Shape, occupancy and halo-volume stats of a host-side (numpy) graph,
    under the telemetry record's field names
    (``distmlip_tpu/partition/graph.py:525-566``). Read at build time,
    before the upload, so they cost a few numpy sums and no device read.
    The partitions share one card, so the placement is ``[1, P]``."""
    P = graph.num_partitions
    nodes = np.asarray(graph.node_mask).sum(axis=1)
    edge_mask = np.asarray(graph.edge_mask)
    edges = edge_mask.sum(axis=1)
    frontier = edge_mask[:, graph.e_split:].sum(axis=1)

    def per_part(mask, fn):
        return ([int(x) for x in fn(np.asarray(mask)).sum(axis=(0, 2))]
                if mask is not None and np.asarray(mask).size else [0] * P)

    stats = {
        "n_atoms": int(n_atoms),
        "num_partitions": P,
        "n_cap": graph.n_cap,
        "e_cap": graph.e_cap,
        "b_cap": graph.b_cap,
        "n_nodes_per_part": [int(x) for x in nodes],
        "n_edges_per_part": [int(x) for x in edges],
        "node_occupancy": float(nodes.max() / graph.n_cap) if graph.n_cap else 0.0,
        "edge_occupancy": float(edges.max() / graph.e_cap) if graph.e_cap else 0.0,
        # fraction of real edges that read a halo row (worst partition)
        "frontier_edge_frac": float(
            (frontier / np.maximum(edges, 1)).max()) if len(edges) else 0.0,
        "halo_send_per_part": per_part(graph.halo_send_mask, lambda m: m),
        "halo_recv_per_part": per_part(graph.halo_recv_idx, lambda r: r < graph.n_cap),
        "spatial_parts": P,
        "batch_parts": 1,
        "mesh_shape": [1, P],
    }
    if graph.has_bond_graph:
        stats["bond_halo_send_per_part"] = per_part(graph.bond_halo_send_mask, lambda m: m)
        stats["n_lines"] = int(np.asarray(graph.line_mask).sum())
    return stats


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
