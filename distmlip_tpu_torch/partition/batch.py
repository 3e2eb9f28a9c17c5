"""Block-diagonal multi-structure packing (``distmlip_tpu/partition/batch.py``).

``pack_structures`` concatenates B independent neighbor graphs into ONE
single-partition ``PartitionedGraph`` so a whole batch of small structures
evaluates in one pass of the model: every kernel launch covers the batch.

Packing layout (all offsets cumulative over structures, real entries first,
one shared padding tail per array):

  nodes:  [ atoms_0 | atoms_1 | ... | pad ]            struct_id = b per row
  edges:  [ edges_0 | edges_1 | ... | pad ]            dst-sorted per block
  bonds:  [ bonds_0 | ... | pad ]  lines: [ lines_0 | ... | pad ]

The padding contract of a single-structure graph holds for the whole
super-array, so every model and kernel runs on it unchanged:

- per-structure edge blocks are dst-sorted and node ids only grow with the
  structure offset, so the concatenated ``edge_dst`` is nondecreasing
  (``line_dst`` likewise);
- all padding sits at the tail, its ``dst`` repeating the last real value
  (a kernel walking a dst row's edge range never walks padding in the
  middle of a segment; ``check_segments`` raises otherwise); a structure
  with no edges (one atom in a large cell) gives its rows empty ranges;
- ``e_split == e_cap``: one unsplit segment.

Cells differ per structure, so edge image offsets are baked to CARTESIAN
at pack time (``shift @ cell_b``) and the graph lattice is the identity;
the batched runtime (``parallel/runtime.py`` ``make_batched_potential_fn``)
strains each structure's offsets through ``struct_id`` for per-structure
stress. Padded node rows carry ``struct_id == batch_size``, one past the
last slot, which every per-structure reduction drops.

Packing is a relabeling of B disjoint graphs plus masked padding: no
message crosses a block, so per-structure results equal the
single-structure path's to float32 roundoff. Only the single-device pack
(``spatial_parts = batch_parts = 1``) is ported; the 2-D mesh placement
(``pack_structures_mesh``) is ROADMAP.md item A7.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..neighbors import neighbor_list
from .capacity import BucketPolicy
from .graph import PartitionedGraph, check_segments
from .partitioner import build_plan


def bucket_key(graph: PartitionedGraph) -> str:
    """Stable id of a packed graph's shape bucket: every capacity that sets
    a tensor shape (node, edge, bond, line and bond-map rungs, and the
    batch slots). Two packs with one key run at the same shapes."""
    key = f"n{graph.n_cap}_e{graph.e_cap}_B{graph.batch_size}"
    if graph.has_bond_graph:
        key += (f"_b{graph.b_cap}_l{graph.line_src.shape[-1]}"
                f"_m{graph.bond_map_edge.shape[-1]}")
    return key


@dataclass
class PackedHostData:
    """Host companions of a packed graph, for scatter and reassembly."""

    node_offsets: np.ndarray        # (B+1,) cumulative real-atom offsets
    n_atoms: np.ndarray             # (B,) real atoms per structure
    volumes: np.ndarray             # (B,) cell volumes (stress division)
    n_cap: int
    batch_size: int                 # padded slot count (>= B real)
    stats: dict | None = None       # occupancy, padding waste, bucket key
    # build-time positions per structure (the skin cache's reference)
    build_positions: list = field(default_factory=list)
    # per-structure cells and pbc at pack time: the device refresh
    # (device_refresh_packed) rebuilds each block with its own geometry
    cells: list = field(default_factory=list)
    pbcs: list = field(default_factory=list)

    @property
    def num_structures(self) -> int:
        return len(self.n_atoms)

    @property
    def structure_slots(self) -> np.ndarray:
        """(B,) slot of each structure in the runtime's ``energies`` (the
        identity on one device)."""
        return np.arange(self.num_structures, dtype=np.int64)

    def scatter_positions(self, positions_list, dtype=np.float32) -> np.ndarray:
        """Per-structure (n_b, 3) positions -> the packed (1, N_cap, 3)
        (padded rows zero)."""
        return self.scatter_per_atom(positions_list, dtype=dtype)

    def scatter_per_atom(self, arrays, dtype=np.float32) -> np.ndarray:
        """Per-structure per-atom arrays (n_b, ...) of one trailing shape ->
        the packed (1, N_cap, ...) layout (padded rows zero): positions,
        force targets, any node-aligned label."""
        trail = np.shape(np.asarray(arrays[0]))[1:]
        out = np.zeros((1, self.n_cap) + trail, dtype=dtype)
        for b, arr in enumerate(arrays):
            s = self.node_offsets[b]
            out[0, s:s + len(arr)] = arr
        return out

    def atom_slots(self) -> np.ndarray:
        """(1, N_cap) int32 slot of each node row; padded rows carry the
        ``batch_size`` sentinel, one past the last slot."""
        out = np.full((1, self.n_cap), self.batch_size, dtype=np.int32)
        for b in range(self.num_structures):
            out[0, self.node_offsets[b]:self.node_offsets[b + 1]] = b
        return out

    def gather_per_structure(self, packed: np.ndarray) -> list:
        """A (1, N_cap, ...) packed per-atom array -> per-structure
        (n_b, ...) views."""
        arr = np.asarray(packed)[0]
        return [arr[self.node_offsets[b]:self.node_offsets[b + 1]]
                for b in range(self.num_structures)]


_default_buckets = BucketPolicy()


def _batch_system(structures, system: dict | None) -> dict:
    """The batch-wide conditioning dict: ``system`` when given, else the
    structures' ``atoms.info`` charge/spin/dataset, which must agree."""
    if system is not None:
        return system
    systems = []
    for atoms in structures:
        info = getattr(atoms, "info", {}) or {}
        systems.append({k: int(info.get(k, 0)) for k in ("charge", "spin", "dataset")})
    if any(s != systems[0] for s in systems[1:]):
        raise ValueError(
            "pack_structures: structures carry conflicting charge/spin/"
            "dataset conditioning; batch structures with identical "
            "system scalars (or pass system= explicitly)")
    return systems[0]


def pack_structures(structures, cutoff: float, bond_cutoff: float = 0.0,
                    use_bond_graph: bool = False, caps: BucketPolicy | None = None,
                    species_fn=None, dtype=np.float32, skin: float = 0.0,
                    system: dict | None = None, spatial_parts: int = 1,
                    batch_parts: int = 1,
                    num_threads: int | None = None) -> tuple[PartitionedGraph, PackedHostData]:
    """Pack a list of ``Atoms`` into one block-diagonal ``PartitionedGraph``
    (host numpy; ``graph.to(device)`` uploads it).

    ``num_threads`` caps the native neighbor search's threads (default:
    its own rule). ``caps`` (default a shared ``BucketPolicy``) quantizes every capacity
    onto its ladder and the batch slots onto powers of two. ``species_fn``
    maps atomic numbers to model species (default: identity). ``skin``
    builds at ``cutoff + skin`` for the skin cache. ``system``
    (charge/spin/dataset) is one dict for the batch; structures whose
    ``atoms.info`` disagree raise. ``spatial_parts``/``batch_parts`` other
    than 1 (the 2-D mesh placement) raise: ROADMAP.md item A7.
    """
    if spatial_parts != 1 or batch_parts != 1:
        raise NotImplementedError(
            f"pack_structures(spatial_parts={spatial_parts}, batch_parts={batch_parts}): "
            "the 2-D (batch x spatial) mesh placement is not ported (ROADMAP.md A7); "
            "pack for one device")
    if not structures:
        raise ValueError("pack_structures needs at least one structure")
    caps = caps or _default_buckets
    species_fn = species_fn or (lambda z: np.asarray(z, dtype=np.int32))
    r_build = cutoff + skin
    b_build = (bond_cutoff + skin) if use_bond_graph else 0.0
    system = _batch_system(structures, system)

    B = len(structures)
    b_slots = caps.get_small(B) if hasattr(caps, "get_small") else B

    # --- per-structure single-partition plans (dst-sorted per block) ---
    blocks = []
    for atoms in structures:
        nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r_build, bond_r=b_build,
                           num_threads=num_threads)
        plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r_build, b_build, use_bond_graph)
        cell = np.asarray(atoms.cell, dtype=np.float64)
        ne = len(plan.src_local[0])
        perm = np.argsort(plan.dst_local[0], kind="stable")
        inv = np.empty(ne, dtype=np.int64)
        inv[perm] = np.arange(ne)
        blk = {
            "n": len(atoms),
            "pos": nl.wrapped_cart + nl.shift @ cell,
            "species": species_fn(atoms.numbers),
            "src": plan.src_local[0][perm],
            "dst": plan.dst_local[0][perm],
            # image offsets baked to Cartesian: the cells never reach the
            # device, each block's geometry rides its offsets
            "off": plan.edge_offsets[0][perm].astype(np.float64) @ cell,
            "vol": abs(np.linalg.det(cell)),
        }
        if use_bond_graph:
            lperm = np.argsort(plan.line_dst[0], kind="stable")
            blk.update({
                "nb": int(plan.bond_markers[0][-1]),
                "line_src": plan.line_src[0][lperm],
                "line_dst": plan.line_dst[0][lperm],
                "line_center": plan.line_center_local[0][lperm],
                "bm_edge": inv[plan.bond_mapping_edge[0]],
                "bm_bond": plan.bond_mapping_bond[0],
            })
        blocks.append(blk)

    node_off = np.concatenate([[0], np.cumsum([b["n"] for b in blocks])])
    n_tot = int(node_off[-1])
    e_tot = int(sum(len(b["src"]) for b in blocks))
    n_cap = caps.get("nodes", n_tot)
    e_cap = caps.get("edges", e_tot)

    positions = np.zeros((1, n_cap, 3), dtype=dtype)
    species = np.zeros((1, n_cap), dtype=np.int32)
    node_mask = np.zeros((1, n_cap), dtype=bool)
    struct_id = np.full((1, n_cap), b_slots, dtype=np.int32)
    edge_src = np.zeros((1, e_cap), dtype=np.int32)
    edge_dst = np.zeros((1, e_cap), dtype=np.int32)
    edge_offset = np.zeros((1, e_cap, 3), dtype=dtype)
    edge_mask = np.zeros((1, e_cap), dtype=bool)
    ni = ei = 0
    for b, blk in enumerate(blocks):
        n, ne = blk["n"], len(blk["src"])
        positions[0, ni:ni + n] = blk["pos"]
        species[0, ni:ni + n] = blk["species"]
        node_mask[0, ni:ni + n] = True
        struct_id[0, ni:ni + n] = b
        edge_src[0, ei:ei + ne] = blk["src"] + ni
        edge_dst[0, ei:ei + ne] = blk["dst"] + ni
        edge_offset[0, ei:ei + ne] = blk["off"]
        edge_mask[0, ei:ei + ne] = True
        ni += n
        ei += ne
    # padding: dst repeats the last real value, src 0, the mask zeroes it
    edge_dst[0, ei:] = edge_dst[0, ei - 1] if ei else 0
    check_segments("packed edge", edge_dst[0], edge_mask[0], (0, e_cap))

    if use_bond_graph:
        b_tot = int(sum(b["nb"] for b in blocks))
        l_tot = int(sum(len(b["line_src"]) for b in blocks))
        m_tot = int(sum(len(b["bm_edge"]) for b in blocks))
        b_cap = caps.get("bonds", b_tot)
        l_cap = caps.get("lines", l_tot)
        m_cap = caps.get("bond_map", m_tot)
        line_src = np.zeros((1, l_cap), dtype=np.int32)
        line_dst = np.zeros((1, l_cap), dtype=np.int32)
        line_mask = np.zeros((1, l_cap), dtype=bool)
        line_center = np.zeros((1, l_cap), dtype=np.int32)
        bm_edge = np.zeros((1, m_cap), dtype=np.int32)
        bm_bond = np.zeros((1, m_cap), dtype=np.int32)
        bm_mask = np.zeros((1, m_cap), dtype=bool)
        ni = ei = bi = li = mi = 0
        for blk in blocks:
            nl_b, nm = len(blk["line_src"]), len(blk["bm_edge"])
            line_src[0, li:li + nl_b] = blk["line_src"] + bi
            line_dst[0, li:li + nl_b] = blk["line_dst"] + bi
            line_center[0, li:li + nl_b] = blk["line_center"] + ni
            line_mask[0, li:li + nl_b] = True
            bm_edge[0, mi:mi + nm] = blk["bm_edge"] + ei
            bm_bond[0, mi:mi + nm] = blk["bm_bond"] + bi
            bm_mask[0, mi:mi + nm] = True
            ni += blk["n"]
            ei += len(blk["src"])
            bi += blk["nb"]
            li += nl_b
            mi += nm
        line_dst[0, li:] = line_dst[0, li - 1] if li else 0
        check_segments("packed line", line_dst[0], line_mask[0], (0, l_cap))
    else:
        b_cap = 0
        line_src = line_dst = line_center = np.zeros((1, 0), dtype=np.int32)
        line_mask = np.zeros((1, 0), dtype=bool)
        bm_edge = bm_bond = np.zeros((1, 0), dtype=np.int32)
        bm_mask = np.zeros((1, 0), dtype=bool)

    graph = PartitionedGraph(
        num_partitions=1, n_cap=n_cap, e_cap=e_cap, e_split=e_cap,
        positions=positions, species=species, node_mask=node_mask,
        owned_mask=node_mask.copy(), edge_src=edge_src, edge_dst=edge_dst,
        edge_offset=edge_offset, edge_mask=edge_mask,
        halo_send_idx=np.zeros((1, 1, 0), dtype=np.int32),
        halo_send_mask=np.zeros((1, 1, 0), dtype=bool),
        halo_recv_idx=np.full((1, 1, 0), n_cap, dtype=np.int32),
        # identity lattice: the offsets are Cartesian already
        lattice=np.eye(3, dtype=dtype),
        has_bond_graph=use_bond_graph, b_cap=b_cap, line_src=line_src,
        line_dst=line_dst, line_mask=line_mask, line_center=line_center,
        bond_map_edge=bm_edge, bond_map_bond=bm_bond, bond_map_mask=bm_mask,
        bond_halo_send_idx=np.zeros((1, 1, 0), dtype=np.int32),
        bond_halo_send_mask=np.zeros((1, 1, 0), dtype=bool),
        bond_halo_recv_idx=np.full((1, 1, 0), b_cap, dtype=np.int32),
        system={k: np.int32(v) for k, v in system.items()},
        batch_size=b_slots, struct_id=struct_id,
    )
    host = PackedHostData(
        node_offsets=node_off,
        n_atoms=np.array([b["n"] for b in blocks]),
        volumes=np.array([b["vol"] for b in blocks]),
        n_cap=n_cap, batch_size=b_slots,
        build_positions=[np.asarray(a.positions).copy() for a in structures],
        cells=[np.asarray(a.cell, dtype=np.float64).copy() for a in structures],
        pbcs=[np.asarray(a.pbc).copy() for a in structures],
        stats=packed_stats(graph, B),
    )
    return graph, host


def build_packed_refresh_spec(host: PackedHostData, graph: PartitionedGraph,
                              r_build: float, dtype=np.float32):
    """Spec for refreshing THIS packed graph's edges on its device (the
    per-block dense search of ``neighbors.device.build_packed_spec``, sized
    to the pack-time structures). ``r_build`` is the pack cutoff (cutoff +
    skin)."""
    from ..neighbors.device import build_packed_spec

    return build_packed_spec(host.cells, host.pbcs, host.n_atoms, host.node_offsets,
                             r_build, graph.n_cap, graph.e_cap, dtype=dtype)


def device_refresh_packed(static, arrays, graph, positions):
    """Packed-batch rebuild + in-place edge swap on the graph's device
    (``distmlip_tpu/partition/batch.py:883-911``). ``positions``: the
    (1, N_cap, 3) packed input-frame coordinates; ``arrays`` the spec's
    arrays on that device. Returns ``(graph', n_edges, overflow)`` with
    0-d tensors; on overflow the caller discards ``graph'`` and repacks on
    the host."""
    from ..neighbors.device import packed_neighbors
    from .graph import refresh_edges

    src, dst, off, n_edges, overflow = packed_neighbors(static, arrays, positions[0])
    return refresh_edges(graph, src, dst, off, n_edges), n_edges, overflow


def slot_waste_frac(live: int, slots: int) -> float:
    """Padding waste: dead padded slots / all slots."""
    return 1.0 - live / slots if slots else 0.0


def graph_live_slots(graph: PartitionedGraph) -> tuple:
    """(live, slots) over the compute-bearing rows: node, edge and (with a
    bond graph) line slots; ``slot_waste_frac(*graph_live_slots(g))`` is
    the pack's ``padding_waste_frac``."""
    P = graph.num_partitions
    live = int(np.asarray(graph.node_mask).sum()) + int(np.asarray(graph.edge_mask).sum())
    slots = P * (graph.n_cap + graph.e_cap)
    if graph.has_bond_graph:
        slots += P * int(graph.line_src.shape[-1])
        live += int(np.asarray(graph.line_mask).sum())
    return live, slots


def packed_stats(graph: PartitionedGraph, n_real_structures: int) -> dict:
    """Shape and occupancy stats of a packed batch (host numpy, before the
    upload): the JAX package's ``packed_stats`` keys, with the placement
    fixed at one device (1 x 1)."""
    P = graph.num_partitions
    nodes = np.asarray(graph.node_mask).sum(axis=1)
    edges = np.asarray(graph.edge_mask).sum(axis=1)
    live, slots = graph_live_slots(graph)
    total_slots = graph.batch_size
    stats = {
        "n_atoms": int(nodes.sum()),
        "num_partitions": P,
        "n_cap": graph.n_cap,
        "e_cap": graph.e_cap,
        "b_cap": graph.b_cap,
        "n_nodes_per_part": [int(x) for x in nodes],
        "n_edges_per_part": [int(x) for x in edges],
        "node_occupancy": float(nodes.max()) / graph.n_cap if graph.n_cap else 0.0,
        "edge_occupancy": float(edges.max()) / graph.e_cap if graph.e_cap else 0.0,
        "batch_size": n_real_structures,
        "batch_slots": total_slots,
        "batch_occupancy": n_real_structures / total_slots if total_slots else 0.0,
        "bucket_key": bucket_key(graph),
        "padding_waste_frac": slot_waste_frac(live, slots),
        "spatial_parts": 1,
        "batch_parts": 1,
        "mesh_shape": [1, 1],
    }
    if graph.has_bond_graph:
        stats["n_lines"] = int(np.asarray(graph.line_mask).sum())
    return stats
