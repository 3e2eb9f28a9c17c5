"""PartitionedGraph: the capacity-padded graph, host arrays or device tensors.

All per-partition arrays keep a leading axis of size P (P=1 in this port),
so they compare like with like against the JAX package's graph. Static
shapes everywhere; validity is carried by masks. ``build_partitioned_graph``
returns numpy arrays; ``PartitionedGraph.to(device)`` turns them into torch
tensors on that device.

Only the fields a single-partition model reads are kept. The halo tables,
ring shifts and interior/frontier split of the JAX graph serve P>1 and
come with it (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .capacity import CapacityPolicy
from .plan import PartitionPlan

_default_caps = CapacityPolicy()

# array fields (everything but the statics)
ARRAY_FIELDS = ("positions", "species", "owned_mask", "edge_src", "edge_dst",
                "edge_offset", "edge_mask", "lattice")


@dataclass
class PartitionedGraph:
    # --- static metadata ---
    num_partitions: int
    n_cap: int
    e_cap: int

    # --- per-partition arrays, leading axis P ---
    positions: Any          # (P, N_cap, 3) owned rows valid
    species: Any            # (P, N_cap) int32
    owned_mask: Any         # (P, N_cap) bool — owned rows only
    edge_src: Any           # (P, E_cap) int32
    edge_dst: Any           # (P, E_cap) int32, nondecreasing; pads repeat the last
    edge_offset: Any        # (P, E_cap, 3) float
    edge_mask: Any          # (P, E_cap) bool
    lattice: Any            # (3, 3) replicated

    def to(self, device) -> "PartitionedGraph":
        """A copy whose array fields are torch tensors on ``device``
        (dtypes kept: int32 ids, bool masks, the build's float dtype)."""
        import torch

        def conv(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            return torch.as_tensor(np.asarray(x)).to(device)

        return dataclasses.replace(
            self, **{k: conv(getattr(self, k)) for k in ARRAY_FIELDS})


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
) -> tuple[PartitionedGraph, HostGraphData]:
    """Pad a single-partition plan into a PartitionedGraph (numpy arrays).

    Edges are sorted by dst (stable) so segment reductions see sorted
    indices; padded edge rows repeat the last real dst (nondecreasing,
    in-bounds) and are masked. The same arrays as the JAX package's
    ``build_partitioned_graph`` at P=1, bit for bit.
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

    graph = PartitionedGraph(
        num_partitions=P,
        n_cap=n_cap,
        e_cap=e_cap,
        positions=positions,
        species=spec,
        owned_mask=owned_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_offset=edge_offset,
        edge_mask=edge_mask,
        lattice=np.asarray(lattice, dtype=dtype),
    )
    host = HostGraphData(plan=plan, global_ids=plan.global_ids,
                         owned_counts=owned_counts)
    return graph, host
