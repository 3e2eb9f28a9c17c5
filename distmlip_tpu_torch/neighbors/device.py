"""Neighbor search on the graph's device: a cell list under static caps.

The port of the single-structure half of ``distmlip_tpu/neighbors/device.py``
(``:62-318``). The host pipeline (``neighbors/python_ref.py`` ->
``partition``) is exact but synchronous: every Verlet-skin invalidation
copies positions to the host, rebuilds the graph in numpy and uploads it
again. This module rebuilds the edge arrays on the positions' device
instead, in plain PyTorch (sort, ``searchsorted``, gathers, ``cumsum``),
under fixed capacities, so the refreshed arrays drop into the existing
``PartitionedGraph`` (``partition.graph.refresh_edges``) with the same
shapes.

``cell_list_neighbors``: atoms are binned into a static cell grid (a stable
sort + ``searchsorted`` builds the (ncell, cell_cap) table); candidate pairs
come from a static stencil of neighboring cells, with periodic wrap counts
supplying the image offsets. When the box is smaller than the cutoff the
per-axis reach grows past one wrap, so multi-image pairs (an atom
neighboring its own periodic images) are enumerated exactly: in float64 the
pair set equals ``neighbor_list_numpy``'s.

Emission contract (that of the host builders and of the JAX package's
kernel, element for element):

- edges are enumerated center-major, and the center is ``dst``, so the
  compacted ``dst`` is nondecreasing; within a center the order is stencil
  offset, then the neighbor cell's atoms in index order (a stable sort);
- compaction is an order-preserving cumsum into ``e_cap`` slots; a count
  past ``e_cap`` (or a cell past ``cell_cap``) raises the overflow flag
  instead of dropping pairs silently, and ``n_edges`` stays the true count
  past ``e_cap``; callers rebuild on the host with grown caps;
- offsets are integer periodic-image vectors relative to the unwrapped
  input frame (``neighbor position = positions[src] + off @ lattice`` seen
  from the dst row), the ``python_ref`` convention.

Gathers index with int64; the emitted ``src``, ``dst`` and ``off`` are
int32, as the host-built graph's.

``packed_neighbors`` is the packed half (``:325-447``): the search for a
block-diagonally packed batch (``partition/batch.py``), each structure with
its own cell, as a dense all-pairs x images check per block (the packed
regime is many SMALL structures), compacted in (structure, center,
neighbor, image) order, so ``dst`` is nondecreasing over the whole batch.
Its offsets are CARTESIAN (each block's integer image offset times its own
cell), as the packed graph's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import geometry
from .python_ref import NUMERICAL_TOL, _image_ranges


@dataclass(frozen=True)
class CellListStatic:
    """The static half of a cell-list spec: every field sets a shape or a
    constant of the search."""

    grid: tuple          # (g0, g1, g2) cells per axis
    n_stencil: int       # stencil offsets
    cell_cap: int        # max atoms per cell before overflow
    n_atoms: int         # real atoms (rows [0, n_atoms) of the padded array)
    n_cap: int           # padded node rows
    e_cap: int           # padded edge slots
    pbc: tuple           # (bool, bool, bool)
    r: float             # build cutoff (cutoff + skin)

    @property
    def ncell(self) -> int:
        return int(self.grid[0] * self.grid[1] * self.grid[2])


def estimate_cell_capacity(occupancy: int, floor: int = 4,
                           slack: float = 1.5) -> int:
    """Sticky-style cell capacity from an observed max occupancy: slack
    headroom so atoms migrating between cells mid-trajectory don't
    immediately overflow, floored so near-empty builds keep room."""
    return max(int(math.ceil(occupancy * slack)) + 1, int(floor))


def grow_caps_after_overflow(caps, edges_needed: int, e_cap: int,
                             cell_cap: int, cell_cap_floor: int) -> int:
    """Overflow-growth policy of the device rebuild.

    The search reports the true edge need even past ``e_cap``, so an edge
    bust grows the sticky edge bucket directly; otherwise the bust was the
    cell table (whose edge count is undercounted, so the two cases are
    mutually exclusive as observed) and the cell capacity doubles. Returns
    the (possibly grown) cell-cap floor; ``caps`` is grown in place.
    """
    if edges_needed > e_cap:
        caps.get("edges", int(edges_needed))
        return int(cell_cap_floor)
    return max(int(cell_cap_floor), 2 * int(cell_cap))


def build_cell_list_spec(
    lattice,
    pbc,
    r: float,
    n_atoms: int,
    n_cap: int,
    e_cap: int,
    positions=None,
    cell_cap: int | None = None,
    min_cell_cap: int = 4,
    dtype=np.float32,
):
    """Host-side spec construction (numpy): grid dims, stencil, capacities.

    Grid: ``g_a = max(1, floor(d_a / r))`` cells along each periodic axis
    (``d_a`` = plane spacing, skew-safe), one cell along non-periodic axes
    (atoms are unbounded there; the distance filter does the work). The
    stencil reach per periodic axis is ``floor(r / w_a) + 1`` cells
    (``w_a = d_a / g_a``): two points whose extended cells differ by D
    along axis a are at least ``(D - 1) * w_a`` apart, so the reach covers
    every pair within ``r``, multi-wrap (multi-image) pairs included.

    ``cell_cap`` defaults to the observed max occupancy of ``positions``
    (plus slack), floored at ``min_cell_cap``; pass the grown floor after
    an overflow. Returns ``(static, arrays)``; ``arrays`` holds the
    lattice, its inverse (in ``dtype``) and the int32 stencil as numpy
    (``as_device_arrays`` moves them to a device once).
    """
    lattice = np.asarray(lattice, dtype=np.float64)
    pbc_mask = np.asarray(pbc, dtype=bool)
    d = geometry.plane_spacings(lattice)
    grid = np.where(pbc_mask, np.maximum(
        1, np.floor(d / max(r, 1e-6)).astype(np.int64)), 1)
    w = d / grid
    reach = np.where(pbc_mask,
                     np.floor((r + NUMERICAL_TOL) / w).astype(np.int64) + 1,
                     0)
    ax = [np.arange(-k, k + 1) for k in reach]
    stencil = np.stack(
        np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
    if cell_cap is None:
        occ = 0
        if positions is not None and n_atoms > 0:
            wrapped, _ = geometry.wrap_positions(
                np.asarray(positions, dtype=np.float64)[:n_atoms],
                lattice, pbc_mask)
            frac = geometry.cart_to_frac(wrapped, lattice)
            c = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
            flat = (c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2]
            occ = int(np.bincount(flat).max())
        else:
            occ = n_atoms
        cell_cap = estimate_cell_capacity(occ, floor=min_cell_cap)
    static = CellListStatic(
        grid=tuple(int(g) for g in grid),
        n_stencil=int(len(stencil)),
        cell_cap=int(cell_cap),
        n_atoms=int(n_atoms),
        n_cap=int(n_cap),
        e_cap=int(e_cap),
        pbc=tuple(bool(b) for b in pbc_mask),
        r=float(r),
    )
    arrays = {
        "lattice": lattice.astype(dtype),
        "inv_lattice": np.linalg.inv(lattice).astype(dtype),
        "stencil": stencil.astype(np.int32),
    }
    return static, arrays


def as_device_arrays(arrays, device) -> dict:
    """The spec's arrays as tensors on ``device``; the calculator converts
    once per spec, so a refresh copies nothing to the device for them."""
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


def _times_3x3(x, m):
    """``x @ m`` for a (..., 3) x and a (3, 3) m as three products and two
    sums in a fixed order: elementwise float arithmetic rounds the same on
    every device, where a library's matrix product may not, so the card
    and the CPU bin and filter the same pairs."""
    return x[..., 0:1] * m[0] + x[..., 1:2] * m[1] + x[..., 2:3] * m[2]


def _wrap_device(positions, inv_lattice, pbc_mask):
    """(frac, shift, wrapped_frac) with wrapping only on periodic axes, on
    the positions' device: the analogue of ``geometry.wrap_positions``."""
    frac = _times_3x3(positions, inv_lattice)
    shift = torch.where(pbc_mask, torch.floor(frac), torch.zeros_like(frac))
    return frac, shift.to(torch.int32), frac - shift


def _compact_edges(valid, e_cap: int):
    """Order-preserving cumsum compaction of a flat candidate mask into
    ``e_cap`` slots. Returns ``(index, n_edges, overflow)``: ``index`` is
    the (e_cap,) int64 flat index of each slot's candidate, in order (past
    ``n_edges`` it holds ``len(valid)``); ``n_edges`` counts every valid
    candidate, exact past ``e_cap``; ``overflow`` flags ``n_edges > e_cap``
    (the candidates past ``e_cap`` are dropped). Both are 0-d tensors on
    ``valid``'s device."""
    csum = torch.cumsum(valid, 0, dtype=torch.int64)
    n_edges = (csum[-1] if len(csum)
               else torch.zeros((), dtype=torch.int64, device=valid.device))
    # slot j holds the first candidate whose running count reaches j + 1
    want = torch.arange(1, e_cap + 1, dtype=torch.int64, device=valid.device)
    index = torch.searchsorted(csum, want)
    return index, n_edges, n_edges > e_cap


def cell_list_neighbors(static: CellListStatic, arrays, positions):
    """Single-structure neighbor search on ``positions``' device, in its
    dtype.

    ``positions``: (n_cap, 3) unwrapped input-frame coordinates (padded
    rows ignored); ``arrays`` the spec's arrays as tensors on the same
    device (``as_device_arrays``). Returns ``(src, dst, off, n_edges,
    overflow)``: (e_cap,)-shaped int32 ``src`` and ``dst`` (``dst`` is the
    center atom and nondecreasing over the real prefix; empty slots hold
    0), the (e_cap, 3) int32 image offset ``off`` of ``src`` relative to
    the input frame (0 in empty slots), and the 0-d ``n_edges`` and
    ``overflow`` (a cell or edge capacity bust: the caller must then
    discard the arrays).
    """
    st = static
    dev, dtype = positions.device, positions.dtype
    g = torch.tensor(st.grid, dtype=torch.int64, device=dev)
    gf = g.to(dtype)
    pbc_mask = torch.tensor(st.pbc, device=dev)
    lat = arrays["lattice"].to(device=dev, dtype=dtype)
    inv = arrays["inv_lattice"].to(device=dev, dtype=dtype)
    stencil = arrays["stencil"].to(device=dev, dtype=torch.int64)
    ncell, cap, n_cap, S = st.ncell, st.cell_cap, st.n_cap, st.n_stencil
    rows = torch.arange(n_cap, dtype=torch.int64, device=dev)
    valid_atom = rows < st.n_atoms

    _, shift, w = _wrap_device(positions, inv, pbc_mask)
    c = torch.minimum(torch.floor(w * gf).to(torch.int64).clamp(min=0), g - 1)
    flat = (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2]
    ids = torch.where(valid_atom, flat, torch.full_like(flat, ncell))

    # --- bin by a stable sort: (ncell, cap) table of atom indices ---
    sorted_ids, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(ncell + 1, dtype=torch.int64, device=dev))
    rank = rows - starts[sorted_ids]
    in_cell = sorted_ids < ncell
    overflow_cells = torch.any(in_cell & (rank >= cap))
    # one spare slot past the table takes the dropped entries; never read
    slot = torch.where(in_cell & (rank < cap), sorted_ids * cap + rank,
                       torch.full_like(rank, ncell * cap))
    table = torch.full((ncell * cap + 1,), n_cap, dtype=torch.int64, device=dev)
    table[slot] = order
    table = table[:ncell * cap].reshape(ncell, cap)

    # --- stencil enumeration: extended cells -> (neighbor cell, wrap) ---
    tc = c[:, None, :] + stencil[None, :, :]                   # (n_cap, S, 3)
    wrap = torch.div(tc, g, rounding_mode="floor")             # image count
    cin = tc - wrap * g
    ok_st = torch.all(pbc_mask | (wrap == 0), dim=-1)          # (n_cap, S)
    flat_t = (cin[..., 0] * g[1] + cin[..., 1]) * g[2] + cin[..., 2]
    cand = table[flat_t]                                       # (n_cap, S, cap)
    valid_j = cand < n_cap
    jc = torch.clamp(cand, max=n_cap - 1)

    # --- distance filter against the center's wrapped position ---
    wpos = _times_3x3(w, lat)                                  # (n_cap, 3)
    img_cart = _times_3x3(wrap.to(dtype), lat)                 # (n_cap, S, 3)
    diff = wpos[jc]                                            # (n_cap, S, cap, 3)
    diff += img_cart[:, :, None, :]
    diff -= wpos[:, None, None, :]
    diff *= diff
    d2 = diff[..., 0] + diff[..., 1] + diff[..., 2]            # (n_cap, S, cap), in order
    del diff
    r2 = torch.tensor((st.r + NUMERICAL_TOL) ** 2, dtype=dtype, device=dev)
    tiny = torch.tensor(NUMERICAL_TOL ** 2, dtype=dtype, device=dev)
    valid = (valid_j & ok_st[:, :, None] & valid_atom[:, None, None]
             & (d2 < r2) & (d2 > tiny))
    del d2, valid_j

    # --- emit: center = dst (sorted by construction), neighbor = src ---
    # the ref edge (center i, neighbor j at image -wrap) has
    # off = -wrap + shift[src] - shift[dst] in the unwrapped input frame;
    # only the kept slots are decoded, not every candidate
    index, n_edges, overflow_edges = _compact_edges(valid.reshape(-1), st.e_cap)
    kept = torch.arange(st.e_cap, dtype=torch.int64, device=dev) < n_edges
    index = torch.where(kept, index, torch.zeros_like(index))
    i = index // (S * cap)
    s = (index // cap) % S
    j = jc.reshape(-1)[index]
    off = -wrap[i, s] + shift[j].to(torch.int64) - shift[i].to(torch.int64)
    src = torch.where(kept, j, 0).to(torch.int32)
    dst = torch.where(kept, i, 0).to(torch.int32)
    off = torch.where(kept[:, None], off, 0).to(torch.int32)
    return src, dst, off, n_edges, overflow_cells | overflow_edges


def device_neighbor_list(static: CellListStatic, arrays, positions):
    """Host entry of :func:`cell_list_neighbors`: ``arrays`` as the spec
    returned them (numpy) or as tensors, ``positions`` a (n_cap, 3) numpy
    array or tensor; runs on the positions' device (the CPU for numpy)."""
    positions = torch.as_tensor(positions)
    return cell_list_neighbors(static, as_device_arrays(arrays, positions.device),
                               positions)


# ---------------------------------------------------------------------------
# Packed (block-diagonal) batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedStatic:
    """The static half of a packed-batch spec."""

    n_struct: int        # real structures
    n_max: int           # max atoms over structures
    m_max: int           # max periodic images over structures
    n_cap: int           # packed node rows
    e_cap: int           # packed edge slots
    r: float             # build cutoff (cutoff + skin)


def build_packed_spec(cells, pbcs, n_atoms, node_offsets, r: float, n_cap: int,
                      e_cap: int, dtype=np.float32):
    """Spec for refreshing a block-diagonally packed graph on its device
    (``distmlip_tpu/neighbors/device.py:338``): per-structure cells, pbc and
    image sets padded to the batch maxima. Returns ``(static, arrays)``,
    ``arrays`` as numpy (``as_device_arrays`` moves them once)."""
    B = len(n_atoms)
    n_max = int(max(int(n) for n in n_atoms))
    imgs_list = []
    for cell, pbc in zip(cells, pbcs):
        n = _image_ranges(np.asarray(cell, dtype=np.float64), pbc, r)
        ax = [np.arange(-k, k + 1) for k in n]
        imgs_list.append(np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3))
    m_max = max(len(m) for m in imgs_list)
    imgs = np.zeros((B, m_max, 3), dtype=np.int32)
    img_mask = np.zeros((B, m_max), dtype=bool)
    for b, m in enumerate(imgs_list):
        imgs[b, :len(m)] = m
        img_mask[b, :len(m)] = True
    gather_idx = np.zeros((B, n_max), dtype=np.int32)
    atom_mask = np.zeros((B, n_max), dtype=bool)
    for b, n in enumerate(n_atoms):
        n = int(n)
        gather_idx[b, :n] = np.arange(n) + int(node_offsets[b])
        atom_mask[b, :n] = True
    cells_np = np.stack([np.asarray(c, dtype=np.float64) for c in cells])
    static = PackedStatic(n_struct=B, n_max=n_max, m_max=m_max, n_cap=int(n_cap),
                          e_cap=int(e_cap), r=float(r))
    arrays = {
        "gather_idx": gather_idx,
        "atom_mask": atom_mask,
        "cells": cells_np.astype(dtype),
        "inv_cells": np.stack([np.linalg.inv(c) for c in cells_np]).astype(dtype),
        "pbc": np.stack([np.asarray(p, dtype=bool) for p in pbcs]),
        "imgs": imgs,
        "img_mask": img_mask,
    }
    return static, arrays


def _times_cells(x, cells):
    """``x @ cells[b]`` per structure for a (B, ..., 3) x and (B, 3, 3)
    cells, in the fixed order of ``_times_3x3``."""
    c = cells.reshape((cells.shape[0],) + (1,) * (x.dim() - 2) + (3, 3))
    return x[..., 0:1] * c[..., 0, :] + x[..., 1:2] * c[..., 1, :] + x[..., 2:3] * c[..., 2, :]


def packed_neighbors(static: PackedStatic, arrays, positions):
    """Packed-batch neighbor search on ``positions``' device, in its dtype
    (``distmlip_tpu/neighbors/device.py:387``).

    ``positions``: (n_cap, 3) packed input-frame coordinates; ``arrays`` the
    spec's arrays as tensors on that device. Returns ``(src, dst, off_cart,
    n_edges, overflow)``: packed-row int32 ``src`` and ``dst`` (``dst``
    nondecreasing: blocks in packing order, centers within), CARTESIAN
    offsets in ``positions``' dtype (0 in empty slots), the 0-d true edge
    count and the overflow flag (``n_edges > e_cap``).
    """
    st = static
    dev, dtype = positions.device, positions.dtype
    gi = arrays["gather_idx"].to(device=dev, dtype=torch.int64)
    am = arrays["atom_mask"].to(dev)
    cells = arrays["cells"].to(device=dev, dtype=dtype)
    invs = arrays["inv_cells"].to(device=dev, dtype=dtype)
    pbc = arrays["pbc"].to(dev)
    imgs = arrays["imgs"].to(device=dev, dtype=torch.int64)
    img_mask = arrays["img_mask"].to(dev)
    n, m = st.n_max, st.m_max

    p = positions[gi]                                         # (B, n, 3)
    frac = _times_cells(p, invs)
    shift = torch.where(pbc[:, None, :], torch.floor(frac), torch.zeros_like(frac))
    wc = _times_cells(frac - shift, cells)                    # wrapped cartesian
    shift = shift.to(torch.int64)
    imgc = _times_cells(imgs.to(dtype), cells)                # (B, m, 3)
    # diff[b, k (center), j (neighbor), m] = wc[b, j] + imgc[b, m] - wc[b, k]
    diff = (wc[:, None, :, None, :] + imgc[:, None, None, :, :]) - wc[:, :, None, None, :]
    diff *= diff
    d2 = diff[..., 0] + diff[..., 1] + diff[..., 2]            # (B, k, j, m)
    del diff
    r2 = torch.tensor((st.r + NUMERICAL_TOL) ** 2, dtype=dtype, device=dev)
    tiny = torch.tensor(NUMERICAL_TOL ** 2, dtype=dtype, device=dev)
    valid = (am[:, :, None, None] & am[:, None, :, None] & img_mask[:, None, None, :]
             & (d2 < r2) & (d2 > tiny))
    del d2

    index, n_edges, overflow = _compact_edges(valid.reshape(-1), st.e_cap)
    kept = torch.arange(st.e_cap, dtype=torch.int64, device=dev) < n_edges
    index = torch.where(kept, index, torch.zeros_like(index))
    b = index // (n * n * m)
    k = (index // (n * m)) % n
    j = (index // m) % n
    mi = index % m
    off_int = -imgs[b, mi] + shift[b, j] - shift[b, k]        # (e_cap, 3)
    off = _times_cells(off_int.to(dtype)[:, None, :], cells[b])[:, 0]
    src = torch.where(kept, gi[b, j], 0).to(torch.int32)
    dst = torch.where(kept, gi[b, k], 0).to(torch.int32)
    off = torch.where(kept[:, None], off, torch.zeros_like(off))
    return src, dst, off, n_edges, overflow


def device_packed_neighbor_list(static: PackedStatic, arrays, positions):
    """Host entry of :func:`packed_neighbors`: ``arrays`` as numpy or
    tensors, ``positions`` a (n_cap, 3) array or tensor; runs on the
    positions' device."""
    positions = torch.as_tensor(positions)
    return packed_neighbors(static, as_device_arrays(arrays, positions.device), positions)
