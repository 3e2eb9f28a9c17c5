"""Lattice / periodic-boundary geometry.

Host-side (numpy, float64) helpers used by neighbor search and partitioning,
plus device-side (torch) variants used inside model code (strain
application for stress, edge-vector computation).

Reference semantics being matched (behavior, not code):
  - fractional wrapping only along periodic axes, original shift retained for
    image-offset correction (reference fpis.c:490-517);
  - cartesian->wrapped-fractional helper (reference dist.py:128-156).

Conventions:
  - ``lattice`` is a (3, 3) array whose **rows** are the lattice vectors, so
    ``cart = frac @ lattice``.
  - image ``offsets`` are integer (3,) vectors such that the neighbor position
    in the *input* (unwrapped) frame is ``cart[j] + offsets @ lattice``.
"""

from __future__ import annotations

import numpy as np


def cart_to_frac(cart: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """Cartesian -> fractional: solve frac @ lattice = cart."""
    return np.linalg.solve(lattice.T, np.asarray(cart, dtype=np.float64).T).T


def frac_to_cart(frac: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    return np.asarray(frac, dtype=np.float64) @ np.asarray(lattice, dtype=np.float64)


def wrap_frac(frac: np.ndarray, pbc: np.ndarray):
    """Wrap fractional coords into [0, 1) along periodic axes.

    Returns (wrapped_frac, shift) where ``shift`` is the integer number of
    lattice translations removed: ``wrapped = frac - shift`` with ``shift = 0``
    on non-periodic axes.
    """
    frac = np.asarray(frac, dtype=np.float64)
    pbc_mask = np.asarray(pbc, dtype=bool)
    shift = np.where(pbc_mask[None, :], np.floor(frac), 0.0)
    wrapped = frac - shift
    # Guard against frac values like -1e-16 -> wrapped == 1.0 exactly.
    on_edge = pbc_mask[None, :] & (wrapped >= 1.0)
    shift = shift + np.where(on_edge, 1.0, 0.0)
    wrapped = frac - shift
    return wrapped, shift.astype(np.int64)


def wrap_positions(cart: np.ndarray, lattice: np.ndarray, pbc) -> tuple[np.ndarray, np.ndarray]:
    """Wrap cartesian positions into the cell; returns (wrapped_cart, shift)."""
    frac = cart_to_frac(cart, lattice)
    wrapped, shift = wrap_frac(frac, pbc)
    return frac_to_cart(wrapped, lattice), shift


def plane_spacings(lattice: np.ndarray) -> np.ndarray:
    """Distance between adjacent lattice planes along each axis.

    ``d_i = 1 / |row_i(inv(lattice))|`` — used to size the periodic-image
    search window (reference fpis.c:507-517 uses the reciprocal lattice for
    the same purpose).
    """
    inv = np.linalg.inv(np.asarray(lattice, dtype=np.float64))
    return 1.0 / np.linalg.norm(inv, axis=0)


def cell_volume(lattice: np.ndarray) -> float:
    return float(abs(np.linalg.det(np.asarray(lattice, dtype=np.float64))))


def make_supercell(
    frac: np.ndarray, lattice: np.ndarray, reps: tuple[int, int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """Tile a unit cell ``reps`` times along each axis.

    Returns (frac_coords_of_supercell, supercell_lattice). Species tiling is
    the caller's job (``np.tile(species, np.prod(reps))`` — image-major order
    matching the returned coordinates).
    """
    frac = np.asarray(frac, dtype=np.float64)
    nx, ny, nz = reps
    shifts = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    new_frac = (frac[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    new_frac /= np.array([nx, ny, nz], dtype=np.float64)
    new_lattice = np.asarray(lattice, dtype=np.float64) * np.array(reps, dtype=np.float64)[:, None]
    return new_frac, new_lattice


# ---------------------------------------------------------------------------
# Device-side (torch) helpers — differentiable, on the tensors' device.
# ---------------------------------------------------------------------------

def edge_vectors(positions, lattice, src, dst, offsets):
    """Edge displacement vectors r_dst - r_src + offsets @ lattice (torch).

    ``positions`` (N,3), ``lattice`` (3,3) rows=vectors, ``src``/``dst`` (E,),
    ``offsets`` (E,3) float or int. Differentiable wrt positions and lattice.
    """
    disp = positions[dst] - positions[src]
    return disp + offsets.to(positions.dtype) @ lattice


def apply_strain(positions, lattice, strain):
    """Apply a symmetric strain: x -> x @ (I + strain).

    Used for stress: stress = (1/V) dE/dstrain at strain=0 (reference
    pes.py:140-145 computes the same through torch autograd).
    """
    import torch

    defm = (torch.eye(3, dtype=positions.dtype, device=positions.device)
            + 0.5 * (strain + strain.T))
    return positions @ defm, lattice @ defm
