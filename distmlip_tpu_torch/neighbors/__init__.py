"""Periodic neighbor search on the host (numpy).

The port's ``neighbor_list`` runs the vectorized linked-cell search of
``python_ref``; the native C++ FPIS of the JAX package is queued in
ROADMAP.md for a later slice.
"""

from .python_ref import NeighborList, neighbor_list_brute, neighbor_list_numpy

neighbor_list = neighbor_list_numpy


__all__ = [
    "NeighborList",
    "neighbor_list",
    "neighbor_list_brute",
    "neighbor_list_numpy",
]
