"""Periodic neighbor search: on the host (numpy) and on the graph's device.

The port's ``neighbor_list`` runs the vectorized linked-cell search of
``python_ref``; the native C++ FPIS of the JAX package is queued in
ROADMAP.md for a later slice. ``device`` holds the single-structure cell
list and the packed-batch search that rebuild a cached graph's edges on
its device.
"""

from .device import (CellListStatic, PackedStatic, build_cell_list_spec,
                     build_packed_spec, cell_list_neighbors, device_neighbor_list,
                     device_packed_neighbor_list, estimate_cell_capacity,
                     grow_caps_after_overflow, packed_neighbors)
from .python_ref import NeighborList, neighbor_list_brute, neighbor_list_numpy

neighbor_list = neighbor_list_numpy


__all__ = [
    "CellListStatic",
    "PackedStatic",
    "build_packed_spec",
    "packed_neighbors",
    "device_packed_neighbor_list",
    "build_cell_list_spec",
    "cell_list_neighbors",
    "device_neighbor_list",
    "estimate_cell_capacity",
    "grow_caps_after_overflow",
    "NeighborList",
    "neighbor_list",
    "neighbor_list_brute",
    "neighbor_list_numpy",
]
