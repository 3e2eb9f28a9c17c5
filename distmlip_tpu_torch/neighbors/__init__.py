"""Periodic neighbor search: on the host (native C++) and on the graph's device.

The port's ``neighbor_list`` is the native C++/OpenMP FPIS of ``native``
(built with g++ at first use), as the JAX package's is.
``neighbor_list_numpy`` (the vectorized linked-cell search of
``python_ref``) and ``neighbor_list_brute`` stay as the tests' oracles;
they give the same edge set in another order. ``device`` holds the
single-structure cell list and the packed-batch search that rebuild a
cached graph's edges on its device.
"""

from .device import (CellListStatic, PackedStatic, build_cell_list_spec,
                     build_packed_spec, cell_list_neighbors, device_neighbor_list,
                     device_packed_neighbor_list, estimate_cell_capacity,
                     grow_caps_after_overflow, packed_neighbors)
from .native import neighbor_list
from .python_ref import NeighborList, neighbor_list_brute, neighbor_list_numpy


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
