from .halo import LocalGraph, local_graph_from_stacked
from .runtime import (make_batched_potential_fn, make_packed_energy_fn, make_potential_fn,
                      make_total_energy)

__all__ = ["LocalGraph", "local_graph_from_stacked", "make_batched_potential_fn",
           "make_packed_energy_fn", "make_potential_fn", "make_total_energy"]
