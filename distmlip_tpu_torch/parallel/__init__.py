from .halo import LocalGraph, local_graph_from_stacked
from .runtime import make_potential_fn, make_total_energy

__all__ = ["LocalGraph", "local_graph_from_stacked", "make_potential_fn",
           "make_total_energy"]
