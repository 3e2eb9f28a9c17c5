from .capacity import CapacityPolicy, round_capacity
from .graph import HostGraphData, PartitionedGraph, build_partitioned_graph
from .partitioner import PartitionError, build_plan
from .plan import PartitionPlan

__all__ = [
    "PartitionPlan",
    "build_plan",
    "PartitionError",
    "PartitionedGraph",
    "HostGraphData",
    "build_partitioned_graph",
    "CapacityPolicy",
    "round_capacity",
]
