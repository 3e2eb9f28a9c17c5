from .batch import (PackedHostData, bucket_key, build_packed_refresh_spec,
                    device_refresh_packed, graph_live_slots, pack_structures,
                    packed_stats, slot_waste_frac)
from .capacity import (BucketPolicy, CapacityPolicy, FixedCaps, fixed_caps_for_batches,
                       geometric_bucket, round_capacity)
from .graph import (HostGraphData, PartitionedGraph, build_partitioned_graph,
                    device_refresh_graph, refresh_edges)
from .partitioner import PartitionError, build_plan
from .plan import PartitionPlan

__all__ = [
    "PartitionPlan",
    "build_plan",
    "PartitionError",
    "PartitionedGraph",
    "HostGraphData",
    "build_partitioned_graph",
    "refresh_edges",
    "device_refresh_graph",
    "CapacityPolicy",
    "BucketPolicy",
    "FixedCaps",
    "fixed_caps_for_batches",
    "geometric_bucket",
    "round_capacity",
    "PackedHostData",
    "pack_structures",
    "bucket_key",
    "build_packed_refresh_spec",
    "device_refresh_packed",
    "slot_waste_frac",
    "graph_live_slots",
    "packed_stats",
]
