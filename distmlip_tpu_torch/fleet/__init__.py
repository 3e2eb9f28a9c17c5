"""Serving fleet: multi-replica routing, tenancy, caching and failover
(``distmlip_tpu/fleet``).

The serving layer over :mod:`distmlip_tpu_torch.serve`: N ``ServeEngine``
replicas in process (they share the host's card) behind a
:class:`FleetRouter` with per-tenant admission quotas and weighted
fairness, a content-addressed :class:`ResultCache` so duplicate screening
traffic never reaches a replica, and wedge-detecting health monitoring
with zero-request-loss failover (:class:`ReplicaHealth`). The JAX
package's AOT executable cache is not ported (ROADMAP.md A10b).

Quick start::

    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.fleet import ResultCache, make_fleet

    router = make_fleet(
        2, lambda i: BatchedPotential(model, params),
        result_cache=ResultCache(max_bytes=256 * 2**20),
        model_id="mace-mp0")
    fut = router.submit(atoms, tenant="interactive", priority=-1)
    result = fut.result()      # survives any single replica dying
    router.close()

Chaos drill / gate: ``python -m distmlip_tpu_torch.tools.load_test
--fleet 2 --chaos kill-replica --check``.
"""

from .replica import Replica, ReplicaHealth
from .result_cache import ResultCache, cache_key, structure_key
from .router import FleetError, FleetRouter, FleetStats, make_fleet
from .tenancy import FairScheduler, TenantConfig, TokenBucket

__all__ = [
    "FleetRouter",
    "FleetStats",
    "FleetError",
    "make_fleet",
    "Replica",
    "ReplicaHealth",
    "ResultCache",
    "cache_key",
    "structure_key",
    "TenantConfig",
    "TokenBucket",
    "FairScheduler",
]
