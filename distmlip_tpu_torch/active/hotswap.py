"""Hot swap: install fine-tuned weights into live serving
(``distmlip_tpu/active/hotswap.py``).

A fine-tuned parameter tree with the SAME structure (nested dict keys, list
lengths, ``None`` leaves), leaf shapes and dtypes as the live one drops into
every serving lane unchanged: the bucket ladder, the skin caches and the
kernels' builds all keep serving. So a swap is: take the potential's lock
(no batch is mid-dispatch), copy the tree onto the potential's device,
assign it, release. A batch in flight finishes wholly on the old weights
(it holds the lock), and one dispatched after the swap returns sees only the
new ones. ``compile_count`` (the shape buckets dispatched) is snapshotted
around the swap and must not move; queued requests keep their order and
nothing is dropped.

Cache-key roll-forward: a :class:`~distmlip_tpu_torch.fleet.FleetRouter`
keys its result cache by ``model_id``. The swap installs the new weights on
EVERY alive replica first, then rolls ``router.model_id`` to a new identity
(given by the caller, or the old id stamped with a digest of the new
parameter VALUES). After the roll every new submission keys under the new
id against replicas that all serve the new weights; old-weight results stay
under the old id, which no later submission reaches.

:func:`params_digest` walks the leaves in ``jax.tree.leaves`` order (dict
keys sorted, lists in order, ``None`` skipped) and hashes each leaf's shape
and bytes as the JAX package does, so the same weights give the same digest
and the same rolled ``model_id`` in both packages. There is no AOT
fingerprint to roll: the port has no AOT executable cache (ROADMAP.md A10b).

Every function takes torch tensor trees or numpy trees.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from ..device import device_phase
from ..utils.checkpoint import _host_array


class HotSwapError(RuntimeError):
    """The candidate params cannot be installed as a pure swap (tree
    structure, leaf shape or dtype mismatch: the serving programs would
    read the buffers wrongly)."""


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple tree in ``jax.tree.leaves``
    order: dict keys sorted, sequences in order, ``None`` skipped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def params_digest(params) -> str:
    """Short content digest of the parameter VALUES, the model-identity
    suffix the result-cache key rolls forward on a swap (the JAX package's
    digest of the same weights)."""
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        arr = _host_array(leaf)
        h.update(arr.shape.__repr__().encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:12]


def _leaf_meta(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return tuple(a.shape), a.dtype.name


def _check_tree(live, new, path: str) -> None:
    if isinstance(live, dict) or isinstance(new, dict):
        if not (isinstance(live, dict) and isinstance(new, dict)) or set(live) != set(new):
            raise HotSwapError(f"param tree structure changed at {path or '/'}: "
                               f"{_node(new)} vs live {_node(live)}")
        for k in sorted(live):
            _check_tree(live[k], new[k], f"{path}/{k}")
    elif isinstance(live, (list, tuple)) or isinstance(new, (list, tuple)):
        if not (isinstance(live, (list, tuple)) and isinstance(new, (list, tuple))
                and len(live) == len(new)):
            raise HotSwapError(f"param tree structure changed at {path or '/'}: "
                               f"{_node(new)} vs live {_node(live)}")
        for i, (a, b) in enumerate(zip(live, new)):
            _check_tree(a, b, f"{path}/{i}")
    elif (live is None) != (new is None):
        raise HotSwapError(f"param tree structure changed at {path}: "
                           f"{_node(new)} vs live {_node(live)}")
    elif live is not None:
        (sa, da), (sb, db) = _leaf_meta(live), _leaf_meta(new)
        if sa != sb or da != db:
            raise HotSwapError(f"param leaf {path} changed: {sb}/{db} vs live {sa}/{da} — "
                               f"a hot swap must not alter the serving program")


def _node(x) -> str:
    if isinstance(x, dict):
        return f"dict{sorted(x)}"
    if isinstance(x, (list, tuple)):
        return f"list[{len(x)}]"
    return "None" if x is None else "leaf"


def check_swappable(live_params, new_params) -> None:
    """Raise :class:`HotSwapError` unless ``new_params`` is a pure drop-in
    for ``live_params`` (same structure, leaf shapes and dtypes)."""
    _check_tree(live_params, new_params, "")


def device_copy(tree, device):
    """A copy of ``tree`` (tensors or numpy) on ``device``: the live weights
    never alias the caller's (a trainer's master weights go on stepping)."""
    if isinstance(tree, dict):
        return {k: device_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [device_copy(v, device) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return torch.as_tensor(np.array(tree), device=device)


def install_params(pot, new_params) -> None:
    """Assign a copy of ``new_params`` on ``pot``'s device as ``pot.params``
    under the potential's lock and the device's phase lock (the copy's
    allocations never land in another replica's measured batch)."""
    device = getattr(pot, "device", torch.device("cpu"))
    lock = getattr(pot, "_lock", None)
    with lock if lock is not None else contextlib.nullcontext(), device_phase(device):
        pot.params = device_copy(new_params, device)


def swap_potential_params(pot, new_params) -> None:
    """Install ``new_params`` on one potential as a pure swap, serialized
    against any in-flight ``calculate`` on the potential's own lock. Works
    for ``BatchedPotential``, ``DistPotential`` and
    ``EnsembleBatchedPotential`` (whose member 0 follows the primary)."""
    set_primary = getattr(pot, "set_primary", None)
    if set_primary is not None:
        set_primary(new_params)
        return
    check_swappable(pot.params, new_params)
    install_params(pot, new_params)


def hot_swap_engine(engine, new_params) -> dict:
    """Swap one ``ServeEngine``'s serving weights in place.

    Swaps the shared batched potential and a fallback whose params are
    drop-in compatible (an incompatible user-owned fallback is left alone
    and reported). Returns a report dict; raises :class:`HotSwapError`
    (nothing swapped) when the primary potential rejects the tree."""
    pot = engine.potential
    compile_before = engine.compile_count
    check_swappable(pot.params, new_params)  # validate BEFORE any mutation
    swap_potential_params(pot, new_params)
    swapped_lanes = ["potential"]
    skipped_lanes = []
    for name in ("_spatial_lane", "fallback"):
        lane = getattr(engine, name, None)
        if lane is None:
            continue
        try:
            swap_potential_params(lane, new_params)
            swapped_lanes.append(name.lstrip("_"))
        except HotSwapError:
            # a user-owned fallback may legitimately run a different model
            skipped_lanes.append(name.lstrip("_"))
    compile_after = engine.compile_count
    if compile_after != compile_before:
        raise HotSwapError(
            f"hot swap changed compile_count {compile_before} -> {compile_after}; "
            f"the swap must reuse every serving bucket")
    return {"compile_count": compile_after,
            "swapped_lanes": swapped_lanes,
            "skipped_lanes": skipped_lanes}


def hot_swap_router(router, new_params, *, model_id: str | None = None) -> dict:
    """Swap every ALIVE replica's weights, then roll the cache identity.

    Replicas first, identity last: once ``model_id`` changes, every new
    submission keys (and coalesces) under the new identity against replicas
    that all serve the new weights. Every alive replica is validated before
    any is mutated, so a refusal leaves the whole fleet as it was. Dead
    replicas are skipped. Returns the new ``model_id`` and per-replica
    swap reports."""
    base_id = router.model_id.split("#", 1)[0]
    new_id = (str(model_id) if model_id is not None
              else f"{base_id}#{params_digest(new_params)}")
    for rep in router.replicas.values():
        if rep.alive:
            check_swappable(rep.engine.potential.params, new_params)
    replicas = {}
    for rid, rep in router.replicas.items():
        if not rep.alive:
            replicas[rid] = {"skipped": "dead"}
            continue
        replicas[rid] = hot_swap_engine(rep.engine, new_params)
    old_id, router.model_id = router.model_id, new_id
    return {"model_id": new_id, "previous_model_id": old_id, "replicas": replicas}


def hot_swap(target, new_params, **kwargs) -> dict:
    """Dispatch on the serving surface: a FleetRouter (swap + cache-key
    roll), a ServeEngine (swap all lanes), or a bare potential."""
    if hasattr(target, "replicas") and hasattr(target, "model_id"):
        return hot_swap_router(target, new_params, **kwargs)
    if hasattr(target, "potential") and hasattr(target, "compile_count"):
        return hot_swap_engine(target, new_params, **kwargs)
    swap_potential_params(target, new_params)
    return {"swapped_lanes": ["potential"]}
