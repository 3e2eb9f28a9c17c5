"""User-facing potential: the Atoms -> (E, F, sigma) pipeline on one card.

``DistPotential`` ports ``distmlip_tpu/calculators/calculator.py:77``: the
host builds the neighbor list, the slab plan and the capacity-padded graph,
uploads it once, and the model's energy and its autograd forces and stress
run on the device. With ``num_partitions=P > 1`` the structure is split
into P slabs with halos (zero redundancy: every edge is computed once, by
its dst atom's owner), and the P partitions run on the one card as one
flattened graph with the halo exchange as index copies
(``parallel/halo.py``); forces come back to each atom's owner.

With ``skin > 0`` the neighbor graph is built at cutoff+skin, uploaded
once, and REUSED across steps — only positions are re-uploaded — until any
atom moves skin/2 from its build-time position (Verlet-list criterion:
results stay exact because the model envelopes zero the extra skin edges).
Such an invalidation, with the structure unchanged and no bond graph, is
served on the graph's device (``device_rebuild``): the cell list of
``neighbors/device.py`` rebuilds the edge arrays and ``refresh_edges``
swaps them into the cached graph in place; only an overflow of its
capacities takes the host rebuild, with grown caps.

For a model with a bond graph (CHGNet: ``cfg.use_bond_graph``) the host
also builds the bond and line graphs at ``bond_cutoff + skin``. With
``compute_magmom=True`` the magmoms ride the energy forward as an aux
output (the fused site readout, ``model.energy_and_aux_fn``).

Where the device refresh cannot serve the skin cache's invalidations (P >
1, a bond graph), the background prefetch rebuild (``async_rebuild``, on by
default as in the JAX package) builds the next graph on a worker thread
once ``prefetch_frac`` of the skin budget is spent, and the invalidation
adopts it when the structure is the same: the native search releases the
GIL, and on a card the worker uploads on its own stream, which the
adopting step waits on in device order, not on the host. A changed cell
(a relaxation with the cell) never hits the cache, so it never starts one.

``compute_dtype="bfloat16"`` rebuilds MACE, eSCN, TensorNet or CHGNet at
bf16 compute (their B1, B3 and B2 kernels' bf16 instantiations on the
card); energies, forces, stress and CHGNet's magmoms come out in float32
all the same.

``EnsemblePotential`` evaluates several parameter sets of one model on one
graph (the mean, variance and per-member results); ``calculators/
device_md.py``'s ``DeviceMD`` steps MD with its state on the device and
puts its refreshed graphs back into this skin cache (``_mark_cache_stale``,
``_install_refreshed``).

Not ported yet (queued in ROADMAP.md): telemetry records, the contract
audit, the separate-forward site readout (``fused_site_readout=False``),
the automatic partition count, partitions placed on several cards, and
block plans.

Per-system conditioning (eSCN's charge, spin and dataset) is read from
``atoms.info`` (the ASE convention), range-checked against the model's
config, carried by the graph, and part of the skin cache's key: a change of
charge rebuilds.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..neighbors import neighbor_list
from ..neighbors.device import (as_device_arrays, build_cell_list_spec,
                                grow_caps_after_overflow)
from ..parallel import make_potential_fn
from ..partition import (CapacityPolicy, build_partitioned_graph, build_plan,
                         device_refresh_graph)
from ..utils.checkpoint import params_from_numpy
from .atoms import EV_A3_TO_GPA, Atoms, map_species, max_displacement


def _same_structure(numbers0, cell0, pbc0, system0, atoms: Atoms) -> bool:
    """Whether ``atoms`` has these species, cell, pbc and conditioning
    scalars."""
    return (len(numbers0) == len(atoms)
            and np.array_equal(numbers0, atoms.numbers)
            and np.array_equal(cell0, atoms.cell)
            and np.array_equal(pbc0, atoms.pbc)
            and system0 == atoms_system(atoms))


def atoms_system(atoms: Atoms) -> dict:
    """Per-system conditioning scalars (charge/spin/dataset), read from
    ``atoms.info`` (``distmlip_tpu/calculators/calculator.py:336``)."""
    info = getattr(atoms, "info", {}) or {}
    return {k: int(info.get(k, 0)) for k in ("charge", "spin", "dataset")}


def validate_system(cfg, system: dict) -> None:
    """Range-check the conditioning scalars against the model config
    (``distmlip_tpu/calculators/calculator.py:346-365``): the device-side
    embedding lookups clip, which would silently alias an out-of-range
    charge, spin or dataset onto the table's edge."""
    if hasattr(cfg, "num_charges"):
        lo = cfg.charge_min
        hi = cfg.charge_min + cfg.num_charges - 1
        if not lo <= system["charge"] <= hi:
            raise ValueError(f"charge {system['charge']} outside [{lo}, {hi}]")
    if hasattr(cfg, "num_spins") and not 0 <= system["spin"] < cfg.num_spins:
        raise ValueError(f"spin {system['spin']} outside [0, {cfg.num_spins})")
    if hasattr(cfg, "num_datasets") and not 0 <= system["dataset"] < cfg.num_datasets:
        raise ValueError(f"dataset {system['dataset']} outside [0, {cfg.num_datasets})")


def with_compute_dtype(model, compute_dtype=None):
    """``model``, or a copy of it rebuilt at ``compute_dtype``
    (``distmlip_tpu/calculators/calculator.py:139-162``).

    ``None`` takes the process-global switch (``set_compute_dtype``), but
    only for models that honour ``cfg.dtype`` (``supports_compute_dtype``);
    others ignore it and stay float32, as in the JAX package. An explicit
    dtype a model does not honour raises ``ValueError``; a different dtype
    rebuilds the model with ``dataclasses.replace(cfg, dtype=...)``, whose
    constructor raises on a dtype it does not take."""
    supported = getattr(model, "supports_compute_dtype", False)
    if compute_dtype is None:
        from .. import _compute_dtype as global_dtype

        if global_dtype != "float32" and supported:
            compute_dtype = global_dtype
    if compute_dtype is None or compute_dtype == getattr(model.cfg, "dtype", None):
        return model
    if not supported:
        raise ValueError(
            f"{type(model).__name__} does not implement a compute-dtype switch (its "
            f"energy_fn ignores cfg.dtype); compute_dtype={compute_dtype!r} would "
            "silently run float32")
    return type(model)(dataclasses.replace(model.cfg, dtype=compute_dtype))


class DistPotential:
    """Potential over a model + parameter tree, on one device.

    Parameters
    ----------
    model : object with ``energy_fn(params, lg, positions)`` and a ``cfg``
        carrying ``cutoff`` (and optionally ``bond_cutoff`` and
        ``use_bond_graph``).
    params : parameter tree — numpy arrays (e.g. the JAX package's params
        through ``jax.tree.map(np.asarray, params)``) or torch tensors;
        moved to ``device``.
    num_partitions : slabs the structure is split into (None means 1).
        All run on ``device``, as one flattened graph.
    species_map : optional (max_Z+1,) int array mapping atomic numbers to
        the model's species indices. Default: identity.
    skin : Verlet skin (Å) of the graph cache; 0 rebuilds every call.
    compute_magmom : also return ``"magmoms"`` (N,), from the same forward
        (needs ``model.energy_and_aux_fn``; CHGNet).
    compute_dtype : "float32" or "bfloat16" rebuilds the model at that
        compute dtype (MACE, eSCN, TensorNet and CHGNet take bfloat16:
        features, messages and GEMMs in bf16, geometry, energies, forces,
        stress and magmoms in float32);
        None follows the global ``set_compute_dtype`` for models that honour
        it (``with_compute_dtype``).
    fused_site_readout : only True is ported: the magmoms ride the energy
        forward.
    kernels : True runs the CUDA kernels on a CUDA device; False runs their
        plain PyTorch versions on whatever device is given (the reference
        side of an on-card comparison — never taken silently).
    device : "cuda" (the default, also for None) or "cpu". Requesting CUDA
        without a card raises.
    device_rebuild : "auto" (the default) or True rebuilds the neighbor
        graph on the device when the skin cache invalidates, for potentials
        with ``skin > 0``, one partition and no bond graph (the cell list of
        ``neighbors.device`` and an in-place edge swap: no host search, no
        upload). A capacity overflow takes the host rebuild with grown caps
        (counted in ``rebuild_overflow_count``). False always rebuilds on
        the host, and so does "auto" at P > 1, by the JAX package's rule
        (``_device_refresh_eligible``); True at P > 1 raises.
    async_rebuild : with ``skin > 0``, build the next graph on a worker
        thread once ``prefetch_frac`` of the skin budget (skin/2 of
        displacement) is spent, whenever the device refresh cannot serve
        the invalidation; the invalidating step adopts it if the structure
        (species, cell, pbc, conditioning scalars) is unchanged and the
        atoms are still within the skin budget of the build's snapshot,
        else abandons it (not joined) and rebuilds itself. On a card the
        worker uploads from pinned buffers on its own stream and records an
        event; adoption makes the current stream wait on it. Adopted builds
        count in ``prefetch_hits`` (and in ``rebuild_count``); the time the
        step waited for an unfinished build is
        ``last_timings["prefetch_wait_s"]``. ``close()`` releases the worker.
    prefetch_frac : fraction of the skin budget spent before the prefetch
        starts (default 0.5).
    prefetch_hbm_frac : the device-memory guard of the prefetch, which
        holds two graphs on the card at once: it is skipped (counted in
        ``prefetch_skipped_hbm``) when the card's used memory plus the
        cached graph's tensor bytes would pass ``min(2 x prefetch_hbm_frac,
        0.9)`` of its memory (``torch.cuda.mem_get_info``). Never on the CPU.
    """

    def __init__(
        self,
        model,
        params,
        num_partitions: int | None = 1,
        species_map: np.ndarray | None = None,
        compute_stress: bool = True,
        caps: CapacityPolicy | None = None,
        skin: float = 0.0,
        compute_dtype: str | None = None,
        compute_magmom: bool = False,
        fused_site_readout: bool = True,
        kernels: bool = True,
        device=None,
        device_rebuild: bool | str = "auto",
        async_rebuild: bool = True,
        prefetch_frac: float = 0.5,
        prefetch_hbm_frac: float = 1.0 / 3.0,
    ):
        num_partitions = 1 if num_partitions is None else num_partitions
        if (isinstance(num_partitions, bool)
                or not isinstance(num_partitions, (int, np.integer)) or num_partitions < 1):
            raise ValueError(f"num_partitions must be an int >= 1, got {num_partitions!r}")
        num_partitions = int(num_partitions)
        model = with_compute_dtype(model, compute_dtype)
        if not isinstance(kernels, bool):
            raise TypeError(f"kernels must be True or False, got {kernels!r}")
        if not (isinstance(device_rebuild, bool) or device_rebuild == "auto"):
            raise TypeError(
                f"device_rebuild must be 'auto', True or False, got {device_rebuild!r}")
        if device_rebuild is True and num_partitions > 1:
            raise ValueError(
                f"device_rebuild=True needs one partition (got num_partitions="
                f"{num_partitions}): a P>1 graph is rebuilt on the host, where its "
                "slabs and halos are planned")
        if not fused_site_readout:
            raise NotImplementedError(
                "fused_site_readout=False (a separate forward for the site "
                "readout) is not ported; the magmoms ride the energy forward")
        if compute_magmom and not hasattr(model, "energy_and_aux_fn"):
            raise ValueError(
                f"{type(model).__name__} has no energy_and_aux_fn (sitewise "
                f"readout); compute_magmom is a CHGNet-family capability")
        self.device = resolve_device(device)
        self.model = model
        self.compute_dtype = getattr(model.cfg, "dtype", "float32")
        self.params = params_from_numpy(params, self.device)
        self.num_partitions = num_partitions
        self.species_map = species_map
        self.caps = caps or CapacityPolicy()
        self.cutoff = float(model.cfg.cutoff)
        self.bond_cutoff = float(getattr(model.cfg, "bond_cutoff", 0.0))
        self.use_bond_graph = bool(getattr(model.cfg, "use_bond_graph", False))
        self.compute_stress = bool(compute_stress)
        self.compute_magmom = bool(compute_magmom)
        self.skin = float(skin)
        self.kernels = kernels
        self._potential = make_potential_fn(
            model.energy_and_aux_fn if self.compute_magmom else model.energy_fn,
            compute_stress=self.compute_stress, kernels=kernels, aux=self.compute_magmom)
        # (graph on device, host, build positions, numbers, cell, pbc, system)
        self._cache = None
        # graph shape of the LAST calculate() (n_atoms, num_partitions,
        # n_cap, e_cap, e_split, n_edges; at P > 1 the slab axis, shifts,
        # owned and halo rows per partition and the halo copies; with a
        # bond graph b_cap, n_bonds, l_cap, n_lines), as the JAX package's
        # last_stats
        self.last_stats: dict = {}
        # graphs used by calculate(): host builds plus on-device refreshes
        self.rebuild_count = 0
        # on-device neighbor rebuild (neighbors/device.py): when the skin
        # cache invalidates on a potential without a bond graph, the edge
        # arrays are rebuilt on the device and swapped in place
        # ("auto" takes it at one partition only: a P > 1 graph's slabs and
        # halos are planned on the host)
        self.device_rebuild = device_rebuild is True or (
            device_rebuild == "auto" and num_partitions == 1)
        self.rebuild_on_device_count = 0
        self.rebuild_overflow_count = 0
        self._nbr_spec = None       # (CellListStatic, arrays on the device) or None
        self._cell_cap_floor = 4    # grown after device-cell overflows
        # whether the last calculate() used a graph built at its positions
        self.last_build_fresh = False
        # seconds of the last calculate()'s phases: neighbor_s (host build,
        # or the cache check), partition_s (cache install or positions
        # upload), rebuild_s (the device refresh), prefetch_wait_s (the
        # wait for an adopted background build), device_s (the potential)
        self.last_timings: dict = {}
        # background prefetch rebuild (skin > 0 only): one worker builds
        # the next graph while the device steps on the current one
        self.async_rebuild = bool(async_rebuild) and self.skin > 0.0
        self.prefetch_frac = float(prefetch_frac)
        self.prefetch_hbm_frac = float(prefetch_hbm_frac)
        self._executor = None
        self._upload_stream = None  # the worker's CUDA stream
        self._prefetch = None       # (future, snapshot atoms) in flight
        self.prefetch_hits = 0      # invalidations served by a background build
        self.prefetch_skipped_hbm = 0  # prefetches vetoed by the memory guard

    def _species(self, numbers: np.ndarray) -> np.ndarray:
        return map_species(numbers, self.species_map)

    def _device_refresh_eligible(self) -> bool:
        """Whether the on-device neighbor rebuild can serve skin-cache
        invalidations: skin reuse on, one partition (no halo to
        re-partition), no bond graph (the line-graph arrays cannot be
        refreshed in place), and ``device_rebuild`` set
        (``distmlip_tpu/calculators/calculator.py:388-398``)."""
        return (self.device_rebuild and self.skin > 0.0 and self.num_partitions == 1
                and not self.use_bond_graph)

    def _build_graph(self, atoms: Atoms, background: bool = False):
        """Host build and upload. ``background`` (the prefetch worker):
        the result is ``(graph, host, event)``, and on a card the upload is
        asynchronous on the worker's stream, ``event`` recorded after it
        (None off CUDA); otherwise ``(graph, host)``."""
        r_build = self.cutoff + self.skin
        b_build = (self.bond_cutoff + self.skin) if self.use_bond_graph else 0.0
        nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r_build, bond_r=b_build)
        plan = build_plan(nl, atoms.cell, atoms.pbc, self.num_partitions, r_build, b_build,
                          self.use_bond_graph)
        graph, host = build_partitioned_graph(
            plan, nl, self._species(atoms.numbers), atoms.cell, caps=self.caps,
            system=atoms_system(atoms))
        host.stats = {"n_atoms": len(atoms), "num_partitions": graph.num_partitions,
                      "n_cap": graph.n_cap, "e_cap": graph.e_cap, "e_split": graph.e_split,
                      "n_edges": int(graph.edge_mask.sum())}
        if graph.num_partitions > 1:
            owned = plan.owned_counts
            host.stats.update(
                axis=plan.axis, shifts=list(graph.shifts),
                owned_per_part=[int(x) for x in owned],
                halo_per_part=[int(m[-1]) - int(o) for m, o in zip(plan.node_markers, owned)],
                edges_per_part=[int(x) for x in graph.edge_mask.sum(axis=1)],
                frontier_per_part=[int(x) for x in graph.edge_mask[:, graph.e_split:].sum(axis=1)],
                halo_copies=len(graph.flat["halo_recv"]),
                bond_halo_copies=len(graph.flat["bond_halo_recv"]))
        if graph.has_bond_graph:
            host.stats.update(b_cap=graph.b_cap, n_bonds=int(graph.bond_map_mask.sum()),
                              l_cap=graph.line_mask.shape[1],
                              n_lines=int(graph.line_mask.sum()))
        if self._device_refresh_eligible():
            # the spec for refreshing THIS graph's capacity bucket on the
            # device; its arrays go to the device once, here
            static, arrays = build_cell_list_spec(
                atoms.cell, atoms.pbc, r_build, len(atoms), graph.n_cap,
                graph.e_cap, positions=atoms.positions,
                min_cell_cap=self._cell_cap_floor, dtype=graph.lattice.dtype)
            self._nbr_spec = (static, as_device_arrays(arrays, self.device))
        if not background:
            return graph.to(self.device), host
        if self.device.type != "cuda":
            return graph.to(self.device), host, None
        with torch.cuda.stream(self._upload_stream):
            graph = graph.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._upload_stream)
        return graph, host, event

    def _structure_matches(self, atoms: Atoms) -> bool:
        """The cached graph's structure (species, cell, pbc, conditioning
        scalars) is ``atoms``'."""
        return _same_structure(*self._cache[3:], atoms)

    def _disp_frac(self, build_positions, positions) -> float:
        """The largest displacement from the build positions as a fraction
        of the skin/2 budget (>= 1: the build no longer holds)."""
        return max_displacement(positions, build_positions) / (0.5 * self.skin)

    def _cache_valid(self, atoms: Atoms) -> bool:
        """The cached graph holds while the structure (and its conditioning
        scalars) is the same and no atom has moved skin/2 from its build
        position (Verlet criterion)."""
        if self.skin <= 0.0 or self._cache is None:
            return False
        return (self._structure_matches(atoms)
                and self._disp_frac(self._cache[2], atoms.positions) < 1.0)

    def _install_cache(self, graph, host, atoms: Atoms) -> None:
        self._cache = (graph, host, atoms.positions.copy(), atoms.numbers.copy(),
                       atoms.cell.copy(), atoms.pbc.copy(), atoms_system(atoms))

    # ---- background prefetch rebuild ----

    def _get_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            if self.device.type == "cuda":
                self._upload_stream = torch.cuda.Stream(device=self.device)
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="distmlip-rebuild")
            # the worker goes with the potential: no idle thread per
            # abandoned potential, none holding up the interpreter's exit
            weakref.finalize(self, self._executor.shutdown, wait=False,
                             cancel_futures=True)
        return self._executor

    def close(self) -> None:
        """Release the background-rebuild worker (also done when the
        potential is collected); a later prefetch starts a new one."""
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
            self._prefetch = None

    def _hbm_usage_frac(self) -> float | None:
        """Used share of the card's memory (all processes), None off CUDA."""
        if self.device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        return (total - free) / total

    def _estimate_prefetch_frac(self) -> float | None:
        """The share of the card's memory a prefetched graph adds: the
        cached graph's tensor bytes (the next build has its capacities
        until a cap grows). None off CUDA or without a cached graph."""
        if self.device.type != "cuda" or self._cache is None:
            return None
        nbytes = sum(t.numel() * t.element_size() for t in self._cache[0].tensors())
        return nbytes / torch.cuda.mem_get_info(self.device)[1]

    def _maybe_prefetch(self, atoms: Atoms) -> None:
        """Start a background build of ``atoms``' graph once
        ``prefetch_frac`` of the skin budget is spent
        (``distmlip_tpu/calculators/calculator.py:483-528``): never while
        the device refresh serves invalidations, never twice at once, and
        not when the memory guard vetoes it."""
        if (not self.async_rebuild or self._prefetch is not None
                or self._device_refresh_eligible()):
            return
        if self._disp_frac(self._cache[2], atoms.positions) < self.prefetch_frac:
            return
        used = self._hbm_usage_frac()
        if used is not None and used + self._estimate_prefetch_frac() > min(
                2.0 * self.prefetch_hbm_frac, 0.9):
            self.prefetch_skipped_hbm += 1
            return
        snapshot = atoms.copy()
        future = self._get_executor().submit(self._build_graph, snapshot, True)
        self._prefetch = (future, snapshot)

    def _adopt_prefetch(self, atoms: Atoms):
        """The background build, if it serves ``atoms``: the same structure
        and conditioning scalars as its snapshot, and every atom within the
        snapshot's skin budget. Returns ``(graph, host, snapshot)`` or None.
        A build that cannot serve is abandoned, not joined: its result is
        dropped with the Future when it ends (a synchronous build may run
        meanwhile; the capacity policy is locked). A failed build is
        dropped with a warning and the step rebuilds."""
        if self._prefetch is None:
            return None
        future, snap = self._prefetch
        self._prefetch = None
        if not (_same_structure(snap.numbers, snap.cell, snap.pbc, atoms_system(snap), atoms)
                and self._disp_frac(snap.positions, atoms.positions) < 1.0):
            future.cancel()  # frees it if it has not started
            return None
        try:
            graph, host, event = future.result()
        except Exception as e:  # noqa: BLE001 - speculative work; the step rebuilds
            import warnings

            warnings.warn(f"background graph rebuild failed ({e!r}); rebuilding "
                          "synchronously", stacklevel=4)
            return None
        if event is not None:
            # order the adopting stream after the worker's upload, on the
            # card; the tensors were allocated on the worker's stream, so
            # the allocator must not hand their blocks out again before
            # this stream is done with them
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in graph.tensors():
                t.record_stream(stream)
        self.prefetch_hits += 1
        self.rebuild_count += 1
        return graph, host, snap

    def _positions(self, host, graph, atoms: Atoms) -> torch.Tensor:
        """``atoms.positions`` as the graph's (P, N_cap, 3) tensor on the device."""
        dtype = np.float32 if graph.positions.dtype == torch.float32 else np.float64
        return torch.as_tensor(
            host.scatter_global(atoms.positions.astype(dtype), graph.n_cap)).to(self.device)

    def _mark_cache_stale(self) -> None:
        """Spend the skin cache's Verlet budget but KEEP the cached graph, so
        the next ``_prepare`` refreshes it on the device (structure
        unchanged): its build positions become ``inf``. Where the device
        refresh cannot serve (``_device_refresh_eligible`` false, or no
        cell-list spec) the cache is dropped and the next call rebuilds on
        the host (``distmlip_tpu/calculators/calculator.py:599-611``)."""
        if self._cache is None:
            return
        if not (self._device_refresh_eligible() and self._nbr_spec is not None):
            self._cache = None
            return
        graph, host, pos0, *rest = self._cache
        self._cache = (graph, host, np.full_like(pos0, np.inf), *rest)

    def _install_refreshed(self, graph, build_positions) -> None:
        """Swap a device-refreshed graph (same structure, same shapes) into
        the skin cache with the positions it was rebuilt at (the
        potential's own refresh and ``DeviceMD``'s in-loop one)."""
        _g, host, _pos0, numbers, cell, pbc, system = self._cache
        self._cache = (graph, host, np.array(build_positions, dtype=np.float64),
                       numbers, cell, pbc, system)

    def _try_device_refresh(self, atoms: Atoms):
        """Rebuild the cached graph's edges on the device at the current
        positions (skin-cache invalidation, structure unchanged). Returns
        ``(graph, host, positions)`` for the potential, or None when
        ineligible, when the structure changed, or when a capacity
        overflowed; the caller then takes the host rebuild, with the caps
        grown here after an overflow."""
        if (self._cache is None or self._nbr_spec is None
                or not self._device_refresh_eligible()
                or not self._structure_matches(atoms)):
            return None
        graph, host = self._cache[:2]
        t0 = time.perf_counter()
        positions = self._positions(host, graph, atoms)
        t1 = time.perf_counter()
        static, arrays = self._nbr_spec
        graph2, n_edges, overflow = device_refresh_graph(static, arrays, graph, positions)
        # the refresh's one device-to-host copy: the count and the flag
        n_edges, overflow = torch.stack([n_edges, overflow.to(n_edges.dtype)]).tolist()
        t2 = time.perf_counter()
        if overflow:
            self.rebuild_overflow_count += 1
            # grow the sticky edge cap (the count is exact past e_cap) or
            # double the cell capacity, so the host rebuild's buckets fit
            self._cell_cap_floor = grow_caps_after_overflow(
                self.caps, n_edges, graph.e_cap, static.cell_cap, self._cell_cap_floor)
            self._nbr_spec = None  # made again, with the grown caps, by the host build
            return None
        self.rebuild_count += 1
        self.rebuild_on_device_count += 1
        self.last_build_fresh = True
        host.stats["n_edges"] = n_edges
        self._install_refreshed(graph2, atoms.positions)
        self.last_timings = {"neighbor_s": 0.0, "partition_s": t1 - t0,
                             "rebuild_s": t2 - t1, "prefetch_wait_s": 0.0}
        return graph2, host, positions

    def _prepare(self, atoms: Atoms):
        """Build, refresh, adopt or reuse the graph; returns (graph, host,
        positions) ready for the potential. ``last_build_fresh``: whether
        the graph was built at these positions (not for a cache hit or an
        adopted prefetch, whose skin budget is partly spent)."""
        t0 = time.perf_counter()
        prefetch_wait = 0.0
        if not self._cache_valid(atoms):
            # same structure, positions past the skin budget: rebuild the
            # edges on the device instead of on the host
            refreshed = self._try_device_refresh(atoms)
            if refreshed is not None:
                return refreshed
            t_adopt = time.perf_counter()
            adopted = self._adopt_prefetch(atoms)
            prefetch_wait = time.perf_counter() - t_adopt
            if adopted is None:
                graph, host = self._build_graph(atoms)
                self.rebuild_count += 1
                self.last_build_fresh = True
                t1 = time.perf_counter()
                if self.skin > 0.0:
                    self._install_cache(graph, host, atoms)
                self.last_timings = {"neighbor_s": t1 - t0 - prefetch_wait,
                                     "partition_s": time.perf_counter() - t1,
                                     "prefetch_wait_s": prefetch_wait}
                return graph, host, graph.positions
            # the rebuild was done by the worker: this step uploads the
            # positions, as a cache hit does
            graph, host, snap = adopted
            self._install_cache(graph, host, snap)
        self.last_build_fresh = False
        self._maybe_prefetch(atoms)
        graph, host = self._cache[:2]
        t1 = time.perf_counter()
        positions = self._positions(host, graph, atoms)
        self.last_timings = {"neighbor_s": t1 - t0 - prefetch_wait,
                             "partition_s": time.perf_counter() - t1,
                             "prefetch_wait_s": prefetch_wait}
        return graph, host, positions

    def partition_report(self, atoms: Atoms) -> str:
        """Partition balance of ``atoms`` at the model's cutoff: owned,
        halo and edge counts per partition (bonds and lines with a bond
        graph), from a fresh search and plan
        (``distmlip_tpu/calculators/calculator.py:976-984``)."""
        nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, self.cutoff,
                           bond_r=self.bond_cutoff if self.use_bond_graph else 0.0)
        return build_plan(nl, atoms.cell, atoms.pbc, self.num_partitions, self.cutoff,
                          self.bond_cutoff, self.use_bond_graph).summary()

    def calculate(self, atoms: Atoms) -> dict:
        """Energy (eV), forces (eV/Å), stress (eV/Å^3, ASE sign convention),
        and magmoms (N,) with ``compute_magmom``."""
        validate_system(self.model.cfg, atoms_system(atoms))
        graph, host, positions = self._prepare(atoms)
        t0 = time.perf_counter()
        out = self._potential(self.params, graph, positions)
        energy = float(out["energy"])
        forces = host.gather_owned(out["forces"].detach().cpu().numpy(), len(atoms))
        stress = out["stress"].detach().cpu().numpy()
        self.last_stats = dict(host.stats)
        result = {
            "energy": energy,
            "free_energy": energy,
            "forces": forces,
            "stress": stress,
            "stress_GPa": stress * EV_A3_TO_GPA,
        }
        if "aux" in out:
            m = out["aux"]["magmoms"].cpu().numpy()
            result["magmoms"] = host.gather_owned(m, len(atoms))
        self.last_timings["device_s"] = time.perf_counter() - t0
        return result


# UMA/fairchem task routing: task name -> the dataset-conditioning index
# fed to the csd embedding (``distmlip_tpu/calculators/calculator.py:1024``)
UMA_TASK_DATASETS = {"omol": 0, "omat": 1, "oc20": 2, "odac": 3}


class UMAPredictor:
    """A task-routed entry for the eSCN/UMA family
    (``distmlip_tpu/calculators/calculator.py:1027-1051``): the task name
    selects the dataset-conditioning index, set in ``atoms.info`` where the
    caller left it out; charge and spin are read from ``atoms.info`` as
    ever. All three feed the model's csd embedding and MOLE gate. Every
    other keyword argument (``device=``, ``num_partitions=``, ``skin=``,
    ``kernels=``, ...) goes to ``DistPotential``."""

    def __init__(self, model, params, task_name: str = "omat", **kwargs):
        if task_name not in UMA_TASK_DATASETS:
            raise ValueError(
                f"unknown task {task_name!r}; have {sorted(UMA_TASK_DATASETS)}")
        self.task_name = task_name
        self.dataset_id = UMA_TASK_DATASETS[task_name]
        self.potential = DistPotential(model, params, **kwargs)

    def calculate(self, atoms: Atoms) -> dict:
        atoms = atoms.copy()
        atoms.info.setdefault("dataset", self.dataset_id)
        return self.potential.calculate(atoms)


def _check_same_tree(a, b, path: str = "params") -> None:
    """Raise unless two parameter trees have the same keys, list lengths,
    tensor shapes and dtypes."""
    if isinstance(a, dict) != isinstance(b, dict) or isinstance(a, list) != isinstance(b, list):
        raise ValueError(f"ensemble member trees differ at {path}: {type(a).__name__} "
                         f"against {type(b).__name__}")
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"ensemble member trees differ at {path}: keys "
                             f"{sorted(set(a) ^ set(b))} are not in both")
        for k in a:
            _check_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        if len(a) != len(b):
            raise ValueError(f"ensemble member trees differ at {path}: lengths {len(a)} "
                             f"and {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _check_same_tree(x, y, f"{path}/{i}")
    elif (a is None) != (b is None) or (a is not None and (
            a.shape != b.shape or a.dtype != b.dtype)):
        raise ValueError(f"ensemble member trees differ at {path}: "
                         f"{None if a is None else (tuple(a.shape), a.dtype)} against "
                         f"{None if b is None else (tuple(b.shape), b.dtype)}")


class EnsemblePotential:
    """Uncertainty over an ensemble of parameter sets of one model
    (``distmlip_tpu/calculators/calculator.py:1053-1189``): the mean,
    variance and per-member stack of energies, forces and stresses (and
    CHGNet's magmoms with ``compute_magmom=True``).

    ``stacked=True`` (the default) prepares and uploads ONE graph and the
    positions (the first member's ``DistPotential``, built from
    ``kwargs``), then runs each member's parameters through that
    potential's force program in turn on the device, with no host sync
    between members, and brings the members' results back in one stack
    and one device-to-host copy. The JAX package vmaps the members into one
    program; the port does not use ``torch.func.vmap``: the kernels'
    ``autograd.Function``s have no vmap rule, and ``torch.autograd.grad``
    does not run under vmap. The member trees must have the same keys and
    shapes. ``stacked=False`` runs one ``DistPotential`` per member.

    Every member shares one ``CapacityPolicy`` (``kwargs["caps"]``, made
    here when not given). ``last_stats`` is the graph's stats plus
    ``member_count``; ``last_timings`` the first member's.
    """

    def __init__(self, model, params_list, stacked: bool | None = None, **kwargs):
        if not params_list:
            raise ValueError("params_list must be non-empty")
        kwargs.setdefault("caps", CapacityPolicy())
        base = DistPotential(model, params_list[0], **kwargs)
        self.stacked = True if stacked is None else bool(stacked)
        self.member_count = len(params_list)
        self.last_stats: dict = {}
        self.last_timings: dict = {}
        self.compute_stress = base.compute_stress
        if self.stacked:
            self.members = [base]
            self.params_list = [base.params] + [params_from_numpy(p, base.device)
                                                for p in params_list[1:]]
            for i, p in enumerate(self.params_list[1:], 1):
                _check_same_tree(base.params, p, f"params_list[{i}]")
        else:
            self.members = [base] + [DistPotential(model, p, **kwargs)
                                     for p in params_list[1:]]

    def _stacked_results(self, atoms: Atoms):
        """Per-member energies (M,), forces (M, N, 3), stresses (M, 3, 3)
        and magmoms (M, N) or None, from one graph."""
        base = self.members[0]
        validate_system(base.model.cfg, atoms_system(atoms))
        graph, host, positions = base._prepare(atoms)
        t0 = time.perf_counter()
        outs = [base._potential(p, graph, positions) for p in self.params_list]
        parts = [("energy", outs[0]["energy"]), ("forces", outs[0]["forces"]),
                 ("stress", outs[0]["stress"])]
        if "aux" in outs[0]:
            parts.append(("magmoms", outs[0]["aux"]["magmoms"]))

        def row(out):
            return torch.cat([(out["aux"]["magmoms"] if k == "magmoms" else out[k])
                              .reshape(-1).to(torch.float64) for k, _ in parts])

        # one stack, one device-to-host copy (float64 holds every member
        # value exactly; each part goes back to its own dtype)
        block = torch.stack([row(o) for o in outs]).cpu().numpy()
        base.last_timings["device_s"] = time.perf_counter() - t0
        got, start = {}, 0
        for k, t in parts:
            size = t.numel()
            got[k] = block[:, start:start + size].reshape((-1,) + tuple(t.shape)).astype(
                np.float32 if t.dtype == torch.float32 else np.float64)
            start += size
        n = len(atoms)
        energies = np.array([float(e) for e in got["energy"]])
        forces = np.stack([host.gather_owned(f, n) for f in got["forces"]])
        magmoms = (np.stack([host.gather_owned(m, n) for m in got["magmoms"]])
                   if "magmoms" in got else None)
        return energies, forces, got["stress"], magmoms, dict(host.stats)

    def calculate(self, atoms: Atoms) -> dict:
        base = self.members[0]
        if self.stacked:
            energies, forces, stresses, magmoms, stats = self._stacked_results(atoms)
        else:
            results = [m.calculate(atoms) for m in self.members]
            energies = np.array([r["energy"] for r in results])
            forces = np.stack([r["forces"] for r in results])
            stresses = np.stack([r["stress"] for r in results])
            magmoms = (np.stack([r["magmoms"] for r in results])
                       if "magmoms" in results[0] else None)
            stats = dict(base.last_stats)
        result = {
            "energy": float(energies.mean()),
            "free_energy": float(energies.mean()),
            "forces": forces.mean(axis=0),
            "stress": stresses.mean(axis=0),
            "energy_var": float(energies.var()),
            "forces_var": forces.var(axis=0),
            "energies": energies,
            "forces_all": forces,
        }
        if magmoms is not None:
            result["magmoms"] = magmoms.mean(axis=0)
            result["magmoms_all"] = magmoms
        stats["member_count"] = self.member_count
        self.last_stats = stats
        self.last_timings = dict(base.last_timings)
        return result
