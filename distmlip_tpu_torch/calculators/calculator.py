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

Not ported yet (queued in ROADMAP.md): the background prefetch rebuild,
telemetry records, the contract audit, the separate-forward site readout
(``fused_site_readout=False``), a compute dtype other than float32, the
automatic partition count, partitions placed on several cards, and block
plans.

Per-system conditioning (eSCN's charge, spin and dataset) is read from
``atoms.info`` (the ASE convention), range-checked against the model's
config, carried by the graph, and part of the skin cache's key: a change of
charge rebuilds.
"""

from __future__ import annotations

import time

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
    ):
        num_partitions = 1 if num_partitions is None else num_partitions
        if (isinstance(num_partitions, bool)
                or not isinstance(num_partitions, (int, np.integer)) or num_partitions < 1):
            raise ValueError(f"num_partitions must be an int >= 1, got {num_partitions!r}")
        num_partitions = int(num_partitions)
        if compute_dtype is None:
            from .. import _compute_dtype as compute_dtype  # the global switch
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only float32 is ported; "
                "bfloat16 is queued in ROADMAP.md")
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
        # upload), rebuild_s (the device refresh), device_s (the potential)
        self.last_timings: dict = {}

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

    def _build_graph(self, atoms: Atoms):
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
        return graph.to(self.device), host

    def _structure_matches(self, atoms: Atoms) -> bool:
        """The cached graph's structure (species, cell, pbc, conditioning
        scalars) is ``atoms``'."""
        _, _, _, numbers0, cell0, pbc0, system0 = self._cache
        return (len(numbers0) == len(atoms)
                and np.array_equal(numbers0, atoms.numbers)
                and np.array_equal(cell0, atoms.cell)
                and np.array_equal(pbc0, atoms.pbc)
                and system0 == atoms_system(atoms))

    def _cache_valid(self, atoms: Atoms) -> bool:
        """The cached graph holds while the structure (and its conditioning
        scalars) is the same and no atom has moved skin/2 from its build
        position (Verlet criterion)."""
        if self.skin <= 0.0 or self._cache is None:
            return False
        return (self._structure_matches(atoms)
                and max_displacement(atoms.positions, self._cache[2]) < 0.5 * self.skin)

    def _positions(self, host, graph, atoms: Atoms) -> torch.Tensor:
        """``atoms.positions`` as the graph's (P, N_cap, 3) tensor on the device."""
        dtype = np.float32 if graph.positions.dtype == torch.float32 else np.float64
        return torch.as_tensor(
            host.scatter_global(atoms.positions.astype(dtype), graph.n_cap)).to(self.device)

    def _install_refreshed(self, graph, build_positions) -> None:
        """Swap a device-refreshed graph (same structure, same shapes) into
        the skin cache with the positions it was rebuilt at."""
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
                             "rebuild_s": t2 - t1}
        return graph2, host, positions

    def _prepare(self, atoms: Atoms):
        """Build, refresh or reuse the graph; returns (graph, host,
        positions) ready for the potential."""
        t0 = time.perf_counter()
        if not self._cache_valid(atoms):
            # same structure, positions past the skin budget: rebuild the
            # edges on the device instead of on the host
            refreshed = self._try_device_refresh(atoms)
            if refreshed is not None:
                return refreshed
            graph, host = self._build_graph(atoms)
            self.rebuild_count += 1
            self.last_build_fresh = True
            t1 = time.perf_counter()
            if self.skin > 0.0:
                self._cache = (graph, host, atoms.positions.copy(),
                               atoms.numbers.copy(), atoms.cell.copy(),
                               atoms.pbc.copy(), atoms_system(atoms))
            self.last_timings = {"neighbor_s": t1 - t0,
                                 "partition_s": time.perf_counter() - t1}
            return graph, host, graph.positions
        self.last_build_fresh = False
        graph, host = self._cache[:2]
        t1 = time.perf_counter()
        positions = self._positions(host, graph, atoms)
        self.last_timings = {"neighbor_s": t1 - t0,
                             "partition_s": time.perf_counter() - t1}
        return graph, host, positions

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
