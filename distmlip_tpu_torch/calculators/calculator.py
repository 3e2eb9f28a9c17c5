"""User-facing potential: the Atoms -> (E, F, sigma) pipeline on one card.

``DistPotential`` ports ``distmlip_tpu/calculators/calculator.py:77`` at one
partition (P=1): the host builds the neighbor list and the capacity-padded
graph, uploads it once, and the model's energy and its autograd forces and
stress run on the device.

With ``skin > 0`` the neighbor graph is built at cutoff+skin, uploaded
once, and REUSED across steps — only positions are re-uploaded — until any
atom moves skin/2 from its build-time position (Verlet-list criterion:
results stay exact because the model envelopes zero the extra skin edges).

For a model with a bond graph (CHGNet: ``cfg.use_bond_graph``) the host
also builds the bond and line graphs at ``bond_cutoff + skin``. With
``compute_magmom=True`` the magmoms ride the energy forward as an aux
output (the fused site readout, ``model.energy_and_aux_fn``).

Not ported yet (queued in ROADMAP.md): the background prefetch rebuild,
the on-device graph refresh, telemetry records and timings, the contract
audit, the separate-forward site readout (``fused_site_readout=False``),
a compute dtype other than float32, and ``num_partitions > 1``.

Per-system conditioning (eSCN's charge, spin and dataset) is read from
``atoms.info`` (the ASE convention), range-checked against the model's
config, carried by the graph, and part of the skin cache's key: a change of
charge rebuilds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..neighbors import neighbor_list
from ..parallel import make_potential_fn
from ..partition import CapacityPolicy, build_partitioned_graph, build_plan
from ..utils.checkpoint import params_from_numpy
from .atoms import EV_A3_TO_GPA, Atoms, map_species, max_displacement


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
    num_partitions : only 1 is ported.
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
    ):
        if num_partitions not in (None, 1):
            raise NotImplementedError(
                f"num_partitions={num_partitions}: only P=1 is ported "
                "(ROADMAP.md queue A item 'P>1 graph parallelism')")
        if compute_dtype is None:
            from .. import _compute_dtype as compute_dtype  # the global switch
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only float32 is ported; "
                "bfloat16 is queued in ROADMAP.md")
        if not isinstance(kernels, bool):
            raise TypeError(f"kernels must be True or False, got {kernels!r}")
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
        self.num_partitions = 1
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
            model.energy_and_aux_fn if self.compute_magmom else model.energy_fn, None,
            compute_stress=self.compute_stress, kernels=kernels,
            aux=self.compute_magmom)
        # (graph on device, host, build positions, numbers, cell, pbc, system)
        self._cache = None
        # graph shape of the LAST calculate() (n_atoms, n_cap, e_cap,
        # n_edges; with a bond graph b_cap, n_bonds, l_cap, n_lines), as
        # the JAX package's last_stats
        self.last_stats: dict = {}
        # graphs built by calculate() (host neighbor search + upload)
        self.rebuild_count = 0

    def _species(self, numbers: np.ndarray) -> np.ndarray:
        return map_species(numbers, self.species_map)

    def _build_graph(self, atoms: Atoms):
        r_build = self.cutoff + self.skin
        b_build = (self.bond_cutoff + self.skin) if self.use_bond_graph else 0.0
        nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r_build, bond_r=b_build)
        plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r_build, b_build,
                          self.use_bond_graph)
        graph, host = build_partitioned_graph(
            plan, nl, self._species(atoms.numbers), atoms.cell, caps=self.caps,
            system=self._system(atoms))
        host.stats = {"n_atoms": len(atoms), "n_cap": graph.n_cap,
                      "e_cap": graph.e_cap,
                      "n_edges": int(graph.edge_mask.sum())}
        if graph.has_bond_graph:
            host.stats.update(b_cap=graph.b_cap, n_bonds=int(graph.bond_map_mask.sum()),
                              l_cap=graph.line_mask.shape[1],
                              n_lines=int(graph.line_mask.sum()))
        return graph.to(self.device), host

    @staticmethod
    def _system(atoms: Atoms) -> dict:
        """Per-system conditioning scalars (charge/spin/dataset), read from
        ``atoms.info`` (``distmlip_tpu/calculators/calculator.py:336``)."""
        info = getattr(atoms, "info", {}) or {}
        return {k: int(info.get(k, 0)) for k in ("charge", "spin", "dataset")}

    def _validate_system(self, system: dict) -> None:
        """Range-check the conditioning scalars against the model config
        (``calculator.py:346-365``): the device-side embedding lookups clip,
        which would silently alias an out-of-range charge, spin or dataset
        onto the table's edge."""
        cfg = self.model.cfg
        if hasattr(cfg, "num_charges"):
            lo = cfg.charge_min
            hi = cfg.charge_min + cfg.num_charges - 1
            if not lo <= system["charge"] <= hi:
                raise ValueError(f"charge {system['charge']} outside [{lo}, {hi}]")
        if hasattr(cfg, "num_spins") and not 0 <= system["spin"] < cfg.num_spins:
            raise ValueError(f"spin {system['spin']} outside [0, {cfg.num_spins})")
        if hasattr(cfg, "num_datasets") and not 0 <= system["dataset"] < cfg.num_datasets:
            raise ValueError(
                f"dataset {system['dataset']} outside [0, {cfg.num_datasets})")

    def _cache_valid(self, atoms: Atoms) -> bool:
        """The cached graph holds while the structure (and its conditioning
        scalars) is the same and no atom has moved skin/2 from its build
        position (Verlet criterion)."""
        if self.skin <= 0.0 or self._cache is None:
            return False
        _, _, pos0, numbers0, cell0, pbc0, system0 = self._cache
        return (len(numbers0) == len(atoms)
                and np.array_equal(numbers0, atoms.numbers)
                and np.array_equal(cell0, atoms.cell)
                and np.array_equal(pbc0, atoms.pbc)
                and system0 == self._system(atoms)
                and max_displacement(atoms.positions, pos0) < 0.5 * self.skin)

    def _prepare(self, atoms: Atoms):
        """Build or reuse the graph; returns (graph, host, positions) ready
        for the potential."""
        if not self._cache_valid(atoms):
            graph, host = self._build_graph(atoms)
            self.rebuild_count += 1
            if self.skin > 0.0:
                self._cache = (graph, host, atoms.positions.copy(),
                               atoms.numbers.copy(), atoms.cell.copy(),
                               atoms.pbc.copy(), self._system(atoms))
            return graph, host, graph.positions
        graph, host = self._cache[:2]
        dtype = graph.positions.dtype
        positions = host.scatter_global(
            atoms.positions.astype(np.float32 if dtype == torch.float32
                                   else np.float64), graph.n_cap)
        return graph, host, torch.as_tensor(positions).to(self.device)

    def calculate(self, atoms: Atoms) -> dict:
        """Energy (eV), forces (eV/Å), stress (eV/Å^3, ASE sign convention),
        and magmoms (N,) with ``compute_magmom``."""
        self._validate_system(self._system(atoms))
        graph, host, positions = self._prepare(atoms)
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
        return result
