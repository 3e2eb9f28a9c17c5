"""User-facing potential: the Atoms -> (E, F, sigma) pipeline on one card.

``DistPotential`` ports ``distmlip_tpu/calculators/calculator.py:77`` at one
partition (P=1): the host builds the neighbor list and the capacity-padded
graph, uploads it once, and the model's energy and its autograd forces and
stress run on the device.

With ``skin > 0`` the neighbor graph is built at cutoff+skin, uploaded
once, and REUSED across steps — only positions are re-uploaded — until any
atom moves skin/2 from its build-time position (Verlet-list criterion:
results stay exact because the model envelopes zero the extra skin edges).

Not ported yet (queued in ROADMAP.md): the background prefetch rebuild,
the on-device graph refresh, telemetry records and timings, the contract
audit, magmoms, per-system conditioning (charge/spin/dataset), a compute
dtype other than float32, and ``num_partitions > 1``.
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
        carrying ``cutoff``.
    params : parameter tree — numpy arrays (e.g. the JAX package's params
        through ``jax.tree.map(np.asarray, params)``) or torch tensors;
        moved to ``device``.
    num_partitions : only 1 is ported.
    species_map : optional (max_Z+1,) int array mapping atomic numbers to
        the model's species indices. Default: identity.
    skin : Verlet skin (Å) of the graph cache; 0 rebuilds every call.
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
        self.device = resolve_device(device)
        self.model = model
        self.params = params_from_numpy(params, self.device)
        self.num_partitions = 1
        self.species_map = species_map
        self.caps = caps or CapacityPolicy()
        self.cutoff = float(model.cfg.cutoff)
        self.compute_stress = bool(compute_stress)
        self.skin = float(skin)
        self.kernels = kernels
        self._potential = make_potential_fn(
            model.energy_fn, None, compute_stress=self.compute_stress,
            kernels=kernels)
        # (graph on device, host, build positions, numbers, cell, pbc)
        self._cache = None
        # graph shape of the LAST calculate() (n_atoms, n_cap, e_cap,
        # n_edges), as the JAX package's last_stats
        self.last_stats: dict = {}
        # graphs built by calculate() (host neighbor search + upload)
        self.rebuild_count = 0

    def _species(self, numbers: np.ndarray) -> np.ndarray:
        return map_species(numbers, self.species_map)

    def _build_graph(self, atoms: Atoms):
        r_build = self.cutoff + self.skin
        nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r_build)
        plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r_build)
        graph, host = build_partitioned_graph(
            plan, nl, self._species(atoms.numbers), atoms.cell, caps=self.caps)
        host.stats = {"n_atoms": len(atoms), "n_cap": graph.n_cap,
                      "e_cap": graph.e_cap,
                      "n_edges": int(graph.edge_mask.sum())}
        return graph.to(self.device), host

    def _cache_valid(self, atoms: Atoms) -> bool:
        """The cached graph holds while the structure is the same and no
        atom has moved skin/2 from its build position (Verlet criterion)."""
        if self.skin <= 0.0 or self._cache is None:
            return False
        _, _, pos0, numbers0, cell0, pbc0 = self._cache
        return (len(numbers0) == len(atoms)
                and np.array_equal(numbers0, atoms.numbers)
                and np.array_equal(cell0, atoms.cell)
                and np.array_equal(pbc0, atoms.pbc)
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
                               atoms.pbc.copy())
            return graph, host, graph.positions
        graph, host = self._cache[:2]
        dtype = graph.positions.dtype
        positions = host.scatter_global(
            atoms.positions.astype(np.float32 if dtype == torch.float32
                                   else np.float64), graph.n_cap)
        return graph, host, torch.as_tensor(positions).to(self.device)

    def calculate(self, atoms: Atoms) -> dict:
        """Energy (eV), forces (eV/Å), stress (eV/Å^3, ASE sign convention)."""
        graph, host, positions = self._prepare(atoms)
        out = self._potential(self.params, graph, positions)
        energy = float(out["energy"])
        forces = host.gather_owned(out["forces"].detach().cpu().numpy(), len(atoms))
        stress = out["stress"].detach().cpu().numpy()
        self.last_stats = dict(host.stats)
        return {
            "energy": energy,
            "free_energy": energy,
            "forces": forces,
            "stress": stress,
            "stress_GPa": stress * EV_A3_TO_GPA,
        }
