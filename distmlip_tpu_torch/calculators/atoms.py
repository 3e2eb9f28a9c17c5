"""A minimal, self-contained Atoms container (ASE-compatible subset).

The reference drives everything through ASE ``Atoms`` + ``Calculator``
(reference implementations/matgl/ase.py); this framework ships its own
container so it runs standalone, plus adapters to/from ASE when ASE is
installed.

Units: Å, eV, amu; time in fs. Velocities in Å/fs.
"""

from __future__ import annotations

import numpy as np

from .elements import MASSES, symbols_to_numbers

# Boltzmann constant in eV/K
KB = 8.617333262e-5
# 1 amu * (Å/fs)^2 in eV
AMU_A2_FS2_TO_EV = 103.642696562
# eV/Å^3 -> GPa
EV_A3_TO_GPA = 160.21766208


def map_species(numbers: np.ndarray, species_map: np.ndarray | None) -> np.ndarray:
    """Atomic numbers -> model species indices (identity when no map) —
    the one species-mapping rule shared by DistPotential and
    BatchedPotential."""
    if species_map is None:
        return np.asarray(numbers, dtype=np.int32)
    return np.asarray(species_map)[numbers].astype(np.int32)


def max_displacement(positions: np.ndarray, build_positions: np.ndarray) -> float:
    """Largest per-atom displacement (Å) from the build-time positions —
    the Verlet skin criterion's primitive (a cached graph stays valid
    while this is < skin/2), shared by the single-structure and batched
    graph caches."""
    if len(positions) == 0:
        return 0.0
    disp = positions - build_positions
    return float(np.sqrt(np.max(np.sum(disp * disp, axis=1))))


class Atoms:
    def __init__(self, numbers=None, symbols=None, positions=None, cell=None,
                 pbc=(True, True, True), velocities=None, masses=None,
                 info=None):
        if numbers is None:
            if symbols is None:
                raise ValueError("numbers or symbols required")
            numbers = symbols_to_numbers(symbols)
        # free-form system metadata (ASE-compatible): UMA-style models read
        # "charge", "spin", "dataset" from here
        self.info = dict(info) if info else {}
        self.numbers = np.asarray(numbers, dtype=np.int32)
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3).copy()
        self.cell = np.asarray(cell, dtype=np.float64).reshape(3, 3).copy()
        self.pbc = np.asarray(pbc, dtype=bool)
        n = len(self.numbers)
        if self.positions.shape[0] != n:
            raise ValueError("positions/numbers length mismatch")
        self.masses = (
            np.asarray(masses, dtype=np.float64)
            if masses is not None
            else MASSES[self.numbers].copy()
        )
        self.velocities = (
            np.asarray(velocities, dtype=np.float64).reshape(-1, 3).copy()
            if velocities is not None
            else np.zeros((n, 3))
        )

    def __len__(self):
        return len(self.numbers)

    def copy(self) -> "Atoms":
        return Atoms(
            numbers=self.numbers.copy(), positions=self.positions.copy(),
            cell=self.cell.copy(), pbc=self.pbc.copy(),
            velocities=self.velocities.copy(), masses=self.masses.copy(),
            info=dict(self.info),
        )

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))

    def kinetic_energy(self) -> float:
        return float(
            0.5 * AMU_A2_FS2_TO_EV * np.sum(self.masses[:, None] * self.velocities**2)
        )

    def temperature(self) -> float:
        dof = max(3 * len(self) - 3, 1)
        return 2.0 * self.kinetic_energy() / (dof * KB)

    def set_maxwell_boltzmann_velocities(self, temperature_K: float, rng=None,
                                         zero_momentum: bool = True):
        rng = rng or np.random.default_rng()
        sigma = np.sqrt(KB * temperature_K / (self.masses * AMU_A2_FS2_TO_EV))
        self.velocities = rng.normal(size=(len(self), 3)) * sigma[:, None]
        if zero_momentum:
            p = (self.masses[:, None] * self.velocities).sum(axis=0)
            self.velocities -= p / self.masses.sum()

    # ---- ASE interop ----
    @classmethod
    def from_ase(cls, ase_atoms) -> "Atoms":
        a = cls(
            numbers=ase_atoms.get_atomic_numbers(),
            positions=ase_atoms.get_positions(),
            cell=np.asarray(ase_atoms.get_cell()),
            pbc=ase_atoms.get_pbc(),
            masses=ase_atoms.get_masses(),
            info=dict(getattr(ase_atoms, "info", {}) or {}),
        )
        try:
            # ASE time unit = Å sqrt(amu/eV) ≈ 10.1805 fs; convert to Å/fs
            a.velocities = ase_atoms.get_velocities() * 0.09822694750253231
        except Exception:
            pass
        return a

    def to_ase(self):
        import ase

        return ase.Atoms(
            numbers=self.numbers, positions=self.positions, cell=self.cell,
            pbc=self.pbc,
        )
