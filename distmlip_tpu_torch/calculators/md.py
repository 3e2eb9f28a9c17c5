"""Molecular dynamics driver with 9 ensembles.

The port's own copy of ``distmlip_tpu/calculators/md.py``: the same
numpy integrators in float64 on the host, step for step, over any
potential with ``calculate(atoms) -> dict(energy, forces, stress)``.
Ensembles: nve, nvt_berendsen, nvt_langevin, nvt_andersen, nvt_bussi,
nvt_nose_hoover, npt_berendsen, npt_inhomogeneous_berendsen,
npt_nose_hoover. Each step calls the potential once (velocity-Verlet
based).

Graph rebuilds under this driver follow the potential's skin cache: for a
fixed-cell ensemble on ``DistPotential(skin > 0)`` without a bond graph the
Verlet invalidation is served by the on-device neighbor rebuild
(``neighbors/device.py``): no host neighbor search on the hot path. NPT
ensembles rescale the cell, which changes the structure key and takes the
host rebuild (the cell-list grid is sized to the lattice).

Units: Å, fs, eV, amu, K; pressure in GPa at the API (converted internally).
"""

from __future__ import annotations

import numpy as np

from .atoms import AMU_A2_FS2_TO_EV, EV_A3_TO_GPA, KB, Atoms

ENSEMBLES = (
    "nve",
    "nvt_berendsen",
    "nvt_langevin",
    "nvt_andersen",
    "nvt_bussi",
    "nvt_nose_hoover",
    "npt_berendsen",
    "npt_inhomogeneous_berendsen",
    "npt_nose_hoover",
)


class TrajectoryObserver:
    """Records energies/forces/stresses/positions/cells during a run.

    Reference analogue: ase.py TrajectoryObserver (:202-215).
    """

    def __init__(self, atoms: Atoms):
        self.atoms = atoms
        self.energies: list[float] = []
        self.forces: list[np.ndarray] = []
        self.stresses: list[np.ndarray] = []
        self.positions: list[np.ndarray] = []
        self.cells: list[np.ndarray] = []
        self.temperatures: list[float] = []

    def record(self, results: dict):
        self.energies.append(results["energy"])
        self.forces.append(results["forces"].copy())
        self.stresses.append(results["stress"].copy())
        self.positions.append(self.atoms.positions.copy())
        self.cells.append(self.atoms.cell.copy())
        self.temperatures.append(self.atoms.temperature())

    def save(self, filename: str):
        np.savez_compressed(
            filename,
            energies=np.array(self.energies),
            forces=np.array(self.forces),
            stresses=np.array(self.stresses),
            positions=np.array(self.positions),
            cells=np.array(self.cells),
            temperatures=np.array(self.temperatures),
        )


class MolecularDynamics:
    def __init__(
        self,
        atoms: Atoms,
        potential,
        ensemble: str = "nvt_berendsen",
        timestep: float = 1.0,          # fs
        temperature: float = 300.0,     # K
        pressure: float = 0.0,          # GPa (NPT only)
        taut: float | None = None,      # thermostat time constant, fs
        taup: float | None = None,      # barostat time constant, fs
        friction: float = 0.01,         # Langevin, 1/fs
        andersen_prob: float = 0.01,
        compressibility: float = 4.57e-3,  # 1/GPa (water-like default)
        seed: int | None = None,
        trajectory: TrajectoryObserver | None = None,
        logfile: str | None = None,
        loginterval: int = 1,
        telemetry=None,
    ):
        if ensemble not in ENSEMBLES:
            raise ValueError(f"ensemble {ensemble!r} not in {ENSEMBLES}")
        if telemetry is not None:
            # the potential's own hub wins (attach_telemetry's rule): every
            # step's calculate emits its record into it
            getattr(potential, "attach_telemetry", lambda t: None)(telemetry)
        if ensemble.startswith("npt") and not getattr(potential, "compute_stress", True):
            raise ValueError(
                "NPT ensembles need stresses: build the potential with "
                "compute_stress=True"
            )
        self.atoms = atoms
        self.potential = potential
        self.ensemble = ensemble
        self.dt = float(timestep)
        self.t_target = float(temperature)
        self.p_target = float(pressure) / EV_A3_TO_GPA  # -> eV/Å^3
        self.taut = taut if taut is not None else 100.0 * self.dt
        self.taup = taup if taup is not None else 1000.0 * self.dt
        self.friction = friction
        self.andersen_prob = andersen_prob
        self.kappa = compressibility * EV_A3_TO_GPA     # -> 1/(eV/Å^3)
        self.rng = np.random.default_rng(seed)
        self.trajectory = trajectory
        self.logfile = logfile
        self.loginterval = loginterval
        self.nsteps = 0
        self.results = self.potential.calculate(atoms)
        # Nose-Hoover state
        dof = 3 * len(atoms) - 3
        self._nh_xi = 0.0
        self._nh_q = dof * KB * self.t_target * (self.taut**2)
        self._mtk_eps_p = 0.0
        self._mtk_w = (dof + 3) * KB * self.t_target * (self.taup**2)

    # ---- helpers ----
    def _accel(self):
        return self.results["forces"] / (
            self.atoms.masses[:, None] * AMU_A2_FS2_TO_EV
        )

    def _pressure(self) -> float:
        """Instantaneous pressure (eV/Å^3): virial + ideal-gas kinetic part."""
        virial = -np.trace(self.results["stress"]) / 3.0
        kin = 2.0 * self.atoms.kinetic_energy() / (3.0 * self.atoms.volume)
        return virial + kin

    def _stress_full(self) -> np.ndarray:
        """Internal stress (eV/Å^3, positive = compression) incl. kinetic."""
        pot = -self.results["stress"]
        v = self.atoms.velocities
        m = self.atoms.masses[:, None]
        kin = AMU_A2_FS2_TO_EV * (m * v).T @ v / self.atoms.volume
        return pot + kin

    def _velocity_verlet(self):
        a = self._accel()
        self.atoms.velocities += 0.5 * self.dt * a
        self.atoms.positions += self.dt * self.atoms.velocities
        self.results = self.potential.calculate(self.atoms)
        self.atoms.velocities += 0.5 * self.dt * self._accel()

    def _berendsen_thermo(self):
        t = max(self.atoms.temperature(), 1e-12)
        lam = np.sqrt(1.0 + (self.dt / self.taut) * (self.t_target / t - 1.0))
        self.atoms.velocities *= np.clip(lam, 0.9, 1.1)

    def _scale_cell(self, mu):
        """Scale cell and positions by matrix or scalar mu."""
        mu = np.asarray(mu)
        if mu.ndim == 0:
            mu = np.eye(3) * mu
        self.atoms.cell = self.atoms.cell @ mu
        self.atoms.positions = self.atoms.positions @ mu

    # ---- ensembles ----
    def step(self):
        e = self.ensemble
        if e == "nve":
            self._velocity_verlet()
        elif e == "nvt_berendsen":
            self._velocity_verlet()
            self._berendsen_thermo()
        elif e == "nvt_langevin":
            # BAOAB splitting
            a = self._accel()
            v = self.atoms.velocities
            v += 0.5 * self.dt * a
            self.atoms.positions += 0.5 * self.dt * v
            c1 = np.exp(-self.friction * self.dt)
            sigma = np.sqrt(
                KB * self.t_target / (self.atoms.masses * AMU_A2_FS2_TO_EV)
            )
            v[:] = c1 * v + np.sqrt(1 - c1**2) * sigma[:, None] * self.rng.normal(
                size=v.shape
            )
            self.atoms.positions += 0.5 * self.dt * v
            self.results = self.potential.calculate(self.atoms)
            v += 0.5 * self.dt * self._accel()
        elif e == "nvt_andersen":
            self._velocity_verlet()
            hit = self.rng.random(len(self.atoms)) < self.andersen_prob
            if np.any(hit):
                sigma = np.sqrt(
                    KB * self.t_target / (self.atoms.masses * AMU_A2_FS2_TO_EV)
                )
                self.atoms.velocities[hit] = (
                    self.rng.normal(size=(int(hit.sum()), 3)) * sigma[hit, None]
                )
        elif e == "nvt_bussi":
            self._velocity_verlet()
            self._bussi_rescale()
        elif e == "nvt_nose_hoover":
            self._nose_hoover_step()
        elif e == "npt_berendsen":
            self._velocity_verlet()
            self._berendsen_thermo()
            p = self._pressure()
            mu = (1.0 - (self.dt / self.taup) * self.kappa * (self.p_target - p)) ** (
                1.0 / 3.0
            )
            self._scale_cell(np.clip(mu, 0.98, 1.02))
        elif e == "npt_inhomogeneous_berendsen":
            self._velocity_verlet()
            self._berendsen_thermo()
            s = self._stress_full()
            diag = np.diag(s)
            mu = (1.0 - (self.dt / self.taup) * self.kappa * (self.p_target - diag)) ** (
                1.0 / 3.0
            )
            self._scale_cell(np.diag(np.clip(mu, 0.98, 1.02)))
        elif e == "npt_nose_hoover":
            self._mtk_step()
        self.nsteps += 1

    def _bussi_rescale(self):
        """Stochastic velocity rescaling (Bussi-Donadio-Parrinello 2007)."""
        dof = 3 * len(self.atoms) - 3
        ke = self.atoms.kinetic_energy()
        if ke < 1e-12:
            return
        ke_target = 0.5 * dof * KB * self.t_target
        c = np.exp(-self.dt / self.taut)
        r1 = self.rng.normal()
        r2 = float(np.sum(self.rng.normal(size=dof - 1) ** 2))
        alpha2 = (
            c
            + (1 - c) * ke_target * (r2 + r1**2) / (dof * ke)
            + 2 * r1 * np.sqrt(c * (1 - c) * ke_target / (dof * ke))
        )
        self.atoms.velocities *= np.sqrt(max(alpha2, 1e-12))

    def _nose_hoover_step(self):
        """NVT Nose-Hoover (single thermostat, Trotter splitting)."""
        dof = 3 * len(self.atoms) - 3
        ke2 = 2.0 * self.atoms.kinetic_energy()
        g = (ke2 - dof * KB * self.t_target) / self._nh_q
        self._nh_xi += 0.5 * self.dt * g
        self.atoms.velocities *= np.exp(-self._nh_xi * 0.5 * self.dt)
        self._velocity_verlet()
        self.atoms.velocities *= np.exp(-self._nh_xi * 0.5 * self.dt)
        ke2 = 2.0 * self.atoms.kinetic_energy()
        g = (ke2 - dof * KB * self.t_target) / self._nh_q
        self._nh_xi += 0.5 * self.dt * g

    def _mtk_step(self):
        """Isotropic NPT: Nose-Hoover thermostat + MTK-style barostat."""
        dof = 3 * len(self.atoms) - 3
        v_cell = self.atoms.volume
        p_int = self._pressure()
        g_eps = 3.0 * v_cell * (p_int - self.p_target) / self._mtk_w
        self._mtk_eps_p += 0.5 * self.dt * g_eps
        # thermostat half-kick
        ke2 = 2.0 * self.atoms.kinetic_energy()
        g = (ke2 - dof * KB * self.t_target) / self._nh_q
        self._nh_xi += 0.5 * self.dt * g
        scale = np.exp(-(self._nh_xi + self._mtk_eps_p) * 0.5 * self.dt)
        self.atoms.velocities *= scale
        # cell dilation
        mu = np.exp(self._mtk_eps_p * self.dt)
        self._scale_cell(np.clip(mu, 0.98, 1.02))
        self._velocity_verlet()
        scale = np.exp(-(self._nh_xi + self._mtk_eps_p) * 0.5 * self.dt)
        self.atoms.velocities *= scale
        ke2 = 2.0 * self.atoms.kinetic_energy()
        g = (ke2 - dof * KB * self.t_target) / self._nh_q
        self._nh_xi += 0.5 * self.dt * g
        p_int = self._pressure()
        g_eps = 3.0 * self.atoms.volume * (p_int - self.p_target) / self._mtk_w
        self._mtk_eps_p += 0.5 * self.dt * g_eps

    # ---- driver ----
    def run(self, steps: int):
        for _ in range(steps):
            self.step()
            if self.trajectory is not None and self.nsteps % self.loginterval == 0:
                self.trajectory.record(self.results)
            if self.logfile is not None and self.nsteps % self.loginterval == 0:
                with open(self.logfile, "a") as f:
                    f.write(
                        f"{self.nsteps} E={self.results['energy']:.6f} "
                        f"T={self.atoms.temperature():.1f}K "
                        f"P={self._pressure() * EV_A3_TO_GPA:.4f}GPa\n"
                    )
        return self.results
