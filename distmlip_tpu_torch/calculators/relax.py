"""Structure relaxation: FIRE / L-BFGS / BFGS / MDMin / CG with optional
cell relaxation.

The port's own copy of ``distmlip_tpu/calculators/relax.py``, step for
step. All optimizers run over a combined (positions, strain)
degree-of-freedom vector; the strain block plays the role of ASE's cell
filters, with two parameterizations: ``cell_filter="unit"`` applies
incremental symmetric strain (ASE UnitCellFilter analogue) and ``"exp"``
accumulates a symmetric generator S with cell = cell0 @ expm(S) (ASE
ExpCellFilter analogue: first-order gradient -V sigma / cell_factor, exact
exponential map).

Neighbor refresh between optimizer steps rides the potential's skin cache:
with ``DistPotential(skin > 0)`` and no bond graph an invalidation triggers
the on-device edge rebuild (``neighbors/device.py``) instead of a host
rebuild. Cell relaxation (``relax_cell=True``) changes the lattice, which
changes the structure key and takes the host rebuild.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .atoms import Atoms


@dataclass
class RelaxResult:
    atoms: Atoms
    converged: bool
    nsteps: int
    energy: float
    forces: np.ndarray
    stress: np.ndarray
    trajectory: list = field(default_factory=list)


_OPTIMIZERS = ("fire", "lbfgs", "bfgs", "mdmin", "cg")


def _expm_sym(S: np.ndarray) -> np.ndarray:
    """Exact matrix exponential of a symmetric 3x3 (via eigendecomposition)."""
    w, V = np.linalg.eigh(0.5 * (S + S.T))
    return (V * np.exp(w)) @ V.T


class Relaxer:
    def __init__(
        self,
        potential,
        optimizer: str = "fire",     # one of _OPTIMIZERS
        relax_cell: bool = False,
        cell_filter: str = "unit",   # "unit" | "exp" (ASE Unit/ExpCellFilter)
        fmax: float = 0.05,          # eV/Å
        smax: float = 0.005,         # eV/Å^3 (cell gradient tolerance)
        dt_start: float = 0.1,
        dt_max: float = 1.0,
        n_min: int = 5,
        f_inc: float = 1.1,
        f_dec: float = 0.5,
        alpha_start: float = 0.1,
        f_alpha: float = 0.99,
        maxstep: float = 0.2,        # trust radius, Å per component
        cell_factor: float | None = None,  # None -> len(atoms), balances cell vs position DOFs
        telemetry=None,
    ):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} not in {_OPTIMIZERS}")
        if telemetry is not None:
            raise NotImplementedError(
                "telemetry hubs are not ported (ROADMAP.md queue A item "
                "'Telemetry and observability')")
        if cell_filter not in ("unit", "exp"):
            raise ValueError(f"cell_filter {cell_filter!r} not in ('unit', 'exp')")
        self.potential = potential
        self.optimizer = optimizer
        self.relax_cell = relax_cell
        self.cell_filter = cell_filter
        self.fmax = fmax
        self.smax = smax
        self.dt_start, self.dt_max = dt_start, dt_max
        self.n_min, self.f_inc, self.f_dec = n_min, f_inc, f_dec
        self.alpha_start, self.f_alpha = alpha_start, f_alpha
        self.maxstep = maxstep
        self.cell_factor = cell_factor

    def relax(self, atoms: Atoms, steps: int = 500, record: bool = False,
              traj_file: str | None = None, interval: int = 1) -> RelaxResult:
        """Relax ``atoms``. ``traj_file`` saves a TrajectoryObserver npz
        every ``interval`` accepted steps (the reference Relaxer's
        traj_file/interval surface, implementations/matgl/ase.py:171-223);
        ``record`` additionally keeps a per-step summary in the result."""
        from .md import TrajectoryObserver

        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        atoms = atoms.copy()
        obs = TrajectoryObserver(atoms) if traj_file else None
        last_recorded = -1
        n = len(atoms)
        cell_factor = self.cell_factor if self.cell_factor is not None else max(n, 1)
        state = {
            # fire
            "v": np.zeros((n + 3, 3)), "dt": self.dt_start,
            "alpha": self.alpha_start, "n_pos": 0,
            # lbfgs
            "s": [], "y": [], "g_prev": None, "m": 10,
            # bfgs
            "B": None, "bfgs_g_prev": None, "bfgs_step_prev": None,
            # mdmin
            "v_md": np.zeros((n + 3, 3)),
            # cg
            "cg_d": None, "cg_g_prev": None,
            # exp cell filter: accumulated generator + reference cell
            "S": np.zeros((3, 3)), "cell0": atoms.cell.copy(),
        }
        step_fn = {
            "fire": self._fire_step, "lbfgs": self._lbfgs_step,
            "bfgs": self._bfgs_step, "mdmin": self._mdmin_step,
            "cg": self._cg_step,
        }[self.optimizer]
        traj = []
        res = self.potential.calculate(atoms)
        converged = False
        it = 0
        for it in range(1, steps + 1):
            # generalized gradient: forces block + cell block (-V * stress)
            g = np.zeros((n + 3, 3))
            g[:n] = res["forces"]
            if self.relax_cell:
                g[n:] = -atoms.volume * res["stress"] / cell_factor
            f_norm = np.abs(g[:n]).max() if n else 0.0
            s_norm = np.abs(res["stress"]).max() if self.relax_cell else 0.0
            if record:
                traj.append(
                    {"energy": res["energy"], "fmax": f_norm, "cell": atoms.cell.copy()}
                )
            if obs is not None and (it - 1) % interval == 0:
                obs.record(res)
                last_recorded = it
            if f_norm < self.fmax and (not self.relax_cell or s_norm < self.smax):
                converged = True
                break
            step_vec = step_fn(g, state)
            self._apply_step(atoms, step_vec, n, cell_factor, state)
            res = self.potential.calculate(atoms)

        if obs is not None:
            # The loop-top record only captured the FINAL state on the
            # converged break path (res unchanged since). On exhaustion the
            # loop stepped again after the last record, so res (the returned
            # final state) must always be appended — otherwise with
            # interval=1 every non-converged relax saved a trajectory whose
            # last frame != RelaxResult.energy.
            if not (converged and last_recorded == it):
                obs.record(res)
            obs.save(traj_file)
        return RelaxResult(
            atoms=atoms, converged=converged, nsteps=it, energy=res["energy"],
            forces=res["forces"], stress=res["stress"], trajectory=traj,
        )

    # ---- step application (cell filters) ----
    def _apply_step(self, atoms, step_vec, n, cell_factor, state):
        atoms.positions += step_vec[:n]
        if not self.relax_cell:
            return
        strain = step_vec[n:] / max(atoms.volume, 1.0) * cell_factor
        strain = 0.5 * (strain + strain.T)
        if self.cell_filter == "exp":
            # accumulate the symmetric generator; exact exponential map
            old_cell = atoms.cell.copy()
            state["S"] = state["S"] + strain
            new_cell = state["cell0"] @ _expm_sym(state["S"])
            defm = np.linalg.solve(old_cell, new_cell)
        else:  # "unit": incremental symmetric deformation
            defm = np.eye(3) + strain
            new_cell = atoms.cell @ defm
        atoms.cell = new_cell
        atoms.positions = atoms.positions @ defm

    def _clip(self, step):
        max_step = np.abs(step).max()
        if max_step > self.maxstep:
            step = step * (self.maxstep / max_step)
        return step

    # ---- optimizers (g = downhill generalized gradient = -grad E) ----
    def _fire_step(self, g, state):
        v = state["v"]
        p = float(np.vdot(g, v))
        if p > 0:
            state["n_pos"] += 1
            if state["n_pos"] > self.n_min:
                state["dt"] = min(state["dt"] * self.f_inc, self.dt_max)
                state["alpha"] *= self.f_alpha
        else:
            state["n_pos"] = 0
            state["dt"] *= self.f_dec
            state["alpha"] = self.alpha_start
            v[:] = 0.0
        v += state["dt"] * g
        gn = np.linalg.norm(g) + 1e-12
        vn = np.linalg.norm(v)
        v[:] = (1 - state["alpha"]) * v + state["alpha"] * g / gn * vn
        return self._clip(state["dt"] * v)

    def _mdmin_step(self, g, state):
        """ASE MDMin (quick-min): velocity kicked along the gradient, kept
        only when pointing downhill, and projected onto the gradient."""
        dt = self.dt_start
        v = state["v_md"]
        v += dt * g
        p = float(np.vdot(v, g))
        if p <= 0:
            v[:] = 0.0
        else:
            v[:] = g * (p / max(float(np.vdot(g, g)), 1e-12))
        return self._clip(dt * v)

    def _bfgs_step(self, g, state):
        """Dense BFGS (ASE's default optimizer): approximate Hessian B
        updated from (step, gradient-change) pairs, step = -B^-1 grad with
        eigenvalue flooring (curvature clamped positive) + trust radius.

        Dense: B is (3n)^2 with a per-step eigendecomposition — right for
        unit cells and small systems, unusable at this framework's large
        scales (guarded below; use "lbfgs" or "fire" there)."""
        grad = -g.ravel()
        d = grad.size
        if d > 3000:  # ~1000 atoms: B would be 9e6 doubles, eigh ~minutes
            raise ValueError(
                f"optimizer='bfgs' builds a dense ({d}, {d}) Hessian; use "
                f"'lbfgs' or 'fire' for systems above ~1000 atoms")
        if state["B"] is None:
            state["B"] = np.eye(d) * 70.0  # ASE's H0 (eV/Å^2)
        if state["bfgs_g_prev"] is not None:
            s_vec = state["bfgs_step_prev"]
            y_vec = grad - state["bfgs_g_prev"]
            sy = float(s_vec @ y_vec)
            # positive-curvature pairs only (as _lbfgs_step): a negative sy
            # would make B indefinite and the clamped s@Bs denominator
            # amplifies the rank-1 subtraction instead of protecting it
            if sy > 1e-12:
                B = state["B"]
                Bs = B @ s_vec
                sBs = float(s_vec @ Bs)
                if sBs > 1e-12:
                    state["B"] = (B + np.outer(y_vec, y_vec) / sy
                                  - np.outer(Bs, Bs) / sBs)
        w, V = np.linalg.eigh(state["B"])
        w = np.maximum(np.abs(w), 1e-3)  # flooring: always downhill
        step = -(V @ ((V.T @ grad) / w))
        step = self._clip(step)
        state["bfgs_g_prev"] = grad
        state["bfgs_step_prev"] = step
        return step.reshape(g.shape)

    def _cg_step(self, g, state):
        """Polak–Ribière conjugate gradient with a conservative fixed step
        scale (scipyfmincg analogue without line searches — every energy/
        force call is a full graph-parallel evaluation, so cheap fixed
        steps + trust radius beat line searches here)."""
        grad = -g.ravel()
        if state["cg_g_prev"] is None:
            d = -grad
        else:
            gp = state["cg_g_prev"]
            beta = max(0.0, float(grad @ (grad - gp)) / max(float(gp @ gp), 1e-12))
            d = -grad + beta * state["cg_d"]
            if float(d @ grad) > 0:  # uphill: reset
                d = -grad
        state["cg_d"] = d
        state["cg_g_prev"] = grad
        return self._clip(0.05 * d).reshape(g.shape)

    def _lbfgs_step(self, g, state):
        """L-BFGS two-loop recursion on the downhill gradient g (= -grad E).

        Tracks (s, y) pairs internally; returns the proposed step (same shape
        as g). Uses a conservative initial scaling and resets on curvature
        breakdown.
        """
        grad = -g.ravel()  # actual gradient of E
        if state["g_prev"] is not None:
            s_vec = state["step_prev"]
            y_vec = grad - state["g_prev"]
            sy = float(s_vec @ y_vec)
            if sy > 1e-10:
                state["s"].append(s_vec)
                state["y"].append(y_vec)
                if len(state["s"]) > state["m"]:
                    state["s"].pop(0)
                    state["y"].pop(0)
        q = grad.copy()
        alphas = []
        for s_vec, y_vec in zip(reversed(state["s"]), reversed(state["y"])):
            rho = 1.0 / (s_vec @ y_vec)
            a = rho * (s_vec @ q)
            alphas.append((a, rho, s_vec, y_vec))
            q -= a * y_vec
        if state["s"]:
            s_vec, y_vec = state["s"][-1], state["y"][-1]
            q *= (s_vec @ y_vec) / max(y_vec @ y_vec, 1e-12)
        else:
            q *= 0.05  # first-step damping
        for a, rho, s_vec, y_vec in reversed(alphas):
            b = rho * (y_vec @ q)
            q += (a - b) * s_vec
        step = self._clip(-q)  # trust radius; store the APPLIED step for (s, y)
        state["g_prev"] = grad
        state["step_prev"] = step
        return step.reshape(g.shape)
