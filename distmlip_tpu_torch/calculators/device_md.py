"""Device-resident MD loop over a ``DistPotential``: ``DeviceMD``.

The port of ``distmlip_tpu/calculators/device_md.py``. ``MolecularDynamics``
steps from the host: a numpy integrator, a positions upload and a forces
download every step, and a host sync for each skin invalidation's refresh.
Here positions, velocities, forces, the drift reference, the masses and the
carried graph stay on the potential's device for a whole chunk of steps;
the velocity-Verlet updates run there under ``torch.no_grad()``, and each
step's positions enter the force program as a fresh leaf, so no autograd
graph grows across steps.

Two chunk steppers, as in the JAX package:

- **device-rebuild** (one partition, no bond graph, ``device_rebuild`` on):
  when a trial step passes skin/2 of drift from the graph's build
  positions, the edges are rebuilt on the device (``neighbors/device.py``'s
  cell list and ``partition.device_refresh_graph``, under DeviceMD's own
  cell-list spec) and the step is committed with them. A cell or edge
  overflow returns the uncommitted state; the host then rebuilds with the
  capacities grown (``grow_caps_after_overflow``).
- **host-rebuild** (P > 1, a bond graph, or ``device_rebuild=False``): the
  chunk stops at the first trial step past skin/2, without committing it,
  and the host rebuilds between chunks.

The JAX chunk is one device program (``lax.while_loop`` with a
data-dependent ``cond``) that reads nothing back until it ends. PyTorch has
no such loop, so the port's chunk is a host loop over device tensors, and
each step reads one device flag: whether the trial step passed skin/2. A
step that refreshes the edges reads one more, the refresh's ``(n_edges,
overflow)`` in one copy (as ``DistPotential._try_device_refresh`` does).
Nothing else crosses to the host inside a chunk: no positions, forces or
energies per step. ``host_reads`` counts these reads. A step without any
host read would need the step captured as a CUDA graph with a conditional
node (ROADMAP.md queue A item 3).

Optional Berendsen velocity rescaling (``temperature`` and ``taut``) gives
NVT; NVE is the default. The JAX package's ``DISTMLIP_DEVICE_REBUILD=0`` is
the explicit ``device_rebuild=False`` here: the port has no env switches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..neighbors.device import (as_device_arrays, build_cell_list_spec,
                                grow_caps_after_overflow)
from ..parallel.runtime import make_total_energy
from ..partition import device_refresh_graph
from .atoms import AMU_A2_FS2_TO_EV, KB, Atoms


class _Integrator:
    """Velocity Verlet with an optional Berendsen rescale on the chunk's
    device tensors (``distmlip_tpu/calculators/device_md.py:36-114``): the
    owned mask, the inverse masses and the dof count are fixed for a chunk;
    kinetic energy sums owned rows only."""

    def __init__(self, dt, skin, owned_mask, masses, n_total, taut, t0):
        self.dt, self.taut, self.t0 = dt, taut, t0
        self.owned = owned_mask[..., None].to(masses.dtype)
        self.masses = masses[..., None]
        self.inv_m = self.owned / (self.masses * AMU_A2_FS2_TO_EV)
        # 3N - 3 translational-projected dof, as Atoms.temperature
        self.n_dof = max(3.0 * n_total - 3.0, 1.0)
        self.half = (0.5 * skin) ** 2

    def trial(self, pos, vel, f, ref):
        """The half kick and the drift; returns (half-step velocities,
        trial positions, whether an owned atom passed skin/2 of ``ref``
        as a 0-d device bool)."""
        vel_h = vel + (0.5 * self.dt) * f * self.inv_m
        pos_n = pos + self.dt * vel_h * self.owned
        disp = (pos_n - ref) * self.owned
        return vel_h, pos_n, torch.amax(torch.sum(disp * disp, dim=-1)) >= self.half

    def kinetic(self, vel):
        return 0.5 * torch.sum(self.masses * self.owned * vel * vel) * AMU_A2_FS2_TO_EV

    def finish(self, vel_h, f_n):
        """The second half kick, then the Berendsen rescale toward ``t0``
        (``taut <= 0`` disables it), lambda clipped to [0.9, 1.1] as the
        host thermostat's."""
        vel_n = vel_h + (0.5 * self.dt) * f_n * self.inv_m
        if self.taut <= 0.0:
            return vel_n
        temp = 2.0 * self.kinetic(vel_n) / (self.n_dof * KB)
        lam = torch.sqrt(torch.clamp(
            1.0 + (self.dt / self.taut) * (self.t0 / torch.clamp(temp, min=1e-12) - 1.0),
            min=0.0)).clamp(0.9, 1.1)
        return vel_n * lam.to(vel_n.dtype)


class DeviceMD:
    """Chunked device-resident MD driver over a ``DistPotential``.

    Usage::

        pot = DistPotential(model, params, skin=1.0)
        md = DeviceMD(pot, atoms, timestep=1.0)          # NVE
        md = DeviceMD(pot, atoms, timestep=1.0,
                      temperature=300.0, taut=100.0)     # Berendsen NVT
        md.run(1000)

    ``device_rebuild="auto"`` takes the potential's ``device_rebuild``;
    True or False overrides it. The in-loop refresh runs only at one
    partition without a bond graph; otherwise the graph is rebuilt on the
    host between chunks. Requires ``potential.skin > 0`` (the reuse radius
    is the rebuild criterion).

    ``cell_capacity`` pins the device cell list's atoms-per-cell capacity
    (default: estimated from the first build with slack); an overflow grows
    it and drops the pin once it is outgrown.

    Counters: ``steps_done``, ``rebuilds`` (host builds used),
    ``rebuilds_on_device`` (in-loop refreshes, and the potential's own
    refreshes at a chunk's start), ``rebuild_overflows`` and
    ``host_reads`` (device-to-host reads inside chunks: one flag a trial
    step, one more a refresh). ``energies`` gets each chunk's last
    potential energy; ``results`` holds ``energy`` and ``kinetic``.
    """

    def __init__(self, potential, atoms: Atoms, timestep: float = 1.0,
                 temperature: float | None = None, taut: float = 100.0,
                 device_rebuild: bool | str = "auto",
                 cell_capacity: int | None = None,
                 telemetry=None):
        if telemetry is not None:
            raise NotImplementedError(
                "telemetry hubs are not ported (ROADMAP.md queue A item 8, A12)")
        if potential.skin <= 0.0:
            raise ValueError("DeviceMD requires DistPotential(skin > 0)")
        if not (isinstance(device_rebuild, bool) or device_rebuild == "auto"):
            raise TypeError(
                f"device_rebuild must be 'auto', True or False, got {device_rebuild!r}")
        self.pot = potential
        self.atoms = atoms
        self.dt = float(timestep)
        self.temperature = temperature
        self.taut = float(taut) if temperature is not None else 0.0
        # the force program: positions only, no strain; the potential's
        # kernels flag and (through its model) compute dtype carry over
        self._total_energy = make_total_energy(potential.model.energy_fn,
                                               kernels=potential.kernels)
        if device_rebuild == "auto":
            device_rebuild = bool(potential.device_rebuild)
        self.device_rebuild = bool(device_rebuild and potential.num_partitions == 1
                                   and not potential.use_bond_graph)
        self._spec = None       # (CellListStatic, arrays on the device)
        self._spec_key = None
        self._cell_capacity = cell_capacity
        self._cell_cap_floor = 4
        self.steps_done = 0
        self.rebuilds = 0             # host graph builds used
        self.rebuilds_on_device = 0   # in-loop device rebuilds
        self.rebuild_overflows = 0    # device-capacity busts -> host fallback
        self.host_reads = 0           # device-to-host reads inside chunks
        self.energies: list[float] = []
        self.results: dict = {"energy": None, "kinetic": 0.0}

    def _forces(self, graph, pos):
        """Energy and forces at ``pos``: one autograd pass over a fresh
        leaf, with respect to the positions only."""
        x = pos.detach().requires_grad_(True)
        strain = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device)
        with torch.enable_grad():
            e = self._total_energy(self.pot.params, graph, x, strain)
            (g,) = torch.autograd.grad(e, [x])
        return e.detach(), -g

    def _ensure_spec(self, graph) -> None:
        """(Re)build the device cell-list spec when the graph's capacity
        bucket or the cell capacity changes, or on first use
        (``distmlip_tpu/calculators/device_md.py:307-330``)."""
        pot, atoms = self.pot, self.atoms
        key = (graph.n_cap, graph.e_cap, self._cell_capacity, self._cell_cap_floor)
        if self._spec is not None and self._spec_key == key:
            return
        static, arrays = build_cell_list_spec(
            atoms.cell, atoms.pbc, pot.cutoff + pot.skin, len(atoms), graph.n_cap,
            graph.e_cap, positions=atoms.positions, cell_cap=self._cell_capacity,
            min_cell_cap=self._cell_cap_floor, dtype=_np_dtype(graph))
        self._spec = (static, as_device_arrays(arrays, pot.device))
        self._spec_key = key

    def _grow_caps_after_overflow(self, edges_needed: int, e_cap: int,
                                  cell_cap: int) -> None:
        """Grow whichever capacity overflowed (the policy DistPotential
        shares); the next host build, and the spec keyed on its caps, take
        the new sizes."""
        new_floor = grow_caps_after_overflow(self.pot.caps, edges_needed, e_cap, cell_cap,
                                             self._cell_cap_floor)
        if new_floor != self._cell_cap_floor:
            self._cell_cap_floor = new_floor
            self._cell_capacity = None  # an explicit pin is outgrown

    def _host_chunk(self, integ, graph, pos, ref, vel, n):
        """Up to ``n`` steps on one graph; stops before the first trial
        step past skin/2 of ``ref`` (not committed). Returns (pos, vel,
        steps, energy, kinetic), the last two 0-d device tensors."""
        e, f = self._forces(graph, pos)
        steps = 0
        with torch.no_grad():
            while steps < n:
                vel_h, pos_n, exceed = integ.trial(pos, vel, f, ref)
                self.host_reads += 1
                if bool(exceed):
                    break
                e, f = self._forces(graph, pos_n)
                pos, vel = pos_n, integ.finish(vel_h, f)
                steps += 1
            return pos, vel, steps, e, integ.kinetic(vel)

    def _device_chunk(self, integ, graph, pos, ref, vel, n):
        """Up to ``n`` steps with the edges refreshed on the device when a
        trial step passes skin/2 of ``ref``; an overflowing refresh stops
        the chunk before that step. Returns (graph, ref, pos, vel, steps,
        energy, kinetic, overflow, refreshes, edges_needed)."""
        static, arrays = self._spec
        e, f = self._forces(graph, pos)
        steps = refreshes = edges_needed = 0
        overflow = False
        with torch.no_grad():
            while steps < n:
                vel_h, pos_n, exceed = integ.trial(pos, vel, f, ref)
                self.host_reads += 1
                if bool(exceed):
                    graph_n, n_edges, ovf = device_refresh_graph(static, arrays, graph, pos_n)
                    # the refresh's one device-to-host copy: the count and the flag
                    self.host_reads += 1
                    edges_needed, overflow = torch.stack(
                        [n_edges, ovf.to(n_edges.dtype)]).tolist()
                    if overflow:
                        # not committed: the host rebuilds with grown caps and
                        # the trajectory resumes from pos; the discarded
                        # refresh is not counted
                        break
                    graph, ref = graph_n, pos_n
                    refreshes += 1
                e, f = self._forces(graph, pos_n)
                pos, vel = pos_n, integ.finish(vel_h, f)
                steps += 1
            return (graph, ref, pos, vel, steps, e, integ.kinetic(vel), bool(overflow),
                    refreshes, int(edges_needed))

    def run(self, steps: int, max_chunk: int | None = None) -> None:
        """``steps`` steps in chunks of at most ``max_chunk`` (default: one
        chunk); each chunk starts from the potential's graph (built,
        refreshed or reused by ``_prepare``) with its forces recomputed."""
        pot, atoms = self.pot, self.atoms
        remaining = int(steps)
        if remaining <= 0:
            return
        max_chunk = int(max_chunk or steps)
        overflow_stalls = 0
        while remaining > 0:
            on_device = pot.rebuild_on_device_count
            graph, host, positions = pot._prepare(atoms)
            # a fresh graph was built at these positions (on the host, or
            # refreshed on the device by the potential); a cache hit arrives
            # with part of its drift budget spent
            fresh = pot.last_build_fresh
            fresh_on_device = pot.rebuild_on_device_count > on_device
            self.rebuilds += int(fresh and not fresh_on_device)
            self.rebuilds_on_device += int(fresh and fresh_on_device)
            dtype = _np_dtype(graph)

            def upload(x, fill=0.0):
                return torch.as_tensor(
                    host.scatter_global(x.astype(dtype), graph.n_cap, fill=fill)).to(pot.device)

            # the drift reference is the positions the graph was BUILT at
            # (cache slot 2): a warm cache charges the drift already spent
            ref = upload(pot._cache[2])
            vel = upload(atoms.velocities)
            masses = upload(atoms.masses, fill=1.0)
            integ = _Integrator(self.dt, pot.skin, graph.owned_mask, masses, len(atoms),
                                self.taut, float(self.temperature or 0.0))
            n = min(remaining, max_chunk)
            if self.device_rebuild:
                self._ensure_spec(graph)
                (graph_f, ref_f, pos_f, vel_f, done, e_f, ke, overflow, refreshes,
                 edges_needed) = self._device_chunk(integ, graph, positions, ref, vel, n)
                self.rebuilds_on_device += refreshes
                atoms.positions = _gather(host, pos_f, len(atoms))
                atoms.velocities = _gather(host, vel_f, len(atoms))
                if refreshes:
                    # the carried graph was refreshed in the loop: it goes
                    # back into the skin cache with ITS build positions, so
                    # the next chunk (or a calculate) reuses it
                    pot._install_refreshed(graph_f, _gather(host, ref_f, len(atoms)))
                if done:
                    self.energies.append(float(e_f))
                    self.steps_done += done
                    remaining -= done
                    self.results = {"energy": self.energies[-1], "kinetic": float(ke)}
                    # the stall guard counts CONSECUTIVE overflows that
                    # commit no step
                    overflow_stalls = 0
                if overflow:
                    self.rebuild_overflows += 1
                    self._grow_caps_after_overflow(edges_needed, graph.e_cap,
                                                   self._spec[0].cell_cap)
                    pot._cache = None  # host rebuild at the current positions
                    if not done:
                        overflow_stalls += 1
                        if overflow_stalls > 4:
                            raise RuntimeError(
                                "device neighbor rebuild overflowed repeatedly without "
                                "progress; capacities are not converging")
                continue
            pos_f, vel_f, done, e_f, ke = self._host_chunk(integ, graph, positions, ref, vel, n)
            if done == 0:
                if not fresh:
                    # a warm cache arrived with its skin budget spent: rebuild
                    # at the current positions (on the device where the
                    # potential can) and retry
                    pot._mark_cache_stale()
                    continue
                # a fresh build's reference is the current positions, so one
                # dt moves an atom past skin/2: retrying cannot help
                raise RuntimeError("device MD chunk made no progress; increase skin")
            atoms.positions = _gather(host, pos_f, len(atoms))
            atoms.velocities = _gather(host, vel_f, len(atoms))
            if done < n:
                # the chunk stopped on the skin criterion: the next chunk (or
                # calculate) rebuilds, in place on the device where it can
                pot._mark_cache_stale()
            self.energies.append(float(e_f))
            self.steps_done += done
            remaining -= done
            self.results = {"energy": self.energies[-1], "kinetic": float(ke)}


def _np_dtype(graph):
    return np.float32 if graph.positions.dtype == torch.float32 else np.float64


def _gather(host, x, n_atoms):
    """A (P, N_cap, 3) device tensor's owned rows as a float64 (N, 3) array."""
    return host.gather_owned(x.detach().cpu().numpy().astype(np.float64), n_atoms)
