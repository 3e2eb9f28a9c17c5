"""Batched multi-structure execution: the potential and vectorized relax/MD.

Port of ``distmlip_tpu/calculators/batched.py``.
``BatchedPotential.calculate(list[Atoms]) -> list[dict]`` evaluates a batch
of independent structures in ONE pass of the model over a block-diagonally
packed graph (``partition.pack_structures``), so every kernel launch covers
the whole batch: the screening and serving regime of many small structures,
where one structure per call leaves the card idle between tiny graphs.
``BatchedRelaxer`` and ``BatchedMD`` drive such a batch through fixed-cell
relaxation (FIRE or gradient descent with per-structure convergence
masking) and MD (``nve``, ``nvt_berendsen``, ``nvt_langevin``).

Packing, padding and masking change no result: per-structure energies,
forces, stresses and magmoms equal ``DistPotential``'s on each structure
alone to float32 roundoff (``tests/test_torch_batched.py``).

Capacities come from a geometric ``BucketPolicy``, so a stream of varied
batches runs at a small fixed set of padded shapes (``compile_count``, the
distinct shape buckets dispatched).

With a telemetry hub (``telemetry=``, or ``attach_telemetry``, which
``BatchedRelaxer``, ``BatchedMD`` and the serving engine route theirs
through) every ``calculate`` emits one ``batched_calculate`` record
(``distmlip_tpu/calculators/batched.py:552-597``): the bucket key, batch
size, padding waste and slot occupancy, the cache and rebuild flags, the
kernel routing and the device memory. A first dispatch at a new bucket goes
into the compile log (``obs.profiling``, site ``batched_bucket``).

Not ported (raises when asked for, naming its ROADMAP.md item): the 2-D
mesh placement (``mesh=``, A7). The record's ``est_peak_bytes`` stays 0:
the JAX package takes it from its static memory planner (A13).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dispatch import kernel_routing, route_counts
from ..neighbors.device import as_device_arrays
from ..obs import profiling as obs_profiling
from ..obs import runtime as obsrt
from ..parallel import make_batched_potential_fn
from ..partition import (BucketPolicy, build_packed_refresh_spec, device_refresh_packed,
                         pack_structures)
from ..telemetry import StepRecord, annotate
from ..telemetry.record import STEP_RECORD_FIELDS
from ..telemetry.trace import tracing_enabled
from ..utils.checkpoint import params_from_numpy
from ..utils.memory import device_memory_stats
from .atoms import AMU_A2_FS2_TO_EV, EV_A3_TO_GPA, KB, map_species, max_displacement
from .calculator import atoms_system, validate_system
from .relax import RelaxResult


class BatchedPotential:
    """Batched potential over a model + parameter tree, on one device.

    Parameters mirror ``DistPotential`` where they apply; the batched path
    is single-partition (many SMALL structures per call; ``DistPotential``
    takes one large structure, split into slabs if need be).

    ``skin > 0`` reuses the packed graph across calls while the structure
    list is the same (numbers, cell, pbc and the charge/spin/dataset
    ``atoms.info`` scalars the pack bakes in) and no atom has moved
    ``skin/2`` from its build position; only the packed positions are
    uploaded.

    ``caps`` is the ``BucketPolicy`` every capacity is quantized by.

    ``device_rebuild`` ("auto" = on for models without a bond graph): when
    the skin cache invalidates but the structure list is unchanged
    (batched relax/MD), the packed edges are rebuilt on the device
    (``neighbors.device.packed_neighbors``) and swapped in place; an edge
    capacity overflow takes the host repack, which lands on a larger rung.
    True raises for a model with a bond graph (its line graph is repacked
    on the host); False always repacks on the host.

    ``kernels``: True runs the CUDA kernels on a CUDA device; False their
    plain PyTorch versions (never taken silently). ``device``: "cuda" (the
    default, also for None) or "cpu"; CUDA without a card raises.

    Memory-aware batching: on CUDA a calculate that raises the allocator's
    high-water mark (``torch.cuda.max_memory_allocated``, never reset here)
    has its own peak measured, over what was allocated when it started, and
    that increment calibrates the ``BucketPolicy`` bytes model
    (``estimate_batch_bytes``); a calculate under an earlier, higher peak
    is not measured, and its rung is estimated from the measured ones. The
    serving engine's admission and ``plan_batch`` read the model against
    ``hbm_budget_bytes``, the room for one batch's working set: by default
    0.8 of the card's total memory less what is allocated when the
    potential is made, None on the CPU (no budget check). The JAX package
    calibrates from its static planner instead (ROADMAP.md A13).
    """

    def __init__(self, model, params, species_map: np.ndarray | None = None,
                 compute_stress: bool = True, compute_magmom: bool = False,
                 caps: BucketPolicy | None = None, skin: float = 0.0,
                 device_rebuild: bool | str = "auto", mesh=None, kernels: bool = True,
                 device=None, telemetry=None, hbm_budget_bytes: int | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "BatchedPotential(mesh=...): the 2-D (batch x spatial) mesh placement is "
                "not ported (ROADMAP.md A7); the batched engine runs on one device")
        if not isinstance(kernels, bool):
            raise TypeError(f"kernels must be True or False, got {kernels!r}")
        if not (isinstance(device_rebuild, bool) or device_rebuild == "auto"):
            raise TypeError(
                f"device_rebuild must be 'auto', True or False, got {device_rebuild!r}")
        if compute_magmom and not hasattr(model, "energy_and_aux_fn"):
            raise ValueError(
                f"{type(model).__name__} has no energy_and_aux_fn (sitewise readout); "
                f"compute_magmom is a CHGNet-family capability")
        self.device = resolve_device(device)
        self.model = model
        # the model's compute dtype (cfg.dtype: "float32" or "bfloat16", as
        # the JAX batched engine inherits it from the model); it keys the
        # bytes model and the dispatched buckets. The packed graph holds
        # float32 geometry either way, so the skin cache needs no dtype key.
        self.compute_dtype = getattr(model.cfg, "dtype", "float32")
        self.params = params_from_numpy(params, self.device)
        self.species_map = species_map
        self.caps = caps or BucketPolicy()
        self.cutoff = float(model.cfg.cutoff)
        self.bond_cutoff = float(getattr(model.cfg, "bond_cutoff", 0.0))
        self.use_bond_graph = bool(getattr(model.cfg, "use_bond_graph", False))
        if device_rebuild is True and self.use_bond_graph:
            raise ValueError(
                "device_rebuild=True needs a model without a bond graph: the line graph "
                "is repacked on the host")
        self.compute_stress = bool(compute_stress)
        self.compute_magmom = bool(compute_magmom)
        self.skin = float(skin)
        self.kernels = kernels
        self._potential = make_batched_potential_fn(
            model.energy_and_aux_fn if self.compute_magmom else model.energy_fn,
            compute_stress=self.compute_stress, aux=self.compute_magmom, kernels=kernels)
        self._cache = None  # (graph on the device, host, [(numbers, cell, pbc, system)])
        self._buckets: set = set()
        self.rebuild_count = 0
        self.device_rebuild = device_rebuild is True or device_rebuild == "auto"
        self.rebuild_on_device_count = 0
        self.rebuild_overflow_count = 0
        self._refresh_spec = None  # (PackedStatic, arrays on the device)
        self.last_timings: dict = {}
        self.last_stats: dict = {}
        if hbm_budget_bytes is None and self.device.type == "cuda":
            hbm_budget_bytes = int(0.8 * torch.cuda.mem_get_info(self.device)[1]
                                   - torch.cuda.memory_allocated(self.device))
        self.hbm_budget_bytes = int(hbm_budget_bytes) if hbm_budget_bytes else None
        # the serving engine's scheduler thread and direct callers may share
        # one potential: calculate() serializes on this lock so the skin
        # cache (check, then use) is never torn
        self._lock = threading.RLock()
        # telemetry hub or None; with None no record is ever built
        self.telemetry = telemetry
        self._step_counter = 0
        self._last_compile_count = 0
        self._last_compile_s = 0.0
        self._last_compile_kind = ""

    def attach_telemetry(self, telemetry) -> None:
        """The potential's own hub wins; drivers route their
        ``telemetry=`` through here."""
        if telemetry is not None and self.telemetry is None:
            self.telemetry = telemetry

    @property
    def compile_count(self) -> int:
        """Distinct shape buckets (``partition.bucket_key``) dispatched so
        far. PyTorch eager compiles nothing; this counts what the JAX
        package's executable cache would hold, one entry per padded shape,
        which the bucket ladder bounds."""
        return len(self._buckets)

    def _species(self, numbers: np.ndarray) -> np.ndarray:
        return map_species(numbers, self.species_map)

    def _structures_match(self, structures) -> bool:
        """The cached pack covers the SAME structure list (up to positions),
        conditioning scalars included."""
        if self._cache is None:
            return False
        keys = self._cache[2]
        if len(keys) != len(structures):
            return False
        return all(len(numbers0) == len(atoms) and np.array_equal(numbers0, atoms.numbers)
                   and np.array_equal(cell0, atoms.cell) and np.array_equal(pbc0, atoms.pbc)
                   and system0 == atoms_system(atoms)
                   for (numbers0, cell0, pbc0, system0), atoms in zip(keys, structures))

    def _cache_valid(self, structures) -> bool:
        if self.skin <= 0.0 or not self._structures_match(structures):
            return False
        half = 0.5 * self.skin
        return all(max_displacement(atoms.positions, pos0) < half
                   for pos0, atoms in zip(self._cache[1].build_positions, structures))

    def _device_refresh_eligible(self) -> bool:
        return self.device_rebuild and self.skin > 0.0 and not self.use_bond_graph

    def _upload_positions(self, host, structures) -> torch.Tensor:
        return torch.as_tensor(host.scatter_positions(
            [a.positions.astype(np.float32) for a in structures])).to(self.device)

    def _build(self, structures):
        with annotate("distmlip/batch_pack"):
            graph, host = pack_structures(
                structures, self.cutoff, self.bond_cutoff, self.use_bond_graph,
                caps=self.caps, species_fn=self._species, skin=self.skin)
        self.rebuild_count += 1
        # built lazily at the first refresh: a churning stream (every
        # serving batch different) never pays for it
        self._refresh_spec = None
        with annotate("distmlip/graph_upload"):
            return graph.to(self.device), host

    def _try_device_refresh(self, structures):
        """Rebuild the cached pack's edges on the device at the current
        positions. Returns ``(graph, host, positions, rebuild_s)``, or None
        on an overflow (the caller repacks on the host)."""
        graph, host, keys = self._cache
        t0 = time.perf_counter()
        if self._refresh_spec is None:
            static, arrays = build_packed_refresh_spec(host, graph, self.cutoff + self.skin)
            self._refresh_spec = (static, as_device_arrays(arrays, self.device))
        positions = self._upload_positions(host, structures)
        static, arrays = self._refresh_spec
        with annotate("distmlip/device_rebuild"):
            graph2, n_edges, overflow = device_refresh_packed(static, arrays, graph, positions)
            # the refresh's one device-to-host copy: the count and the flag
            n_edges, overflow = torch.stack([n_edges, overflow.to(n_edges.dtype)]).tolist()
        if overflow:
            self.rebuild_overflow_count += 1
            return None
        self.rebuild_count += 1
        self.rebuild_on_device_count += 1
        host.build_positions = [np.asarray(a.positions).copy() for a in structures]
        if host.stats:
            host.stats["n_edges_per_part"] = [n_edges]
            host.stats["edge_occupancy"] = n_edges / graph.e_cap if graph.e_cap else 0.0
        self._cache = (graph2, host, keys)
        return graph2, host, positions, time.perf_counter() - t0

    def estimate_batch_bytes(self, total_atoms: int) -> int | None:
        """Device peak estimate for a batch of ``total_atoms`` atoms from the
        calibrated bytes model (None before the first calibration)."""
        return self.caps.estimate_batch_bytes(total_atoms, self.compute_dtype)

    def calculate(self, structures) -> list:
        """One result dict per input structure: energy (eV), forces (eV/Å),
        stress (eV/Å^3, ASE sign) and magmoms with ``compute_magmom``, all
        numpy on the host. Thread-safe (serialized on an internal lock)."""
        structures = list(structures)
        if not structures:
            return []
        with self._lock:
            return self._calculate_locked(structures)

    def _prepare_batch(self, structures):
        """Build, refresh or reuse the packed graph and upload the positions.
        Returns ``(graph, host, positions, reused, refreshed, rebuild_s,
        (t0, t1, t2))``."""
        t0 = time.perf_counter()
        reused = self._cache_valid(structures)
        refreshed, rebuild_s, positions = False, 0.0, None
        if reused:
            graph, host, _ = self._cache
        else:
            graph = host = None
            if self._device_refresh_eligible() and self._structures_match(structures):
                out = self._try_device_refresh(structures)
                if out is not None:
                    graph, host, positions, rebuild_s = out
                    refreshed = True
            if graph is None:
                graph, host = self._build(structures)
                if self.skin > 0.0:
                    self._cache = (graph, host, [(a.numbers.copy(), a.cell.copy(),
                                                  a.pbc.copy(), atoms_system(a))
                                                 for a in structures])
        t1 = time.perf_counter()
        if positions is None:
            positions = self._upload_positions(host, structures)
        t2 = time.perf_counter()
        return graph, host, positions, reused, refreshed, rebuild_s, (t0, t1, t2)

    def _calculate_locked(self, structures) -> list:
        # the packer raises when the structures' conditioning disagrees
        validate_system(self.model.cfg, atoms_system(structures[0]))
        cuda = self.device.type == "cuda"
        if cuda:
            # allocations are made in program order on this thread, so these
            # host-side counters need no synchronization
            base = torch.cuda.memory_allocated(self.device)
            high = torch.cuda.max_memory_allocated(self.device)
        graph, host, positions, reused, refreshed, rebuild_s, (t0, t1, t2) = \
            self._prepare_batch(structures)
        key = (host.stats["bucket_key"], self.compute_dtype)
        routes = dict(route_counts) if self.telemetry is not None else None
        ann_name = "distmlip/batched_potential"
        if tracing_enabled():
            # under a serving batch the ambient trace id names the range,
            # lining the device timeline up with the host spans
            tid = obsrt.current_trace_id()
            if tid is not None:
                ann_name = f"{ann_name}[trace={tid}]"
        with annotate(ann_name):
            out = self._potential(self.params, graph, positions)
            energies = out["energies"].double().cpu().numpy()
        forces = host.gather_per_structure(out["forces"].cpu().numpy())
        strain_grad = out["strain_grad"].cpu().numpy()
        magmoms = (host.gather_per_structure(out["aux"]["magmoms"].cpu().numpy())
                   if "aux" in out else None)
        batch_peak = None
        if cuda and torch.cuda.max_memory_allocated(self.device) > high:
            # this call raised the high-water mark: its own peak is the new one
            batch_peak = torch.cuda.max_memory_allocated(self.device) - base
            self.caps.calibrate_bytes(self.caps.get("nodes", int(host.n_atoms.sum())),
                                      batch_peak, self.compute_dtype)
        new_bucket = key not in self._buckets
        self._buckets.add(key)
        results = []
        for b in range(len(structures)):
            stress = strain_grad[b] / max(host.volumes[b], 1e-30)
            res = {"energy": float(energies[b]), "free_energy": float(energies[b]),
                   "forces": forces[b], "stress": stress, "stress_GPa": stress * EV_A3_TO_GPA}
            if magmoms is not None:
                res["magmoms"] = magmoms[b]
            results.append(res)
        t3 = time.perf_counter()
        self.last_timings = {"neighbor_s": (t1 - t0) - rebuild_s, "partition_s": t2 - t1,
                             "device_s": t3 - t2, "total_s": t3 - t0}
        if refreshed:
            self.last_timings["rebuild_s"] = rebuild_s
        self.last_stats = dict(host.stats or {})
        self.last_stats.update(
            batch_size=len(structures), rebuild_count=int(not reused),
            rebuild_on_device=int(refreshed), rebuild_overflow_count=self.rebuild_overflow_count,
            batch_peak_bytes=batch_peak)
        # compile log: the first dispatch at a bucket (a rare event, logged
        # with or without a hub, as the JAX package logs its compiles)
        self._last_compile_s, self._last_compile_kind = 0.0, ""
        if new_bucket:
            self._last_compile_s = t3 - t2
            self._last_compile_kind = obs_profiling.KIND_FRESH
            obs_profiling.record_compile(site="batched_bucket", kind=obs_profiling.KIND_FRESH,
                                         wall_s=self._last_compile_s,
                                         bucket_key=host.stats["bucket_key"])
        if self.telemetry is not None:
            kernel_mode, kernel_coverage = kernel_routing(routes)
            self.last_stats.update(kernel_mode=kernel_mode, kernel_coverage=kernel_coverage)
            self._emit_record(host, len(structures), reused, refreshed, t3 - t0)
        else:
            self._step_counter += 1
        return results

    def _emit_record(self, host, n_structures: int, reused: bool, refreshed: bool,
                     total_s: float, kind: str = "batched_calculate",
                     member_count: int = 0) -> None:
        """One ``StepRecord`` of the last calculate
        (``distmlip_tpu/calculators/batched.py:546-597``); the caller
        checks that a hub is attached."""
        self._step_counter += 1
        tel = self.telemetry
        if tel is None or not tel.wants_records():
            return
        cache_size = self.compile_count
        compiled = cache_size > self._last_compile_count
        self._last_compile_count = cache_size
        # under a serving dispatch the ambient context is the serve.batch
        # span, so this record and the exported span tree share ids
        ctx = obsrt.current_ctx()
        rec = StepRecord(
            step=self._step_counter, kind=kind, member_count=member_count,
            trace_id=ctx[0] if ctx is not None else "",
            span_id=ctx[1] if ctx is not None else "",
            timings=dict(self.last_timings),
            compile_cache_size=cache_size, compiled=compiled,
            compile_s=self._last_compile_s, compile_kind=self._last_compile_kind,
            graph_reused=reused, rebuild=not reused,
            rebuild_count=int(not reused), rebuild_on_device=int(refreshed),
            rebuild_overflow_count=self.rebuild_overflow_count,
            structures_per_sec=n_structures / total_s if total_s > 0 else 0.0,
            kernel_mode=self.last_stats.get("kernel_mode", ""),
            kernel_coverage=self.last_stats.get("kernel_coverage", 0.0),
            device_memory=device_memory_stats() if self.device.type == "cuda" else {})
        for k, v in (host.stats or {}).items():
            # non-field stats (n_lines, batch_slots) ride extra
            if k in STEP_RECORD_FIELDS:
                setattr(rec, k, v)
            else:
                rec.extra[k] = v
        rec.batch_size = n_structures  # real structures, not padded slots
        tel.emit(rec)


def _segment_ids(n_atoms) -> np.ndarray:
    return np.repeat(np.arange(len(n_atoms)), n_atoms)


def _per_structure_max(per_atom: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Max over each structure's slice of a (N_tot,) array (0 for empty)."""
    B = len(offsets) - 1
    out = np.zeros(B)
    for b in range(B):
        s, e = offsets[b], offsets[b + 1]
        if e > s:
            out[b] = per_atom[s:e].max()
    return out


_BATCH_OPTIMIZERS = ("fire", "gd")


class BatchedRelaxer:
    """Fixed-cell relaxation of a structure batch with per-structure
    convergence masking (``distmlip_tpu/calculators/batched.py:616``):
    every iteration evaluates the WHOLE batch in one pass, converged
    structures freeze in place (their step is zeroed, their FIRE state
    stops), and the loop ends when all have converged or after ``steps``.
    FIRE parameters match ``Relaxer``; ``optimizer="gd"`` is plain clipped
    gradient descent."""

    def __init__(self, potential: BatchedPotential, optimizer: str = "fire",
                 fmax: float = 0.05, dt_start: float = 0.1, dt_max: float = 1.0,
                 n_min: int = 5, f_inc: float = 1.1, f_dec: float = 0.5,
                 alpha_start: float = 0.1, f_alpha: float = 0.99, maxstep: float = 0.2,
                 gd_step: float = 0.05, telemetry=None):
        if optimizer not in _BATCH_OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} not in {_BATCH_OPTIMIZERS}")
        if telemetry is not None:
            potential.attach_telemetry(telemetry)
        self.potential = potential
        self.optimizer = optimizer
        self.fmax = fmax
        self.dt_start, self.dt_max = dt_start, dt_max
        self.n_min, self.f_inc, self.f_dec = n_min, f_inc, f_dec
        self.alpha_start, self.f_alpha = alpha_start, f_alpha
        self.maxstep = maxstep
        self.gd_step = gd_step

    def relax(self, structures, steps: int = 500) -> list:
        """One ``RelaxResult`` per input (``nsteps``: the iteration at which
        THAT structure converged, or the loop count when it did not)."""
        atoms_list = [a.copy() for a in structures]
        B = len(atoms_list)
        if B == 0:
            return []
        n_atoms = np.array([len(a) for a in atoms_list])
        off = np.concatenate([[0], np.cumsum(n_atoms)])
        sid = _segment_ids(n_atoms)
        n_tot = int(off[-1])
        v = np.zeros((n_tot, 3))
        dt = np.full(B, self.dt_start)
        alpha = np.full(B, self.alpha_start)
        n_pos = np.zeros(B, dtype=int)
        active = np.ones(B, dtype=bool)
        nsteps = np.zeros(B, dtype=int)

        results = self.potential.calculate(atoms_list)
        for it in range(1, steps + 1):
            f = np.concatenate([r["forces"] for r in results]) if n_tot else np.zeros((0, 3))
            fmax_b = _per_structure_max(np.abs(f).max(axis=1) if n_tot else np.zeros(0), off)
            newly = active & (fmax_b < self.fmax)
            nsteps[newly] = it - 1
            active &= ~newly
            if not active.any():
                break
            step = self._step(f, v, sid, off, dt, alpha, n_pos, active)
            step[~active[sid]] = 0.0  # frozen structures take no step
            for b in np.nonzero(active)[0]:
                atoms_list[b].positions += step[off[b]:off[b + 1]]
            nsteps[active] = it
            results = self.potential.calculate(atoms_list)
        return [RelaxResult(atoms=atoms_list[b], converged=not active[b], nsteps=int(nsteps[b]),
                            energy=results[b]["energy"], forces=results[b]["forces"],
                            stress=results[b]["stress"]) for b in range(B)]

    def _step(self, f, v, sid, off, dt, alpha, n_pos, active):
        B = len(dt)
        if self.optimizer == "gd":
            return self._clip(self.gd_step * f, off)
        # FIRE, vectorized over the batch by per-structure reductions
        p = np.zeros(B)
        np.add.at(p, sid, np.sum(f * v, axis=1))
        uphill = (p <= 0) & active
        downhill = (p > 0) & active
        n_pos[downhill] += 1
        n_pos[uphill] = 0
        grow = downhill & (n_pos > self.n_min)
        dt[grow] = np.minimum(dt[grow] * self.f_inc, self.dt_max)
        alpha[grow] *= self.f_alpha
        dt[uphill] *= self.f_dec
        alpha[uphill] = self.alpha_start
        v[uphill[sid]] = 0.0
        v += dt[sid, None] * f
        f2 = np.zeros(B)
        v2 = np.zeros(B)
        np.add.at(f2, sid, np.sum(f * f, axis=1))
        np.add.at(v2, sid, np.sum(v * v, axis=1))
        mix = alpha * np.sqrt(v2) / (np.sqrt(f2) + 1e-12)
        v[:] = (1.0 - alpha)[sid, None] * v + mix[sid, None] * f
        return self._clip(dt[sid, None] * v, off)

    def _clip(self, step, off):
        """Per-structure trust radius: scale each structure's step so its
        largest component stays within ``maxstep``."""
        comp = np.abs(step).max(axis=1) if len(step) else np.zeros(0)
        mx = _per_structure_max(comp, off)
        scale = np.where(mx > self.maxstep, self.maxstep / np.maximum(mx, 1e-30), 1.0)
        return step * scale[_segment_ids(np.diff(off)), None]


_BATCH_ENSEMBLES = ("nve", "nvt_berendsen", "nvt_langevin")


class BatchedMD:
    """Fixed-cell MD over a structure batch: one velocity-Verlet step per
    pass of the model for the WHOLE batch
    (``distmlip_tpu/calculators/batched.py:749``). Ensembles: ``nve``,
    ``nvt_berendsen`` (per-structure temperature scaling), ``nvt_langevin``
    (BAOAB). Cells stay fixed (the packed graph bakes each cell into its
    edge offsets). ``temperature`` is a scalar or one target per
    structure."""

    def __init__(self, structures, potential: BatchedPotential,
                 ensemble: str = "nvt_berendsen", timestep: float = 1.0,
                 temperature=300.0, taut: float | None = None, friction: float = 0.01,
                 seed: int | None = None, telemetry=None):
        if ensemble not in _BATCH_ENSEMBLES:
            raise ValueError(f"ensemble {ensemble!r} not in {_BATCH_ENSEMBLES} "
                             f"(batched MD is fixed-cell)")
        if telemetry is not None:
            potential.attach_telemetry(telemetry)
        self.atoms_list = [a.copy() for a in structures]
        self.potential = potential
        self.ensemble = ensemble
        self.dt = float(timestep)
        B = len(self.atoms_list)
        self.t_target = np.broadcast_to(np.asarray(temperature, dtype=np.float64), (B,)).copy()
        self.taut = taut if taut is not None else 100.0 * self.dt
        self.friction = friction
        self.rng = np.random.default_rng(seed)
        self.nsteps = 0
        self.n_atoms = np.array([len(a) for a in self.atoms_list])
        self.off = np.concatenate([[0], np.cumsum(self.n_atoms)])
        self.sid = _segment_ids(self.n_atoms)
        self.results = self.potential.calculate(self.atoms_list)

    def _gather(self, attr) -> np.ndarray:
        return (np.concatenate([getattr(a, attr) for a in self.atoms_list])
                if int(self.off[-1]) else np.zeros((0, 3)))

    def _scatter(self, attr, packed) -> None:
        for b, a in enumerate(self.atoms_list):
            setattr(a, attr, packed[self.off[b]:self.off[b + 1]].copy())

    def _forces(self) -> np.ndarray:
        return (np.concatenate([r["forces"] for r in self.results])
                if int(self.off[-1]) else np.zeros((0, 3)))

    def _masses(self) -> np.ndarray:
        return (np.concatenate([a.masses for a in self.atoms_list])
                if int(self.off[-1]) else np.zeros(0))

    def temperatures(self) -> np.ndarray:
        """Per-structure instantaneous temperatures (K)."""
        ke = np.zeros(len(self.atoms_list))
        v = self._gather("velocities")
        np.add.at(ke, self.sid, 0.5 * AMU_A2_FS2_TO_EV * self._masses() * np.sum(v * v, axis=1))
        dof = np.maximum(3 * self.n_atoms - 3, 1)
        return 2.0 * ke / (dof * KB)

    def step(self) -> None:
        m = self._masses()
        inv_m = 1.0 / (m[:, None] * AMU_A2_FS2_TO_EV) if len(m) else np.zeros((0, 1))
        v = self._gather("velocities")
        pos = self._gather("positions")
        f = self._forces()
        if self.ensemble == "nvt_langevin":
            # BAOAB: one Ornstein-Uhlenbeck kick mid-step, per-atom noise
            v = v + 0.5 * self.dt * f * inv_m
            pos = pos + 0.5 * self.dt * v
            c1 = np.exp(-self.friction * self.dt)
            sigma = np.sqrt(KB * self.t_target[self.sid] / (m * AMU_A2_FS2_TO_EV))
            v = c1 * v + np.sqrt(1 - c1 ** 2) * sigma[:, None] * self.rng.normal(size=v.shape)
            pos = pos + 0.5 * self.dt * v
            self._scatter("positions", pos)
            self.results = self.potential.calculate(self.atoms_list)
            v = v + 0.5 * self.dt * self._forces() * inv_m
        else:
            v = v + 0.5 * self.dt * f * inv_m
            pos = pos + self.dt * v
            self._scatter("positions", pos)
            self.results = self.potential.calculate(self.atoms_list)
            v = v + 0.5 * self.dt * self._forces() * inv_m
            if self.ensemble == "nvt_berendsen":
                self._scatter("velocities", v)
                t = np.maximum(self.temperatures(), 1e-12)
                lam = np.sqrt(1.0 + (self.dt / self.taut) * (self.t_target / t - 1.0))
                v = v * np.clip(lam, 0.9, 1.1)[self.sid, None]
        self._scatter("velocities", v)
        self.nsteps += 1

    def run(self, steps: int) -> list:
        """Advance the whole batch ``steps`` steps; returns the final
        per-structure result dicts."""
        for _ in range(steps):
            self.step()
        return self.results
