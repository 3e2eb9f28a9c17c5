"""Uncertainty on the serving path: the batched ensemble evaluator
(``distmlip_tpu/active/uncertainty.py``).

``EnsembleBatchedPotential`` is a :class:`~distmlip_tpu_torch.calculators.
batched.BatchedPotential` whose ``calculate`` serves the PRIMARY member's
weights exactly as before (the cheap path every request rides), plus a
``calculate_with_variance`` that evaluates the same packed batch under ALL
members: it prepares ONE packed graph and the positions through the
potential's ``_prepare_batch`` (so it shares the skin cache: a variance call
right after a serve of the same batch adds no rebuild), runs each member's
parameters through the one force program in a host loop, with no host sync
between members, and copies the members' stacks back in one device-to-host
copy. This is ``EnsemblePotential``'s stacked route
(``calculators/calculator.py``); the JAX package vmaps the members into one
program instead. The port does not use ``torch.func.vmap``: the kernels'
``autograd.Function``s have no vmap rule.

The cheap-first escalation policy lives in :class:`EscalationPolicy`:
serve the single model always; re-evaluate under the ensemble only when
a sampling policy fires or the caller opts in (``ActiveLoop.submit(...,
escalate=True)``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..calculators.atoms import EV_A3_TO_GPA
from ..calculators.batched import BatchedPotential, batch_timings, device_turn
from ..calculators.calculator import _check_same_tree, atoms_system, validate_system
from ..kernels.dispatch import kernel_routing, route_counts
from ..telemetry import annotate
from .hotswap import check_swappable, device_copy, install_params


@dataclass
class EscalationPolicy:
    """When a served request is re-evaluated under the ensemble, and when
    a re-evaluated structure is admitted to the replay buffer.

    ``sample_rate`` is the fraction of served requests escalated by the
    sampling policy (callers can always force/suppress escalation per
    request). ``energy_var_floor`` / ``force_var_floor`` gate buffer
    admission: a structure lands in the buffer when its ensemble energy
    variance (eV², per structure) or max per-component force variance
    ((eV/Å)²) reaches its floor — both 0 admits every escalated
    structure. ``max_pending`` bounds the escalation queue (oldest
    dropped first; the loop counts drops)."""

    sample_rate: float = 0.0
    energy_var_floor: float = 0.0
    force_var_floor: float = 0.0
    max_pending: int = 1024

    def admits(self, energy_var: float, force_var_max: float) -> bool:
        if self.energy_var_floor <= 0.0 and self.force_var_floor <= 0.0:
            return True
        return (0.0 < self.energy_var_floor <= energy_var
                or 0.0 < self.force_var_floor <= force_var_max)


def variance_score(result: dict) -> float:
    """The scalar priority the buffer/trigger machinery ranks by: the max
    per-component force variance, falling back to the energy variance for
    empty structures."""
    fv = np.asarray(result.get("forces_var", 0.0))
    if fv.size:
        return float(fv.max())
    return float(result.get("energy_var", 0.0))


class EnsembleBatchedPotential(BatchedPotential):
    """Batched potential with an M-member uncertainty lane.

    ``params_list[0]`` is the PRIMARY (serving) member: ``calculate``
    behaves exactly like a ``BatchedPotential`` over those weights, so a
    ``ServeEngine`` can use this object as its shared potential with no
    behavior change. ``calculate_with_variance`` evaluates every member
    over the same packed graph (module docstring) and returns per-structure
    mean/variance plus the per-member stacks. The member trees (tensors or
    numpy) must have the primary's keys, shapes and dtypes.

    ``set_primary`` is the hot-swap hook: a pure swap of the serving
    weights (member 0), refused for any tree whose structure, shapes or
    dtypes differ from the live one.
    """

    def __init__(self, model, params_list, **kwargs):
        params_list = list(params_list)
        if not params_list:
            raise ValueError("params_list must be non-empty")
        super().__init__(model, params_list[0], **kwargs)
        self.member_count = len(params_list)
        members = [self.params] + [device_copy(p, self.device) for p in params_list[1:]]
        for i, p in enumerate(members[1:], 1):
            _check_same_tree(self.params, p, f"params_list[{i}]")
        self._members = members

    # ---- member management ----

    def member_params(self, k: int):
        """Member ``k``'s parameter tree (on the potential's device)."""
        if not 0 <= k < self.member_count:
            raise IndexError(f"member {k} outside [0, {self.member_count})")
        return self._members[k]

    def set_primary(self, new_params) -> None:
        """Install new PRIMARY weights (member 0) as a pure swap, copied
        onto the potential's device. Thread-safe against a concurrent
        ``calculate`` or ``calculate_with_variance`` (the same lock)."""
        check_swappable(self.params, new_params)
        with self._lock:
            install_params(self, new_params)
            self._members[0] = self.params

    # ---- the uncertainty lane ----

    def calculate_with_variance(self, structures) -> list:
        """Evaluate the batch under EVERY member over one packed graph.

        Returns one dict per input structure: ensemble-mean ``energy`` /
        ``forces`` / ``stress`` (same keys ``calculate`` produces), plus
        ``energy_var``, ``forces_var`` (per-atom, per-component),
        ``energies`` (M,), ``forces_all`` (M, n, 3) and
        ``committee_energy``/``committee_forces`` — the mean over the
        NON-primary members, the label an active-learning buffer wants
        when the primary itself is the model being corrected (the full
        mean for M == 1)."""
        structures = list(structures)
        if not structures:
            return []
        with self._lock:
            return self._variance_locked(structures)

    def _members_on_device(self, structures, plan):
        """The device phase (the caller holds the device lock): one packed
        graph, every member through the force program, one copy back."""
        graph, host, positions, reused, refreshed, rebuild_s, times = \
            self._prepare_batch(structures, plan)
        routes = dict(route_counts) if self.telemetry is not None else None
        with annotate("distmlip/ensemble_batched"):
            outs = [self._potential(p, graph, positions) for p in self._members]
            parts = [(k, outs[0][k]) for k in ("energies", "forces", "strain_grad")]
            # one stack, one device-to-host copy (float64 holds every member
            # value exactly)
            block = torch.stack([torch.cat([o[k].reshape(-1).to(torch.float64)
                                            for k, _ in parts]) for o in outs]).cpu().numpy()
        shapes = [(k, tuple(t.shape)) for k, t in parts]
        del outs, parts, graph, positions
        return host, reused, refreshed, rebuild_s, times, routes, block, shapes

    def _variance_locked(self, structures) -> list:
        validate_system(self.model.cfg, atoms_system(structures[0]))
        plan = self._plan_batch(structures)
        with device_turn(self.device) as wait_s:
            host, reused, refreshed, rebuild_s, (t0, t1, t2), routes, block, shapes = \
                self._members_on_device(structures, plan)
        M = self.member_count
        got, start = {}, 0
        for k, shape in shapes:
            size = int(np.prod(shape))
            got[k] = block[:, start:start + size].reshape((M,) + shape)
            start += size
        slots = host.structure_slots
        energies = got["energies"][:, slots]
        strain_grad = got["strain_grad"][:, slots].astype(np.float32)
        forces_by_member = [host.gather_per_structure(got["forces"][k].astype(np.float32))
                            for k in range(M)]
        results = []
        for b in range(len(structures)):
            f_all = np.stack([forces_by_member[k][b] for k in range(M)])
            e_all = energies[:, b]
            vol = max(host.volumes[b], 1e-30)
            s_all = strain_grad[:, b] / vol
            stress = s_all.mean(axis=0)
            res = {
                "energy": float(e_all.mean()),
                "free_energy": float(e_all.mean()),
                "forces": f_all.mean(axis=0),
                "stress": stress,
                "stress_GPa": stress * EV_A3_TO_GPA,
                "energy_var": float(e_all.var()),
                "forces_var": f_all.var(axis=0),
                "energies": e_all,
                "forces_all": f_all,
            }
            if M > 1:
                res["committee_energy"] = float(e_all[1:].mean())
                res["committee_forces"] = f_all[1:].mean(axis=0)
            else:
                res["committee_energy"] = res["energy"]
                res["committee_forces"] = res["forces"]
            results.append(res)
        t3 = time.perf_counter()
        self.last_timings = batch_timings(t0, t1, t2, t3, rebuild_s if refreshed else None,
                                          wait_s)
        self.last_stats = dict(host.stats or {})
        self.last_stats.update(
            batch_size=len(structures), member_count=M,
            rebuild_count=int(not reused), rebuild_on_device=int(refreshed),
            rebuild_overflow_count=self.rebuild_overflow_count)
        if self.telemetry is not None:
            kernel_mode, kernel_coverage = kernel_routing(routes)
            self.last_stats.update(kernel_mode=kernel_mode, kernel_coverage=kernel_coverage)
            self._emit_record(host, len(structures), reused, refreshed, t3 - t0,
                              kind="ensemble_batched", member_count=M)
        else:
            self._step_counter += 1
        return results
