"""Potential runtime: energy, then forces and stress by autograd.

Builds ``(params, graph, positions) -> dict(energy, forces, stress)`` from a
model's per-shard energy function (``distmlip_tpu/parallel/runtime.py:114``
``make_total_energy``, its ``mesh is None`` branch, and ``:244``
``make_potential_fn``). Forces and stress come from ONE
``torch.autograd.grad`` over the positions and a zero symmetric strain:
forces = -dE/dx, stress = (dE/deps) / |det L| in eV/Å^3 (ASE sign).

Model contract:
    model_energy_fn(params, lg: LocalGraph, positions) -> per-atom energies
with shape (N_cap,); padded rows may hold garbage — the runtime masks them.
"""

from __future__ import annotations

import torch

from ..geometry import apply_strain
from .halo import local_graph_from_stacked


def make_total_energy(model_energy_fn, mesh=None, kernels: bool = True):
    """Total-energy fn: (params, graph, positions, strain) -> scalar.

    ``positions`` is (P, N_cap, 3); ``strain`` a (3, 3) symmetric strain
    applied to positions and lattice (for stress). Only ``mesh=None`` (a
    single-partition graph) is ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is ROADMAP.md queue A item 'P>1 graph parallelism'")

    def total_energy(params, graph, positions, strain):
        lg = local_graph_from_stacked(graph, kernels=kernels)
        dtype = positions.dtype
        pos, lg.lattice = apply_strain(
            positions[0], lg.lattice.to(dtype), strain.to(dtype))
        pos = lg.halo_exchange(pos)
        out = model_energy_fn(params, lg, pos)
        return lg.owned_sum(out.reshape(-1, 1))

    return total_energy


def make_potential_fn(model_energy_fn, mesh=None, compute_stress: bool = True,
                      kernels: bool = True):
    """(params, graph, positions) -> dict(energy, forces, stress).

    forces: (P, N_cap, 3) — per-partition owned rows (reassemble with
    HostGraphData.gather_owned); stress: (3, 3) in eV/Å^3, dE/deps / V.
    Parameters are not differentiated (the force/stress program).
    """
    total_energy = make_total_energy(model_energy_fn, mesh, kernels=kernels)

    def potential(params, graph, positions):
        positions = positions.detach().requires_grad_(True)
        strain = torch.zeros((3, 3), dtype=positions.dtype,
                             device=positions.device,
                             requires_grad=compute_stress)
        with torch.enable_grad():
            energy = total_energy(params, graph, positions, strain)
            inputs = [positions, strain] if compute_stress else [positions]
            grads = torch.autograd.grad(energy, inputs)
        if compute_stress:
            g_pos, g_strain = grads
            lat = graph.lattice
            vol = torch.abs(torch.linalg.det(
                lat if lat.dtype == torch.float64 else lat.to(positions.dtype)))
            stress = g_strain / vol
        else:
            g_pos = grads[0]
            stress = torch.zeros((3, 3), dtype=positions.dtype,
                                 device=positions.device)
        return {"energy": energy.detach(), "forces": -g_pos, "stress": stress}

    return potential
