"""Potential runtime: energy, then forces and stress by autograd.

Builds ``(params, graph, positions) -> dict(energy, forces, stress)`` from a
model's energy function (``distmlip_tpu/parallel/runtime.py:114``
``make_total_energy`` and ``:244`` ``make_potential_fn``). Forces and
stress come from ONE ``torch.autograd.grad`` over the positions and a zero
symmetric strain: forces = -dE/dx, stress = (dE/deps) / |det L| in eV/Å^3
(ASE sign).

The partition count comes from the graph. At P > 1 the P partitions run
as one flattened graph on one device (``parallel/halo.py``), so the
factories take no device mesh, where the JAX package's take one: the
positions (P, N_cap, 3) are flattened, strained and
halo-exchanged before the model (the JAX runtime's ``:157``), and the
gradient flows back through the exchange to each atom's owner row.

``make_batched_potential_fn`` is the batched counterpart
(``distmlip_tpu/parallel/runtime.py:421``, ``mesh=None``): per-structure
energies, forces and strain gradients of a block-diagonally packed batch
(``partition/batch.py``) from one autograd pass. ``make_packed_energy_fn``
(``:290``) is the same energy program with nothing detached, for the
training loss.

Model contract:
    model_energy_fn(params, lg: LocalGraph, positions) -> per-atom energies
with shape (lg.n_cap,); padded and halo rows may hold anything: the runtime
sums owned rows only. With ``aux=True`` the model returns ``(e_atoms,
aux)``, a dict of per-atom outputs of the same forward (CHGNet's magmoms);
they come back as (P, N_cap, ...), and the forces come from the energy
alone.
"""

from __future__ import annotations

import torch

from ..geometry import apply_strain
from .halo import local_graph_from_stacked


def make_total_energy(model_energy_fn, *, kernels: bool = True, aux: bool = False):
    """Total-energy fn: (params, graph, positions, strain) -> scalar, or
    (scalar, aux dict of (P, N_cap, ...) tensors) with ``aux=True``.

    ``positions`` is (P, N_cap, 3); only owned rows are read, halo rows are
    refreshed by the halo exchange. ``strain`` is a (3, 3) symmetric strain
    applied to positions and lattice (for stress).
    """

    def total_energy(params, graph, positions, strain):
        lg = local_graph_from_stacked(graph, kernels=kernels)
        dtype = positions.dtype
        P, n_cap = positions.shape[:2]
        pos, lg.lattice = apply_strain(
            positions.reshape(P * n_cap, 3), lg.lattice.to(dtype), strain.to(dtype))
        pos = lg.halo_exchange(pos)
        out = model_energy_fn(params, lg, pos)
        if aux:
            e_atoms, aux_out = out
            return (lg.owned_sum(e_atoms.reshape(-1, 1)),
                    {k: x.reshape((P, n_cap) + tuple(x.shape[1:]))
                     for k, x in aux_out.items()})
        return lg.owned_sum(out.reshape(-1, 1))

    return total_energy


def make_potential_fn(model_energy_fn, *, compute_stress: bool = True, kernels: bool = True,
                      aux: bool = False):
    """(params, graph, positions) -> dict(energy, forces, stress).

    forces: (P, N_cap, 3) — per-partition owned rows (reassemble with
    HostGraphData.gather_owned); stress: (3, 3) in eV/Å^3, dE/deps / V.
    Parameters are not differentiated (the force/stress program). With
    ``aux=True`` (the fused site readout) the model returns ``(e_atoms,
    aux)`` and the result gains ``"aux"``: its (P, N_cap, ...) per-atom
    outputs from the SAME forward.
    """
    total_energy = make_total_energy(model_energy_fn, kernels=kernels, aux=aux)

    def potential(params, graph, positions):
        positions = positions.detach().requires_grad_(True)
        strain = torch.zeros((3, 3), dtype=positions.dtype,
                             device=positions.device,
                             requires_grad=compute_stress)
        with torch.enable_grad():
            energy = total_energy(params, graph, positions, strain)
            if aux:
                energy, aux_out = energy
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
        out = {"energy": energy.detach(), "forces": -g_pos, "stress": stress}
        if aux:
            out["aux"] = {k: x.detach() for k, x in aux_out.items()}
        return out

    return potential


def _packed_energy(model_energy_fn, *, kernels: bool, aux: bool):
    """``(params, graph, positions, strain) -> (energies, aux_out)`` over a
    packed batch: per-structure energies (batch_size,) with every input's
    graph kept (positions, strain and the parameters), the body of
    ``make_batched_potential_fn`` and ``make_packed_energy_fn``."""

    def packed_energy(params, graph, positions, strain):
        if graph.num_partitions != 1 or graph.batch_size < 1 or graph.struct_id is None:
            raise ValueError(
                "a packed energy requires a single-partition packed graph (got "
                f"P={graph.num_partitions}, batch_size={graph.batch_size}); build it "
                "with pack_structures()")
        lg = local_graph_from_stacked(graph, kernels=kernels)
        dtype = positions.dtype
        B = graph.batch_size
        # padded rows carry the sentinel slot B: clamp it onto the last slot
        # for the gathers below (those rows are masked everywhere)
        sid = torch.clamp(lg.struct_id.long(), max=B - 1)
        sym = 0.5 * (strain + strain.transpose(-1, -2)).to(dtype)
        defm = torch.eye(3, dtype=dtype, device=positions.device)[None] + sym
        pos = torch.einsum("ni,nij->nj", positions[0], defm.index_select(0, sid))
        esid = sid.index_select(0, lg.edge_dst.long())
        lg.edge_offset = torch.einsum("ei,eij->ej", lg.edge_offset.to(dtype),
                                      defm.index_select(0, esid))
        lg.lattice = None
        out = model_energy_fn(params, lg, pos)
        e_atoms, aux_out = out if aux else (out, None)
        return lg.structure_sum(e_atoms.reshape(-1).to(dtype)), aux_out

    return packed_energy


def make_packed_energy_fn(model_energy_fn, *, kernels: bool = True):
    """Per-structure energies of a packed batch with the parameters
    differentiable (``distmlip_tpu/parallel/runtime.py:290-325``, the
    ``mesh=None`` path): ``(params, graph, positions, strain) ->
    (batch_size,)``.

    ``graph`` is a ``pack_structures`` graph of tensors, ``positions``
    (1, N_cap, 3) and ``strain`` the per-structure (batch_size, 3, 3)
    symmetric strain. Nothing is detached: the training loss
    (``train/step.py``) takes the force and strain gradients with
    ``create_graph=True`` and then the parameter gradient through them. A
    graph with P > 1 raises, as the batched potential does."""
    body = _packed_energy(model_energy_fn, kernels=kernels, aux=False)

    def packed_energy(params, graph, positions, strain):
        return body(params, graph, positions, strain)[0]

    return packed_energy


def make_batched_potential_fn(model_energy_fn, *, compute_stress: bool = True,
                              aux: bool = False, mesh=None, kernels: bool = True):
    """(params, graph, positions) -> dict over a packed batch
    (``distmlip_tpu/parallel/runtime.py:362-558``, the single-device path).

    ``graph`` is a ``PartitionedGraph`` of tensors from
    ``partition.pack_structures`` (``batch_size`` slots, ``struct_id`` per
    node row, Cartesian edge offsets, identity lattice); ``positions`` is
    (1, N_cap, 3). Each structure b gets its own symmetric strain eps_b:
    its rows x -> x (I + eps_b), and each edge's Cartesian offset deforms
    with its dst row's structure (the offsets carry the cell, so no lattice
    is applied on top: the LocalGraph's lattice is set to None). Returns

    - ``energies``: (batch_size,) per-structure energies, one
      ``structure_sum`` of the per-atom energies (empty slots read 0);
    - ``forces``: (1, N_cap, 3) from ONE autograd pass through the whole
      batch; the blocks share no edge, so d(sum_b E_b)/dx_i is
      dE_{b(i)}/dx_i exactly;
    - ``strain_grad``: (batch_size, 3, 3) dE_b/deps_b (zeros without
      ``compute_stress``); the caller divides by each structure's volume;
    - ``aux`` with ``aux=True``: the model's per-atom outputs as
      (1, N_cap, ...).

    ``mesh`` other than None (the 2-D batch x spatial placement) raises:
    ROADMAP.md item A7.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_batched_potential_fn(mesh=...): the 2-D (batch x spatial) mesh "
            "placement is not ported (ROADMAP.md A7); the batched engine runs on one "
            "device")
    batched_energy = _packed_energy(model_energy_fn, kernels=kernels, aux=aux)

    def potential(params, graph, positions):
        positions = positions.detach().requires_grad_(True)
        strain = torch.zeros((graph.batch_size, 3, 3), dtype=positions.dtype,
                             device=positions.device, requires_grad=compute_stress)
        with torch.enable_grad():
            energies, aux_out = batched_energy(params, graph, positions, strain)
            inputs = [positions, strain] if compute_stress else [positions]
            grads = torch.autograd.grad(energies.sum(), inputs)
        out = {"energies": energies.detach(), "forces": -grads[0],
               "strain_grad": grads[1] if compute_stress else torch.zeros_like(strain)}
        if aux:
            out["aux"] = {k: x.detach().reshape((1,) + tuple(x.shape))
                          for k, x in aux_out.items()}
        return out

    return potential
