"""The single-structure training surface (``distmlip_tpu/train/legacy.py``).

The loss differentiates through the same potential the calculators run,
halo exchange included: at P > 1 the P partitions run as one flattened
graph (``parallel/halo.py``), the gradient flows back through the exchange
to each atom's owner row, and the parameter gradient sums over the
partitions. The factories take no mesh, as the port's
``make_potential_fn`` takes none: P comes from the graph.

In PyTorch's idiom the optimizer is a ``torch.optim.Optimizer`` built over
``train.step.param_leaves(params)`` and updated in place: a step returns
the loss, where the JAX step returns ``(params, opt_state, loss)``.
``stack_graphs`` checks that the graphs share their shapes and returns
them as a list (the batched step loops over it, where the JAX one vmaps);
``stack_targets`` stacks the target tensors along a leading axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.runtime import make_total_energy
from ..partition.graph import ARRAY_FIELDS
from .checkpoint import load_optimizer_payload, optimizer_payload
from .step import param_leaves


def make_loss_fn(model_energy_fn, w_energy=1.0, w_force=1.0, w_stress=0.0, *,
                 kernels: bool = True):
    """Loss: ``(params, graph, positions, targets) -> scalar``
    (``distmlip_tpu/train/legacy.py:26-58``).

    ``targets``: ``energy`` (), ``forces`` (P, N_cap, 3) in the graph's
    layout, optional ``stress`` (3, 3). Forces are compared on owned rows
    only; the energy term is per atom squared over the graph's owned
    atoms."""
    total_energy = make_total_energy(model_energy_fn, kernels=kernels)

    def loss_fn(params, graph, positions, targets):
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(w_force > 0.0 or w_stress > 0.0)
            strain = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                                 requires_grad=w_force > 0.0 or w_stress > 0.0)
            energy = total_energy(params, graph, pos, strain)
            if w_force > 0.0 or w_stress > 0.0:
                g_pos, g_strain = torch.autograd.grad(energy, [pos, strain],
                                                      create_graph=True)
        n_atoms = torch.clamp(graph.owned_mask.sum().to(energy.dtype), min=1.0)
        loss = w_energy * ((energy - targets["energy"]) / n_atoms) ** 2
        if w_force > 0.0:
            mask = graph.owned_mask[..., None]
            diff = torch.where(mask, -g_pos - targets["forces"], 0.0)
            loss = loss + w_force * torch.sum(diff ** 2) / (3.0 * n_atoms)
        if w_stress > 0.0:
            lat = graph.lattice.to(energy.dtype)
            stress = g_strain / torch.abs(torch.linalg.det(lat))
            loss = loss + w_stress * torch.mean((stress - targets["stress"]) ** 2)
        return loss

    return loss_fn


def _apply(optimizer, params, loss):
    leaves = param_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p, g in zip(leaves, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def make_train_step(model_energy_fn, optimizer, w_energy=1.0, w_force=1.0, w_stress=0.0, *,
                    kernels: bool = True):
    """``step(params, graph, positions, targets) -> loss``: the loss, its
    parameter gradient and one ``optimizer.step()`` (``optimizer`` built
    over ``param_leaves(params)``; ``distmlip_tpu/train/legacy.py:61-77``)."""
    loss_fn = make_loss_fn(model_energy_fn, w_energy, w_force, w_stress, kernels=kernels)

    def step(params, graph, positions, targets):
        return _apply(optimizer, params, loss_fn(params, graph, positions, targets))

    return step


def stack_graphs(graphs):
    """Same-shape PartitionedGraphs as one batch (a list). Graphs with
    other capacities (build them with one CapacityPolicy) or another
    partition count raise."""
    graphs = list(graphs)
    sigs = {(g.num_partitions,) + tuple(
        tuple(np.shape(getattr(g, f))) for f in ARRAY_FIELDS if getattr(g, f) is not None)
        for g in graphs}
    if len(sigs) != 1:
        raise ValueError(
            "graphs have mixed array shapes (different capacity buckets); build them "
            "with a shared CapacityPolicy so they land in one bucket: "
            f"{sorted(sigs)[:2]} ...")
    return graphs


def stack_targets(targets):
    """Per-structure target dicts -> one dict of tensors stacked along a
    leading batch axis."""
    return {k: torch.stack([torch.as_tensor(t[k]) for t in targets]) for k in targets[0]}


def _batch_loss(loss_fn, params, graphs, positions, targets):
    per = [loss_fn(params, g, positions[i], {k: v[i] for k, v in targets.items()})
           for i, g in enumerate(graphs)]
    return torch.stack(per).mean()


def make_batched_train_step(model_energy_fn, optimizer, w_energy=1.0, w_force=1.0,
                            w_stress=0.0, *, kernels: bool = True):
    """``step(params, graphs, positions, targets) -> loss`` over a batch:
    the mean of the per-structure losses (``stack_graphs`` /
    ``stack_targets``; ``positions`` (B, P, N_cap, 3)), one update
    (``distmlip_tpu/train/legacy.py:117-142``)."""
    loss_fn = make_loss_fn(model_energy_fn, w_energy, w_force, w_stress, kernels=kernels)

    def step(params, graphs, positions, targets):
        return _apply(optimizer, params,
                      _batch_loss(loss_fn, params, graphs, positions, targets))

    return step


def make_eval_fn(model_energy_fn, w_energy=1.0, w_force=1.0, w_stress=0.0, *,
                 kernels: bool = True):
    """``(params, graphs, positions, targets) -> mean loss`` over a stacked
    validation batch, no parameter gradient."""
    loss_fn = make_loss_fn(model_energy_fn, w_energy, w_force, w_stress, kernels=kernels)

    def evaluate(params, graphs, positions, targets):
        return _batch_loss(loss_fn, params, graphs, positions, targets).detach()

    return evaluate


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """One npz with ``params``, the optimizer state (``opt_state``: a
    ``torch.optim.Optimizer``) and the step, in ``utils.checkpoint``'s
    layout."""
    from ..utils.checkpoint import save_params

    save_params(path, {"params": params, "optimizer": optimizer_payload(opt_state),
                       "step": np.int64(step)})


def load_train_state(path: str, params_like, opt_state_like):
    """Restore what ``save_train_state`` wrote INTO the caller's tensors:
    the weights are copied in place into ``params_like``'s leaves (on
    their device, ``requires_grad`` kept) and the optimizer state is
    loaded into ``opt_state_like`` (an optimizer over those leaves), so the
    next step continues the saved run. Returns ``(params_like,
    opt_state_like, step)``."""
    from ..utils.checkpoint import load_params

    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    loaded = load_params(path, like={"params": params_like})["params"]
    with torch.no_grad():
        for dst, src in zip(param_leaves(params_like), param_leaves(loaded)):
            dst.copy_(src)
    load_optimizer_payload(opt_state_like, data)
    return params_like, opt_state_like, int(data["step"])
