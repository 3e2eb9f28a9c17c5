"""The accumulated mixed-precision train step over packed batches
(``distmlip_tpu/train/step.py``).

One optimizer step over ``accum_steps`` packed micro-batches:

- **packed loss** (:func:`make_packed_loss_fn`) — energy, force and
  stress matching against a block-diagonally packed micro-batch through
  ``parallel.make_packed_energy_fn``: one forward of the per-structure
  energies, one ``torch.autograd.grad`` over the positions (and the strain
  when stress trains) with ``create_graph=True`` for forces and stress,
  then the parameter gradient through both. The normalisation is the JAX
  package's term for term: energy per atom squared, forces over owned rows
  per 3n, stress over 9, each averaged over the real structures;
- **master weights** — fp32 copies of the parameters, leaf tensors with
  ``requires_grad``. ``precision="bf16"`` pairs with a model built with
  ``dtype="bfloat16"``, whose own ``keep_fp32`` casts run per forward (a
  differentiable ``.to``); the master weights, gradients and optimizer
  state stay fp32. On the step side the knob picks the loss-scale default
  (2^15);
- **dynamic loss scaling** — the loss is scaled before its backward and
  the gradients unscaled after accumulation. A non-finite global gradient
  norm skips the update: parameters, optimizer state and its step count,
  scheduler, EMA and the applied-step count stay as they were, and the
  scale halves; ``scale_growth_interval`` finite steps in a row double it,
  up to its cap. The finite flag is the one value read on the host a step;
- **gradient accumulation** — a loop over the micro-batches with fp32
  gradient sums, so accumulation N at micro-batch B matches the N B batch
  to fp32 roundoff;
- **clipping** — ``clip_norm`` scales the whole gradient before the
  optimizer;
- **EMA** — an exponential moving average of the master weights over the
  applied steps, the eval weight set.

The optimizer is a factory, ``params -> torch.optim.Optimizer`` (for
example ``functools.partial(torch.optim.Adam, lr=1e-3)``), in place of an
optax transformation; a schedule is a factory ``optimizer ->
torch.optim.lr_scheduler.LRScheduler``. An explicit ``torch.Generator``
replaces the PRNG key. ZeRO-1 needs a process group over several cards
(ROADMAP.md A4): ``zero1="auto"`` resolves to off and ``zero1=True``
raises, as the JAX package does without a batch mesh.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..parallel.runtime import make_packed_energy_fn


@dataclass(frozen=True)
class TrainConfig:
    """Knobs of the accumulated step (``distmlip_tpu/train/step.py:67``)."""

    w_energy: float = 1.0
    w_force: float = 1.0
    w_stress: float = 0.0
    precision: str = "fp32"          # "fp32" | "bf16" compute (master fp32)
    accum_steps: int = 1             # micro-batches per optimizer step
    clip_norm: float = 0.0           # global-norm clip; 0 disables
    ema_decay: float = 0.999         # EMA of master weights; 0 disables
    zero1: Any = "auto"              # True | False | "auto" (off on one card)
    loss_scale: float | None = None  # None: 2**15 for bf16, 1.0 for fp32
    scale_growth_interval: int = 2000
    scale_factor: float = 2.0
    max_loss_scale: float = 2.0 ** 24
    min_loss_scale: float = 2.0 ** -14

    def __post_init__(self):
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(
                f"precision must be 'fp32' or 'bf16', got {self.precision!r}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")

    @property
    def initial_loss_scale(self) -> float:
        if self.loss_scale is not None:
            return float(self.loss_scale)
        return 2.0 ** 15 if self.precision == "bf16" else 1.0


@dataclass
class TrainState:
    """The resumable optimizer-step state. The step updates it in place;
    ``train/checkpoint.py`` saves and restores all of it but the two
    factories."""

    params: Any                # fp32 master weights (leaf tensors, requires_grad)
    optimizer: Any             # torch.optim.Optimizer over param_leaves(params)
    scheduler: Any             # lr scheduler or None
    step: int                  # APPLIED optimizer steps
    ema_params: Any            # EMA of the master weights (params itself when off)
    loss_scale: float          # dynamic loss scale
    good_steps: int            # finite steps since the last scale change
    rng: torch.Generator       # reserved for stochastic models; advanced each step
    optimizer_factory: Callable = None
    scheduler_factory: Callable | None = None


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict/list/tuple tree (``None``
    leaves kept), the structure unchanged."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in path order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def param_leaves(params) -> list:
    """The trainable leaves: floating tensors, in path order."""
    return [p for p in tree_leaves(params)
            if isinstance(p, torch.Tensor) and p.is_floating_point()]


def _single_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: training over a device mesh is not ported (ROADMAP.md A4); the "
            "port trains on one card")


def resolve_zero1(config: TrainConfig, mesh=None) -> bool:
    """ZeRO-1 optimizer-state sharding (``distmlip_tpu/train/step.py:
    107-130``) needs a batch axis over several cards, which the port does
    not have (ROADMAP.md A4): ``"auto"`` and False resolve to off;
    ``zero1=True`` raises, as the JAX package raises without a batch
    mesh."""
    _single_card(mesh)
    if config.zero1 != "auto" and config.zero1:
        raise ValueError(
            "zero1=True needs a batch axis over several cards to shard the optimizer "
            "state over (ROADMAP.md A4); leave zero1='auto' on one card")
    return False


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def make_packed_loss_fn(model_energy_fn, mesh=None, config: TrainConfig = TrainConfig(),
                        kernels: bool = True):
    """Loss over ONE packed micro-batch (``distmlip_tpu/train/step.py:
    137-230``).

    ``(params, graph, targets, create_graph=True) -> (loss, components)``
    where ``graph`` is a ``pack_structures`` graph of tensors on the
    parameters' device and ``targets`` the matching
    ``train.data.pack_targets`` dict of tensors. ``components`` holds the
    fp32 scalars ``loss``, ``energy``, ``force`` and ``stress`` (detached).
    Forces and strain gradients come from one ``torch.autograd.grad`` of
    the energies' sum over the positions (when ``w_force > 0``) and the
    strain (when ``w_stress > 0``), with ``create_graph`` so the loss
    differentiates through them; ``create_graph=False`` is the evaluation
    pass (no parameter gradient)."""
    _single_card(mesh)
    energy_fn = make_packed_energy_fn(model_energy_fn, kernels=kernels)
    w_e, w_f, w_s = float(config.w_energy), float(config.w_force), float(config.w_stress)

    def loss_fn(params, graph, targets, create_graph: bool = True):
        f32 = torch.float32
        B_total = graph.batch_size
        if w_s > 0.0 and "stress" not in targets:
            raise ValueError(
                "w_stress > 0 but the batch carries no stress targets (give every "
                "Sample a stress, or set w_stress=0)")
        with torch.enable_grad():
            positions = graph.positions.detach().requires_grad_(w_f > 0.0)
            strain0 = torch.zeros((B_total, 3, 3), dtype=positions.dtype,
                                  device=positions.device, requires_grad=w_s > 0.0)
            # master weights pass through uncast: a bf16 model casts them
            # per forward under its own keep_fp32 list
            energies = energy_fn(params, graph, positions, strain0)
            inputs = [x for x, on in ((positions, w_f > 0.0), (strain0, w_s > 0.0)) if on]
            grads = (torch.autograd.grad(energies.sum(), inputs, create_graph=create_graph)
                     if inputs else ())
        g_pos = grads[0] if w_f > 0.0 else None
        g_strain = grads[-1] if w_s > 0.0 else None

        struct_mask = targets["struct_mask"].to(f32)
        n_real = torch.clamp(struct_mask.sum(), min=1.0)
        n_atoms = targets["n_atoms"].to(f32)
        e_diff = (energies.to(f32) - targets["energy"].to(f32)) / n_atoms
        e_term = torch.sum(struct_mask * e_diff * e_diff) / n_real
        zero = torch.zeros((), dtype=f32, device=e_term.device)
        f_term = s_term = zero
        if w_f > 0.0:
            # owned real rows carry their structure's slot; padded rows the
            # B_total sentinel -> weight 0
            slot = targets["atom_slot"].long()
            owned = slot < B_total
            n_ext = torch.cat([n_atoms, torch.ones((1,), dtype=f32, device=n_atoms.device)])
            w_atom = torch.where(owned, 1.0 / (3.0 * n_ext[slot]), 0.0)
            d = (-g_pos).to(f32) - targets["forces"].to(f32)
            f_term = torch.sum(w_atom[..., None] * d * d) / n_real
        if w_s > 0.0:
            stress = g_strain.to(f32) * targets["inv_volume"].to(f32)[:, None, None]
            ds = stress - targets["stress"].to(f32)
            s_term = torch.sum(struct_mask[:, None, None] * ds * ds) / (9.0 * n_real)
        loss = w_e * e_term + w_f * f_term + w_s * s_term
        comps = {"loss": loss.detach(), "energy": e_term.detach(),
                 "force": f_term.detach(), "stress": s_term.detach()}
        return loss, comps

    return loss_fn


def _master_copy(params, device=None):
    """fp32 leaf copies of the floating leaves (``requires_grad``), other
    leaves copied as they are; on ``device`` when given."""
    def leaf(x):
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        x = x.detach().to(device if device is not None else x.device)
        if x.is_floating_point():
            return x.to(torch.float32).clone().requires_grad_(True)
        return x.clone()

    return tree_map(leaf, params)


def init_train_state(optimizer, params, mesh=None, config: TrainConfig = TrainConfig(),
                     seed: int = 0, *, scheduler=None, device=None) -> TrainState:
    """Fresh state (``distmlip_tpu/train/step.py:233-267``): fp32 master
    copies of ``params`` (on ``device``, default the leaves' own), the
    optimizer ``optimizer(param_leaves(master))``, the scheduler
    ``scheduler(optimizer)`` when given, the EMA mirror, the initial loss
    scale and ``torch.Generator().manual_seed(seed)``."""
    resolve_zero1(config, mesh)
    master = _master_copy(params, device)
    opt = optimizer(param_leaves(master))
    ema = (tree_map(lambda x: x.detach().clone(), master) if config.ema_decay > 0.0
           else master)
    return TrainState(
        params=master, optimizer=opt,
        scheduler=scheduler(opt) if scheduler is not None else None,
        step=0, ema_params=ema, loss_scale=float(config.initial_loss_scale), good_steps=0,
        rng=torch.Generator().manual_seed(int(seed)), optimizer_factory=optimizer,
        scheduler_factory=scheduler)


def clone_state(state: TrainState) -> TrainState:
    """An independent copy: new master leaves, an optimizer from the factory
    with a deep copy of the state dict, the scheduler likewise, the EMA and
    generator copied."""
    master = _master_copy(state.params)
    opt = state.optimizer_factory(param_leaves(master))
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    sched = None
    if state.scheduler is not None:
        sched = state.scheduler_factory(opt)
        sched.load_state_dict(copy.deepcopy(state.scheduler.state_dict()))
    ema = (master if state.ema_params is state.params
           else tree_map(lambda x: x.detach().clone(), state.ema_params))
    rng = torch.Generator()
    rng.set_state(state.rng.get_state())
    return TrainState(params=master, optimizer=opt, scheduler=sched, step=state.step,
                      ema_params=ema, loss_scale=state.loss_scale,
                      good_steps=state.good_steps, rng=rng,
                      optimizer_factory=state.optimizer_factory,
                      scheduler_factory=state.scheduler_factory)


def make_accum_train_step(model_energy_fn, mesh=None, config: TrainConfig = TrainConfig(),
                          kernels: bool = True):
    """The accumulated step (``distmlip_tpu/train/step.py:317-421``).

    ``step(state, graphs, targets) -> (state, metrics)``: ``graphs`` and
    ``targets`` are the micro-batches of one optimizer step, on the
    parameters' device (``TrainBatch.to(device)``); ``state`` is updated in
    place and returned. ``metrics``: ``loss``, ``energy``, ``force``,
    ``stress`` and ``grad_norm`` (pre-clip) as fp32 device scalars, and the
    host values ``loss_scale``, ``skipped`` (0 or 1) and ``step`` (applied
    steps). The optimizer comes with the state (``init_train_state``), not
    here, where the JAX factory takes an optax transformation."""
    loss_fn = make_packed_loss_fn(model_energy_fn, mesh, config, kernels)
    cfg = config
    # the JAX package's fp32 (1 - decay)
    ema_w = float(np.float32(1.0) - np.float32(cfg.ema_decay))

    def step(state, graphs, targets):
        leaves = param_leaves(state.params)
        scale = float(state.loss_scale)
        accum = len(graphs)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        c_sum = None
        for graph, tgt in zip(graphs, targets):
            loss, comps = loss_fn(state.params, graph, tgt)
            grads = torch.autograd.grad(loss * scale, leaves, allow_unused=True)
            for acc, g in zip(g_sum, grads):
                if g is not None:
                    acc.add_(g.float())
            c_sum = comps if c_sum is None else {k: c_sum[k] + v for k, v in comps.items()}
            del loss, grads
        inv = 1.0 / (accum * scale)
        grads = [g * inv for g in g_sum]
        comps = {k: v / accum for k, v in c_sum.items()}
        gnorm = global_norm(grads)
        finite = bool(torch.isfinite(gnorm))  # the one host read of the step
        if finite:
            if cfg.clip_norm > 0.0:
                factor = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
                grads = [g * factor for g in grads]
            for p, g in zip(leaves, grads):
                p.grad = g.to(p.dtype)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            if state.scheduler is not None:
                state.scheduler.step()
            if cfg.ema_decay > 0.0:
                with torch.no_grad():
                    for e, p in zip(param_leaves(state.ema_params), leaves):
                        e.add_(p.detach() - e, alpha=ema_w)
            state.step += 1

        interval = max(int(cfg.scale_growth_interval), 1)
        good = state.good_steps + 1
        if finite:
            if good >= interval:
                state.loss_scale = min(scale * cfg.scale_factor, cfg.max_loss_scale)
                state.good_steps = 0
            else:
                state.good_steps = good
        else:
            state.loss_scale = max(scale / cfg.scale_factor, cfg.min_loss_scale)
            state.good_steps = 0
        torch.randint(2 ** 31 - 1, (1,), generator=state.rng)  # one draw a step
        metrics = {**comps, "grad_norm": gnorm, "loss_scale": state.loss_scale,
                   "skipped": int(not finite), "step": state.step}
        return state, metrics

    return step


def make_eval_step(model_energy_fn, mesh=None, config: TrainConfig = TrainConfig(),
                   kernels: bool = True):
    """Held-out evaluation (``distmlip_tpu/train/step.py:424-437``):
    ``(params, graphs, targets) -> components`` dict of fp32 device
    scalars, the mean over the micro-batches; no parameter gradient (feed
    ``state.ema_params`` for the EMA eval)."""
    loss_fn = make_packed_loss_fn(model_energy_fn, mesh, config, kernels)

    def evaluate(params, graphs, targets):
        total = None
        for graph, tgt in zip(graphs, targets):
            _, comps = loss_fn(params, graph, tgt, create_graph=False)
            total = comps if total is None else {k: total[k] + v for k, v in comps.items()}
        return {k: v / len(graphs) for k, v in total.items()}

    return evaluate
