"""Analytic per-model FLOP estimates and MFU accounting
(``distmlip_tpu/utils/flops.py``, the arithmetic copied term for term).

Chip-independent cost model: given a model and the live graph shape
(atoms / edges / line-graph edges per step), estimate the floating-point
work of one full potential evaluation (energy + forces [+ stress]); the
trainer's ``model_cost_fn`` packs batches by it, and the telemetry ``mfu``
field divides it by device time x the card's peak rate for the step's
compute dtype (``peak_flops_per_device``). Everything here is an
ESTIMATE —
dominant GEMM terms only, elementwise/gather glue ignored — intended for
trending and cross-run comparison, not absolute accounting (expect ~±20%).

Conventions:
- a dense [m -> n] layer over R rows costs ``2 R m n`` FLOPs (MACs x 2);
- gated MLPs (CHGNet) run two parallel stacks -> 2x their dense cost;
- the backward pass of reverse-mode E+F costs ~2x the forward's GEMMs, so
  a potential step is ``FWD_BWD_FACTOR = 3`` x the forward estimate (the
  full-remat configurations re-run the forward once more; callers may
  scale by 4/3 when cfg.remat is True — we fold that in automatically).
"""

from __future__ import annotations

FWD_BWD_FACTOR = 3.0  # forward + ~2x forward for the reverse pass

# peak dense FLOP/s of one card by device-name substring and compute dtype:
# float32 outside the tensor cores, bf16 in them (H100 SXM, the rates
# chip_smoke.py's bounds use). The JAX package's table holds TPUs.
_PEAK_TABLE = (
    ("H100", {"float32": 67e12, "bfloat16": 989e12}),
)


def _mlp_flops(dims, rows: float) -> float:
    """Dense chain [d0 -> d1 -> ... -> dk] over ``rows`` rows."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def _gated_mlp_flops(dims, rows: float) -> float:
    return 2.0 * _mlp_flops(dims, rows)


def chgnet_flops(cfg, n_atoms: float, n_edges: float, n_lines: float = 0.0,
                 n_bonds: float | None = None) -> float:
    """CHGNet forward: atom-conv gated MLPs per edge, bond/angle-conv gated
    MLPs per line-graph edge, bases + readouts."""
    C, R = cfg.units, cfg.num_rbf
    if n_bonds is None:
        n_bonds = n_edges  # bond nodes ~ in-cutoff directed edges
    ah = list(cfg._atom_hidden)
    bh = list(cfg._bond_hidden)
    gh = list(cfg.angle_update_hidden)
    fl = list(cfg._final_hidden)
    f = _mlp_flops([R, C], n_edges)                       # bond embedding
    f += _mlp_flops([cfg.angle_dim, C], n_lines)          # angle embedding
    # shared rbf weight linears
    n_shared = (2 if cfg.shared_bond_weights in ("bond", "both") else 0) + (
        1 if cfg.shared_bond_weights in ("threebody", "both") else 0)
    f += n_shared * _mlp_flops([R, C], n_edges)
    for _ in range(cfg.num_blocks):
        f += _gated_mlp_flops([3 * C] + ah + [C], n_edges)   # node messages
        f += _mlp_flops([C, C], n_atoms)                     # node_out
        if cfg.bond_update_hidden is not None:
            f += _gated_mlp_flops(
                [3 * C] + list(cfg.bond_update_hidden) + [C], n_edges)
            f += _mlp_flops([C, C], n_edges)
    if cfg.use_bond_graph:
        for _ in range(max(cfg.num_blocks - 1, 0)):
            f += _gated_mlp_flops([4 * C] + bh + [C], n_lines)  # bond conv
            f += _mlp_flops([C, C], n_bonds)                    # node_out
        # the angle update after the LAST bond conv feeds nothing and is
        # skipped (dead_compute contract pass)
        for _ in range(max(cfg.num_blocks - 2, 0)):
            f += _gated_mlp_flops([4 * C] + gh + [C], n_lines)  # angle conv
    f += _mlp_flops([C] + fl + [1], n_atoms)              # final readout
    f += _mlp_flops([C, cfg.num_site_targets], n_atoms)   # sitewise
    return f


def mace_flops(cfg, n_atoms: float, n_edges: float, model=None) -> float:
    """MACE forward: radial MLPs + density projection per edge, symmetric
    contraction per node. Uses the model's precomputed path tables when
    available; otherwise falls back to l_max-based estimates."""
    C = cfg.channels
    S_Y = (cfg.l_max + 1) ** 2
    f = 0.0
    for t in range(cfg.num_interactions):
        if model is not None and hasattr(model, "proj"):
            proj = model.proj[t]
            S_h, nQ = proj["S_h"], proj["W"].shape[1]
            n_paths = len(model.msg_paths[t])
        else:  # crude: first interaction sees scalars only
            S_h = 1 if t == 0 else (min(cfg.hidden_lmax, cfg.l_max) + 1) ** 2
            nQ = S_h * (cfg.l_max + 1)
            n_paths = nQ
        # radial MLP: bessel -> radial_mlp^2 -> n_paths (upstream 3-layer)
        f += _mlp_flops([cfg.num_bessel, cfg.radial_mlp, cfg.radial_mlp,
                         n_paths * C], n_edges)
        # density projection: T = Y x W (channel-free), M = T x h_src
        f += 2.0 * n_edges * S_Y * S_h * nQ
        f += 2.0 * n_edges * S_h * nQ * C
        # per-path node mixing + symmetric contraction (correlation-order
        # Horner over the U-matrix basis) — dominated by nQ*C GEMM terms
        f += 2.0 * n_atoms * nQ * C * C
        f += 2.0 * n_atoms * cfg.correlation * nQ * C * S_h
    return f


def tensornet_flops(cfg, n_atoms: float, n_edges: float) -> float:
    C = cfg.units
    f = _mlp_flops([2 * C, C], n_edges)      # Zij edge embedding
    f += 3 * _mlp_flops([cfg.num_rbf, C], n_edges)
    # per layer: scalar MLPs on edges + 6 channel mixes + 3x3 matmuls
    n_layers = getattr(cfg, "num_layers", 2)
    per_layer = (_mlp_flops([cfg.num_rbf, C, 3 * C], n_edges)
                 + 6 * 2.0 * n_atoms * 9 * C * C
                 + 2 * 2.0 * n_atoms * 27 * C)
    f += n_layers * per_layer
    f += _mlp_flops([3 * C, C, 1], n_atoms)  # readout stack (approx)
    return f


def pair_flops(cfg, n_atoms: float, n_edges: float) -> float:
    return 50.0 * n_edges  # elementwise pair math; negligible by design


def edge_aggregate_flops(n_edges: float, w_in: float, w_out: float) -> float:
    """Analytic FLOPs of the canonical gather -> edge-MLP -> scatter
    pipeline (the tools/kernel_bench.py workload): one (w_in, w_out) GEMM
    per edge (2*w_in*w_out), the silu gate (~4*w_in) and the masked
    dst-scatter accumulation (2*w_out). Shared by the fused and unfused
    arms so their MFU numbers are comparable."""
    return float(n_edges) * (2.0 * float(w_in) * float(w_out)
                             + 4.0 * float(w_in) + 2.0 * float(w_out))


def escn_flops(cfg, n_atoms: float, n_edges: float) -> float:
    """eSCN/UMA: Wigner rotations + SO(2) convolutions per edge."""
    C = getattr(cfg, "channels", getattr(cfg, "sphere_channels", 128))
    lmax = getattr(cfg, "l_max", getattr(cfg, "lmax", 2))
    S = (lmax + 1) ** 2
    n_layers = getattr(cfg, "num_layers", 2)
    per_edge = 4.0 * S * S * C + 4.0 * S * C * C  # rotate in/out + SO(2) GEMMs
    return n_layers * n_edges * per_edge


def model_flop_estimate(model, n_atoms: float, n_edges: float,
                        n_lines: float = 0.0) -> float:
    """One potential step's estimated FLOPs (energy + forces [+ stress])
    for ``model`` on a graph of the given shape; 0.0 when the model family
    is unknown."""
    cfg = getattr(model, "cfg", None)
    if cfg is None:
        return 0.0
    name = type(model).__name__.lower()
    if "chgnet" in name:
        fwd = chgnet_flops(cfg, n_atoms, n_edges, n_lines)
    elif "mace" in name:
        fwd = mace_flops(cfg, n_atoms, n_edges, model=model)
    elif "tensornet" in name:
        fwd = tensornet_flops(cfg, n_atoms, n_edges)
    elif "escn" in name or "uma" in name:
        fwd = escn_flops(cfg, n_atoms, n_edges)
    elif "pair" in name:
        fwd = pair_flops(cfg, n_atoms, n_edges)
    else:
        return 0.0
    factor = FWD_BWD_FACTOR
    if getattr(cfg, "remat", False) is True:
        factor += 1.0  # full remat re-runs the forward inside the backward
    return factor * fwd



def peak_flops_per_device(dtype: str = "float32", device_name: str | None = None,
                          default: float = 0.0) -> float:
    """Peak dense FLOP/s of one card for work in ``dtype`` ("float32" or
    "bfloat16"), looked up by ``device_name`` (default: the name of CUDA
    device 0); ``default`` (0.0) without a card or for an unknown one, so a
    downstream ``mfu`` stays 0 instead of fabricated. The JAX package's
    ``DISTMLIP_PEAK_FLOPS`` variable is not read: pass ``peak=`` to ``mfu``
    instead."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return default
        device_name = torch.cuda.get_device_name(0)
    for key, peaks in _PEAK_TABLE:
        if key in device_name:
            return peaks.get(dtype, default)
    return default


def mfu(flops_per_step: float, device_s: float, n_devices: int,
        peak: float | None = None, dtype: str = "float32") -> float:
    """Model FLOP utilization in [0, 1]; 0.0 whenever any input is unknown
    (on the CPU the peak is unknown)."""
    if peak is None:
        peak = peak_flops_per_device(dtype)
    if flops_per_step <= 0 or device_s <= 0 or peak <= 0 or n_devices <= 0:
        return 0.0
    return flops_per_step / (device_s * n_devices * peak)
