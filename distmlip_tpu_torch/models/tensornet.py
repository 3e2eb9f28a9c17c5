"""TensorNet: O(3)-equivariant message passing on rank-2 tensor features, torch.

Port of ``distmlip_tpu/models/tensornet.py`` (Simeon & De Fabritiis 2023,
in matgl's parameterization, the torchmd-net port). Same configuration,
parameter tree, layouts and arithmetic, so weights carried across from the
JAX package give the same energies:

- per-node state X_i in R^{3 x 3 x C}, channels last ((N, 3, 3, C));
- the embedding message ``Z * (W1 I + W2 A_e + W3 S_e)`` and each
  interaction's message ``f0 I[src] + f1 A[src] + f2 S[src]`` go through
  ``LocalGraph.aggregate_edge_messages`` with the named messages
  ``TENSORNET_EMBED`` / ``TENSORNET_INTERACTION``: on the card, the fused
  CUDA kernels of ``kernels/csrc/edge_aggregate.cu``, so the (E, 3, 3, C)
  message never exists in device memory, and the interaction's backward
  is a kernel too;
- an interaction carries I, A and S as compact rows (``decompose_compact``:
  the trace / 3, A's 3 and S's 6 distinct entries, 10 numbers per channel
  instead of 27), mixes and gathers those, and expands to 3x3 only for the
  matrix products; the values are the full path's, entry for entry;
- the scalar gates unflatten in torchmd-net's (C, 3) order, so matgl
  weights convert unchanged;
- readout: decompose -> per-channel norms -> LayerNorm -> linear -> MLP,
  scaled by ``data_std`` plus per-species reference energies.

``dtype="bfloat16"`` (``distmlip_tpu/models/tensornet.py:132-202``): the
features, messages and GEMMs run in bf16 (the parameters cast but for
``species_ref``, ``out_norm``, ``linear``, ``final`` and ``data_std``);
geometry (``vec``, ``d``) stays in the positions' dtype and is cast after
use (``rhat``, ``env``, ``rbf``); the invariants are cast back to the
positions' dtype before the readout stack. Both edge aggregations and the
interaction's backward launch their bf16 kernels on the card (fp32
accumulation, one rounding); the per-edge gathers of the
species rows accumulate their gradient in fp32 (``ops.nn.gather_rows``);
the 3x3 products, an einsum in the JAX package, take their sums in fp32
and round once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import TENSORNET_EMBED, TENSORNET_INTERACTION, Gather, tensornet_full
from ..ops import radial
from ..ops.nn import (cast_params_subtrees, embedding, gather_rows, layernorm, layernorm_init,
                      linear, linear_init, mlp, mlp_init)
from ..ops.segment import _HALF_DTYPES
from ..utils.checkpoint import as_list


@dataclass(frozen=True)
class TensorNetConfig:
    num_species: int = 95
    units: int = 64           # hidden_channels
    num_rbf: int = 32
    num_layers: int = 2
    cutoff: float = 5.0
    final_hidden: tuple | None = None  # final_layer.gated dims, default (units, units)
    dtype: str = "float32"    # compute dtype: "float32" or "bfloat16"

    @property
    def _final_hidden(self):
        return self.final_hidden if self.final_hidden is not None else (self.units, self.units)


def decompose(X):
    """Split (..., 3, 3, C) into (trace part I, antisymmetric A,
    symmetric traceless S); the matrix lives in axes (-3, -2)."""
    trace = (X[..., 0, 0, :] + X[..., 1, 1, :] + X[..., 2, 2, :])[..., None, None, :]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)[:, :, None]
    I = trace / 3.0 * eye
    Xt = X.transpose(-3, -2)
    A = 0.5 * (X - Xt)
    S = 0.5 * (X + Xt) - I
    return I, A, S


def decompose_compact(X):
    """``decompose`` of (N, 3, 3, C) as compact rows, by the same
    operations: i (N, C) the trace / 3; a (N, 3, C) A's entries (0,1),
    (0,2), (1,2); s (N, 6, C) S's entries (0,0), (1,1), (2,2), (0,1),
    (0,2), (1,2). ``expand_compact`` of them equals ``decompose(X)``."""
    i = (X[:, 0, 0] + X[:, 1, 1] + X[:, 2, 2]) / 3.0
    diag = X[:, (0, 1, 2), (0, 1, 2)]
    up, lo = X[:, (0, 0, 1), (1, 2, 2)], X[:, (1, 2, 2), (0, 0, 1)]
    a = 0.5 * (up - lo)
    s = torch.cat([0.5 * (diag + diag) - i[:, None], 0.5 * (up + lo)], dim=1)
    return i, a, s


def expand_compact(i, a, s):
    """Compact rows (``decompose_compact``) -> the full (N, 3, 3, C) I, A
    and S."""
    eye = torch.eye(3, dtype=i.dtype, device=i.device)[:, :, None]
    off = s[:, 3:]
    return (i[:, None, None, :] * eye, tensornet_full(torch.zeros_like(a), a, -a),
            tensornet_full(s[:, :3], off, off))


def tensor_norm(X):
    """Per-channel squared Frobenius norm: (..., 3, 3, C) -> (..., C)."""
    return (X * X).sum(dim=(-3, -2))


def _vector_to_skew(v):
    """(..., 3) -> (..., 3, 3) antisymmetric [v]_x (torchmd-net
    vector_to_skewtensor convention)."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _mix(lin, comp):
    """torchmd-net channel mix: a Linear over the channel axis of a
    (..., 3, 3, C) component or its compact rows (one GEMM, channels
    already last)."""
    return comp @ lin["w"]


def _matmul3(P, Q):
    """Batched 3x3 matrix products over (node, channel), matrix axes (1, 2):
    ``einsum("nijc,njkc->nikc")`` as three broadcast multiply-adds. The
    einsum runs as one tiny matrix product per (node, channel), ~1.8 ms a
    call at 16384 atoms on an H100 80GB HBM3 at 700 W
    (``tools/step_profile.py``, PERF.md). Half-precision factors multiply
    and sum in fp32 and round once, as the JAX package's einsum does."""
    if P.dtype in _HALF_DTYPES:
        return _matmul3(P.float(), Q.float()).to(P.dtype)
    out = P[:, :, 0, None, :] * Q[:, None, 0, :, :]
    for j in (1, 2):
        out = out + P[:, :, j, None, :] * Q[:, None, j, :, :]
    return out


# the parameter subtrees that stay float32 at a bf16 compute dtype: the
# reference energies and the readout stack (distmlip_tpu/models/tensornet.py:139-143)
KEEP_FP32 = ("species_ref", "out_norm", "linear", "final", "data_std")


class TensorNet:
    supports_compute_dtype = True  # energy_fn honours cfg.dtype="bfloat16"

    def __init__(self, config: TensorNetConfig = TensorNetConfig()):
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"TensorNet dtype={config.dtype!r}: float32 or bfloat16")
        self.cfg = config

    # ---- parameters ----
    def init(self, seed: int = 0) -> dict:
        """Random parameters in the JAX package's tree layout, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's RNG stream)."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(seed))
        C, R = cfg.units, cfg.num_rbf
        params = {
            # tensor_embedding.*
            "species_emb": {"w": torch.randn((cfg.num_species, C), generator=gen)},
            "emb2": linear_init(gen, 2 * C, C),
            "dist_proj": [linear_init(gen, R, C) for _ in range(3)],
            "emb_lin_scalar": [linear_init(gen, C, 2 * C), linear_init(gen, 2 * C, 3 * C)],
            "emb_lin_tensor": [linear_init(gen, C, C, bias=False) for _ in range(3)],
            "init_norm": layernorm_init(C),
            "layers": [],
            # readout (reference dist_forward :131-151)
            "out_norm": layernorm_init(3 * C),
            "linear": linear_init(gen, 3 * C, C),
            "final": mlp_init(gen, [C] + list(cfg._final_hidden) + [1]),
            "species_ref": {"w": torch.zeros((cfg.num_species, 1))},
            "data_std": torch.ones(()),
        }
        for _ in range(cfg.num_layers):
            params["layers"].append({
                "lin_scalar": [linear_init(gen, R, C), linear_init(gen, C, 2 * C),
                               linear_init(gen, 2 * C, 3 * C)],
                "lin_tensor": [linear_init(gen, C, C, bias=False) for _ in range(6)],
            })
        return params

    # ---- forward ----
    def energy_fn(self, params, lg, positions):
        """Per-atom energies (n_cap,) of the local graph."""
        cfg = self.cfg
        C = cfg.units
        # features and GEMMs in the compute dtype; geometry and the readout
        # stack in the positions' dtype
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else positions.dtype
        if cfg.dtype == "bfloat16":
            params = cast_params_subtrees(params, dtype, keep_fp32=KEEP_FP32)
        vec = lg.edge_vectors(positions)
        emask = lg.edge_mask[:, None]
        d = torch.linalg.norm(torch.where(emask, vec, torch.ones_like(vec)), dim=-1)
        rhat = (vec / torch.clamp(d, min=1e-9)[:, None]).to(dtype)
        env = (radial.cosine_cutoff(d, cfg.cutoff) * lg.edge_mask.to(d.dtype)).to(dtype)
        rbf = radial.spherical_bessel_basis(d, cfg.cutoff, cfg.num_rbf).to(dtype)

        # --- tensor embedding (torchmd-net TensorEmbedding) ---
        eye = torch.eye(3, dtype=dtype, device=d.device)[:, :, None]    # (3, 3, 1)
        A_e = _vector_to_skew(rhat)[..., None]                          # (E, 3, 3, 1)
        S_e = (rhat[:, :, None] * rhat[:, None, :])[..., None] - eye / 3.0

        z = embedding(params["species_emb"], lg.species)                # (N, C)
        # gather_rows: a bf16 z's gradient sums its edges' rows in fp32
        Zij = linear(params["emb2"], torch.cat(
            [gather_rows(z, lg.edge_src), gather_rows(z, lg.edge_dst)], dim=-1))
        dist_proj = as_list(params["dist_proj"])
        W1 = linear(dist_proj[0], rbf) * env[:, None]                   # (E, C)
        W2 = linear(dist_proj[1], rbf) * env[:, None]
        W3 = linear(dist_proj[2], rbf) * env[:, None]

        X = lg.aggregate_edge_messages(
            TENSORNET_EMBED, (Zij, W1, W2, W3, A_e, S_e), mask=lg.edge_mask)

        norm = layernorm(params["init_norm"], tensor_norm(X))
        for lin in as_list(params["emb_lin_scalar"]):
            norm = F.silu(linear(lin, norm))
        norm = norm.reshape(-1, C, 3)  # torchmd-net's (C, 3) unflatten order
        emb_lin_tensor = as_list(params["emb_lin_tensor"])
        I, A, S = decompose(X)
        I = _mix(emb_lin_tensor[0], I)
        A = _mix(emb_lin_tensor[1], A)
        S = _mix(emb_lin_tensor[2], S)
        X = (I * norm[:, None, None, :, 0] + A * norm[:, None, None, :, 1]
             + S * norm[:, None, None, :, 2])
        X = lg.halo_exchange(X)

        # --- interaction layers ---
        for lp in as_list(params["layers"]):
            X = self._interaction(lp, lg, X, rbf, env)
            X = lg.halo_exchange(X)

        # --- invariant readout (reference dist_forward :131-151), in the
        # positions' dtype on the float32 readout stack ---
        I, A, S = decompose(X)
        inv = torch.cat([tensor_norm(I), tensor_norm(A), tensor_norm(S)],
                        dim=-1).to(positions.dtype)
        x = linear(params["linear"], layernorm(params["out_norm"], inv))
        e_atom = mlp(as_list(params["final"]), x)[:, 0]
        e_ref = params["species_ref"]["w"][lg.species.long(), 0]
        return params["data_std"] * e_atom + e_ref

    def _interaction(self, lp, lg, X, rbf, env):
        """torchmd-net TensorNetInteraction (O(3) group): radial edge gates,
        per-channel normalization X/(||X||+1), channel mixes, neighbor
        message M, B = YM + MY, normalized remix, X + dX + dX^2."""
        C = self.cfg.units
        f = rbf
        for lin in as_list(lp["lin_scalar"]):
            f = F.silu(linear(lin, f))
        f = (f * env[:, None]).reshape(-1, C, 3)  # torchmd-net (C, 3) order

        lin_tensor = as_list(lp["lin_tensor"])
        X = X / (tensor_norm(X) + 1.0)[..., None, None, :]
        # compact rows: mixing is row-wise, so mixing the 10 distinct rows
        # per node gives the full mix's entries (A's lower triangle is the
        # negation of its upper one)
        i, a, s = decompose_compact(X)
        i = _mix(lin_tensor[0], i)
        a = _mix(lin_tensor[1], a)
        s = _mix(lin_tensor[2], s)
        I, A, S = expand_compact(i, a, s)
        Y = I + A + S

        src = lg.edge_src
        M = lg.aggregate_edge_messages(
            TENSORNET_INTERACTION, (f, Gather(i, src), Gather(a, src), Gather(s, src)),
            mask=lg.edge_mask)

        B = _matmul3(Y, M) + _matmul3(M, Y)
        I, A, S = decompose(B)
        np1 = (tensor_norm(B) + 1.0)[..., None, None, :]
        I = _mix(lin_tensor[3], I / np1)
        A = _mix(lin_tensor[4], A / np1)
        S = _mix(lin_tensor[5], S / np1)
        dX = I + A + S
        return X + dX + _matmul3(dX, dX)
