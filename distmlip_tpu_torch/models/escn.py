"""eSCN / UMA-style equivariant spherical channel network, torch.

Port of ``distmlip_tpu/models/escn.py`` (Passaro & Zitnick 2023, with the
UMA conditioning and MOLE expert mixing). Same configuration, parameter
tree, layouts and arithmetic, so weights carried across from the JAX
package give the same energies:

- node features h (N, S, C): S = (l_max+1)^2 real spherical-harmonic
  coefficients in the e3nn order, channels last;
- per edge chunk: rotate the sender's features into the edge-aligned frame
  (``ops/so3_e3nn.wigner_blocks_from_edges``), add the edge scalars to the
  l=0 row, run the SO(2) convolution (``kernels/dispatch.fused_so2_conv``,
  the call that launches the CUDA SO(2) kernel), rotate back, and sum onto
  the receivers with ONE dst-sorted segment sum per chunk
  (``fused_segment_sum``, the segment-sum kernel);
- the edge-degree embedding, the charge/spin/dataset (csd) system
  embedding, the MOLE gate (per-layer expert weights mixed once in weight
  space from a whole-system composition + csd softmax), the gated
  nonlinearity and the energy readout.

On a block-diagonally packed batch (``lg.struct_id`` set, ``partition/
batch.py``) with ``num_experts > 1`` the composition is a per-STRUCTURE
quantity (``distmlip_tpu/models/escn.py:331-353``): the gate is a (B, E)
softmax of each structure's mean species embedding and the replicated csd,
and each edge mixes the expert products with its dst structure's gate
(``:405-437``). The convolution is linear in its weights, so the mixture
is taken over outputs: y_e = sum_k gate_e[k] SO2(h_e; W_k), one SO(2)
kernel call per expert on that expert's own weight set (the kernel's
contract), packed once per layer.

Rematerialization: with ``remat=True`` each edge chunk runs under a
non-reentrant ``torch.utils.checkpoint``, so the backward holds one chunk's
rotated features and Wigner blocks at a time and re-runs the chunk body
(one more SO(2) and segment-sum launch per chunk).

``dtype="bfloat16"`` (``distmlip_tpu/models/escn.py:170-190``, ``:263-372``,
``:452-454``): the parameters are cast to bf16 except ``species_ref`` and
``energy_mlp`` (``ops/nn.cast_params_subtrees``), so features, messages,
the rotations (each Wigner block cast at its use), the SO(2) kernel's
bf16 route and the MOLE mix run in bf16, while geometry (``rhat``, the
fp32 Wigner core) and the energy readout and sum stay in the positions'
dtype. The segment sums accumulate in fp32 and round to bf16 once, and
the per-edge gather of the sender rows accumulates its gradient in fp32
(``ops/nn.gather_rows``).

Not ported (raises ``NotImplementedError``): ``l_max > 6``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.dispatch import fused_segment_sum, fused_so2_conv, so2_packed_weights
from ..ops import radial
from ..ops.chunk import chunk_layout, scan_accumulate
from ..ops.nn import cast_params_subtrees, gather_rows, linear, linear_init, mlp, mlp_init
from ..ops.segment import masked_segment_sum
from ..ops.so3_e3nn import CoeffLayout, wigner_blocks_from_edges
from ..telemetry.trace import scope
from ..utils.checkpoint import as_list


@dataclass(frozen=True)
class ESCNConfig:
    num_species: int = 95
    channels: int = 64
    l_max: int = 2              # <= 6 (SH table limit)
    num_layers: int = 3
    num_bessel: int = 8
    num_experts: int = 1        # > 1 enables UMA-style MOLE weight mixing
    cutoff: float = 5.0
    avg_num_neighbors: float = 14.0
    # UMA charge/spin/dataset (csd) conditioning: per-system embeddings
    # mixed into the node scalars and the MOLE gate
    num_charges: int = 25       # charge index = charge - charge_min
    charge_min: int = -12
    num_spins: int = 10
    num_datasets: int = 4
    edge_channels: int = 32     # source/target species embeddings feeding the
                                # edge-degree embedding
    edge_chunk: int = 32768     # edges per chunk of every edge pass: the
                                # per-edge rotated features (E, S, C) and
                                # Wigner blocks are rebuilt per chunk
                                # (0 disables chunking)
    remat: bool = True          # checkpoint each edge chunk
    dtype: str = "float32"      # compute dtype: "float32" or "bfloat16"

    @property
    def sphere_dim(self) -> int:
        return (self.l_max + 1) ** 2


def _l_slices(l_max):
    out = {}
    o = 0
    for l in range(l_max + 1):
        out[l] = slice(o, o + 2 * l + 1)
        o += 2 * l + 1
    return out


class ESCN:
    supports_compute_dtype = True  # energy_fn honours cfg.dtype="bfloat16"

    def __init__(self, config: ESCNConfig = ESCNConfig()):
        if config.l_max > 6:
            raise NotImplementedError(
                "l_max > 6: extend the SH tables backing ops/so3_e3nn.jd_np")
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"eSCN dtype={config.dtype!r}: float32 or bfloat16")
        self.cfg = config
        # per |m|, the stacked indices of the (l, +m) / (l, -m) pair over
        # l = m..l_max: the complex pairs the SO(2) convolutions mix
        lay = CoeffLayout(config.l_max)
        self.m_idx = {m: (lay.plus_idx[m], lay.minus_idx[m])
                      for m in range(config.l_max + 1)}

    # ---- parameters ----
    def init(self, seed: int = 0) -> dict:
        """Random parameters in the JAX package's tree layout, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's RNG stream)."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(seed))
        C, E, Ce = cfg.channels, cfg.num_experts, cfg.edge_channels
        randn = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
        params = {
            "species_emb": {"w": randn(cfg.num_species, C)},
            "charge_emb": {"w": randn(cfg.num_charges, C)},
            "spin_emb": {"w": randn(cfg.num_spins, C)},
            "dataset_emb": {"w": randn(cfg.num_datasets, C)},
            "csd_mlp": mlp_init(gen, [C, C]),
            "sys_node_proj": linear_init(gen, C, C),
            "source_emb": {"w": randn(cfg.num_species, Ce)},
            "target_emb": {"w": randn(cfg.num_species, Ce)},
            "edge_deg": linear_init(gen, cfg.num_bessel + 2 * Ce, C * (cfg.l_max + 1)),
            "mole_gate": mlp_init(gen, [2 * C, C, E]) if E > 1 else None,
            "layers": [],
            "energy_mlp": mlp_init(gen, [C, C, 1]),
            "species_ref": {"w": torch.zeros((cfg.num_species,))},
        }
        for _ in range(cfg.num_layers):
            layer = {
                "edge_mlp": mlp_init(gen, [cfg.num_bessel + 2 * C, C, C]),
                "so2": {},
                "gate_mlp": mlp_init(gen, [C, C, C]),
                "scalar_mlp": mlp_init(gen, [C, C, C]),
            }
            for m in range(cfg.l_max + 1):
                d = (cfg.l_max + 1 - m) * C
                names = ["m0"] if m == 0 else [f"m{m}r", f"m{m}i"]
                for name in names:
                    layer["so2"][name] = randn(E, d, d) / np.sqrt(d)
            params["layers"].append(layer)
        return params

    # ---- forward ----
    def energy_fn(self, params, lg, positions):
        cfg = self.cfg
        C, S, L = cfg.channels, cfg.sphere_dim, cfg.l_max
        batched_gate = cfg.num_experts > 1 and lg.struct_id is not None and lg.batch_size > 0
        # compute dtype for features and the SO(2) GEMMs; geometry and the
        # energy readout and sum stay in the positions dtype
        dev, acc_dtype = positions.device, positions.dtype
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else acc_dtype
        if cfg.dtype == "bfloat16":
            # species_ref (reference energies) and the energy readout stay
            # fp32 so the energy path keeps full precision
            params = cast_params_subtrees(params, dtype,
                                          keep_fp32=("species_ref", "energy_mlp"))

        vec = lg.edge_vectors(positions)
        emask = lg.edge_mask
        d = torch.linalg.norm(
            torch.where(emask[:, None], vec, torch.ones_like(vec)), dim=-1)
        # rhat stays in the positions dtype: the Wigner core builds its trig
        # chains in fp32 and D is cast per use in rotate()
        rhat = vec / torch.clamp(d, min=1e-9)[:, None]
        env = (radial.polynomial_cutoff(d, cfg.cutoff) * emask).to(dtype)
        bessel = radial.spherical_bessel_basis(d, cfg.cutoff, cfg.num_bessel).to(dtype)
        sl = _l_slices(L)

        def rotate(hvecs, D, to_edge=False, add_scalar=None):
            # per l block: D_l maps edge-frame coefficients to the lab frame,
            # D_l^T (to_edge) maps lab features into the edge frame;
            # add_scalar (E_c, C) is added to the l=0 row before the blocks
            # are joined, sparing a full-size copy
            parts = []
            for l in range(L + 1):
                Dl = D[l].to(hvecs.dtype)
                Dl = Dl.transpose(1, 2) if to_edge else Dl
                parts.append(torch.bmm(Dl, hvecs[:, sl[l], :]))
            if add_scalar is not None:
                parts[0] = parts[0] + add_scalar[:, None, :]
            return torch.cat(parts, dim=1)

        # --- edge-chunked passes, aligned to the interior/frontier split:
        # every chunk's dst stays sorted ---------------------------------
        row_idx, row_valid, K, _ = chunk_layout(
            lg.e_cap, cfg.edge_chunk, lg.e_split if lg.has_frontier_split else None)
        rows = torch.as_tensor(row_idx, dtype=torch.long, device=dev)
        take = lambda x: x.index_select(0, rows)  # noqa: E731
        edge_xs = (take(lg.edge_src), take(lg.edge_dst),
                   take(emask) & torch.as_tensor(row_valid, device=dev),
                   take(rhat), take(bessel), take(env))
        # one chunk: build D once and share it across the edge-degree pass
        # and every layer
        D_shared = wigner_blocks_from_edges(L, edge_xs[3]) if K == 1 else None

        def edge_scan(per_chunk):
            """Sum over the edge chunks of per_chunk(...)'s (E_c, S, C)
            message rows, segment-summed onto their dst in each chunk."""

            def body(srcc, dstc, maskc, rhatc, besc, envc):
                D = D_shared if D_shared is not None else wigner_blocks_from_edges(L, rhatc)
                msg = per_chunk(srcc, dstc, D, besc, envc)
                return fused_segment_sum(msg, dstc, lg.n_cap, maskc,
                                         indices_are_sorted=True, kernels=lg.kernels)

            return scan_accumulate(body, edge_xs, K, remat=cfg.remat)

        z = lg.species
        zemb = params["species_emb"]["w"].index_select(0, z)  # (N, C)

        # csd (charge/spin/dataset) system embedding
        sys_state = lg.system or {}

        def sys_index(key, offset, size):
            v = torch.as_tensor(sys_state.get(key, 0), device=dev).reshape(1).long()
            return torch.clamp(v - offset, 0, size - 1)

        csd = mlp(params["csd_mlp"], (
            params["charge_emb"]["w"].index_select(
                0, sys_index("charge", cfg.charge_min, cfg.num_charges))
            + params["spin_emb"]["w"].index_select(0, sys_index("spin", 0, cfg.num_spins))
            + params["dataset_emb"]["w"].index_select(
                0, sys_index("dataset", 0, cfg.num_datasets)))[0])  # (C,)

        # node scalars: species embedding + the system embedding
        h0 = zemb + linear(params["sys_node_proj"], csd)[None, :]
        h = torch.cat([h0[:, None, :], h0.new_zeros((h0.shape[0], S - 1, C))], dim=1)

        # edge-degree embedding: per-edge scalars (distance expansion +
        # source/target species embeddings) -> m=0 coefficients in the edge
        # frame, rotated back and degree-summed onto the receiver. Only the
        # (l, m=0) centre column of each D_l meets a nonzero coefficient.
        def deg_chunk(srcc, dstc, D, besc, envc):
            x_edge = torch.cat([
                besc,
                params["source_emb"]["w"].index_select(0, z.index_select(0, srcc)),
                params["target_emb"]["w"].index_select(0, z.index_select(0, dstc)),
            ], dim=-1)
            w_deg = linear(params["edge_deg"], x_edge).reshape(-1, L + 1, C)
            y = torch.cat([D[l][:, :, l:l + 1].to(dtype) * w_deg[:, l:l + 1, :]
                           for l in range(L + 1)], dim=1)
            return y * envc[:, None, None]

        inv_avg = torch.tensor(1.0 / cfg.avg_num_neighbors, dtype=dtype, device=dev)
        h = h + edge_scan(deg_chunk) * inv_avg
        h = lg.halo_exchange(h)

        # MOLE coefficients: whole-system composition embedding + csd ->
        # softmax gate, the same on every partition (psum'd mean); on a
        # packed batch one gate per structure (padded rows sum into the
        # sentinel slot B, dropped)
        if batched_gate:
            owned = lg.owned_mask.to(dtype)[:, None]
            B, sid = lg.batch_size, lg.struct_id.long()
            # per-structure sums accumulate in fp32 (a bf16 count stops at 256)
            comp_sum = lg.psum(masked_segment_sum(zemb * owned, sid, B + 1)[:B])
            count = lg.psum(masked_segment_sum(owned[:, 0], sid, B + 1)[:B])
            gate_in = torch.cat([comp_sum / torch.clamp(count, min=1.0)[:, None],
                                 csd.expand(B, C)], dim=-1)
            mole = torch.softmax(mlp(params["mole_gate"], gate_in), dim=-1)  # (B, E)
        elif cfg.num_experts > 1:
            owned = lg.owned_mask.to(dtype)[:, None]
            comp_sum = lg.psum((zemb * owned).sum(0))
            count = lg.psum(owned.sum())
            gate_in = torch.cat([comp_sum / torch.clamp(count, min=1.0), csd], dim=-1)
            mole = torch.softmax(mlp(params["mole_gate"], gate_in), dim=-1)
        else:
            mole = torch.ones((1,), dtype=dtype, device=dev)

        for i, layer in enumerate(as_list(params["layers"])):
            with scope(f"escn/layer{i}"):
                so2 = layer["so2"]
                per_m = lambda f: [f(so2["m0"])] + [  # noqa: E731
                    f(so2[f"m{m}{part}"]) for m in range(1, L + 1) for part in "ri"]
                if batched_gate:
                    # one weight set per expert: the gate mixes their outputs
                    ws_sets = [per_m(lambda Wk, k=k: Wk[k]) for k in range(cfg.num_experts)]
                else:
                    # mix experts ONCE in weight space per layer; the SO(2) kernel
                    # then runs every per-|m| product on the mixed weights
                    ws_sets = [per_m(lambda Wk: torch.einsum("k,kab->ab", mole, Wk))]
                # the kernel's form of each weight set, once per layer for every
                # chunk, forward and backward (None on the plain path)
                packs = [so2_packed_weights(ws, self.m_idx, C, kernels=lg.kernels)
                         for ws in ws_sets]

                def so2_chunk(srcc, dstc, D, besc, envc, layer=layer, ws_sets=ws_sets,
                              packs=packs, h=h):
                    ef = torch.cat([besc, zemb.index_select(0, srcc),
                                    zemb.index_select(0, dstc)], dim=-1)
                    g_e = mlp(layer["edge_mlp"], ef) * envc[:, None]  # (E_c, C)
                    # rotate into the edge frame, the edge scalars injected into
                    # the l=0 row
                    h_rot = rotate(gather_rows(h, srcc), D, to_edge=True, add_scalar=g_e)
                    conv = lambda k: fused_so2_conv(  # noqa: E731
                        h_rot, ws_sets[k], self.m_idx, C, kernels=lg.kernels, packed=packs[k])
                    if batched_gate:
                        # the edge's structure gate (dst rows are real atoms)
                        mole_e = mole.index_select(
                            0, torch.clamp(lg.struct_id.index_select(0, dstc).long(),
                                           max=lg.batch_size - 1))
                        y = sum(mole_e[:, k, None, None] * conv(k) for k in range(len(ws_sets)))
                    else:
                        y = conv(0)
                    return rotate(y, D) * envc[:, None, None]

                agg = edge_scan(so2_chunk) * inv_avg

                # gated nonlinearity: scalars via MLP, higher l scaled by gates
                s = agg[:, 0, :]
                gates = torch.sigmoid(mlp(layer["gate_mlp"], s))
                upd = torch.cat([mlp(layer["scalar_mlp"], s)[:, None],
                                 agg[:, 1:] * gates[:, None, :]], dim=1)
                h = lg.halo_exchange(h + upd)

        # the energy readout and sum in the positions dtype (bf16 is too
        # coarse for them): the JAX package's bf16 scalars times its fp32
        # readout weights promote to fp32
        with scope("escn/readout"):
            e_atom = mlp(params["energy_mlp"], h[:, 0, :].to(acc_dtype))[:, 0]
            return e_atom + params["species_ref"]["w"].index_select(0, z).to(acc_dtype)
