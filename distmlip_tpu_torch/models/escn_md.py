"""ESCNMD: the UMA/fairchem-parameterized eSCN backbone, torch.

Port of ``distmlip_tpu/models/escn_md.py``. Where ``models/escn.py`` has
the repo's own eSCN parameterization, this model carries fairchem's
``eSCNMDBackbone`` surface tensor for tensor, so pretrained UMA-family
checkpoints convert onto it (``models/convert.py``, ``MAPPINGS["escn"]``).
Same configuration, parameter tree, layouts and arithmetic as the JAX
model, so parameters carried across give the same energies:

- node features h (N, (lmax+1)^2, C), channels last, scalars initialised
  from the species embedding plus the per-system charge/spin/dataset (csd)
  embedding;
- per-edge Wigner blocks ``X(alpha) J X(beta) J`` (``ops/so3_e3nn``) with
  mmax narrowing of the edge-frame coefficients (``CoeffLayout``);
- edge scalars = [gaussian distance expansion, source species embedding,
  target species embedding], feeding the edge-degree embedding and the
  radial scaling of the first SO(2) convolution;
- each block: degree-balanced RMS norm, two SO(2) convolutions in their own
  per-|m| products (the m = 0 block with extra gate outputs, (cos, sin)
  pairs mixed by (W_r, W_i)), a gate activation, and a gated FFN;
- MOLE: with ``num_experts > 1`` the SO(2) weights are the convex mixture
  of the experts under a gate of the owned atoms' mean species embedding
  and the csd vector, mixed once per layer in weight space.

Linear weights keep fairchem's (d_out, d_in) layout (``F.linear``), unlike
``ops/nn.linear``'s (d_in, d_out): the converter maps names onto them
tensor for tensor.

The edge passes (the edge-degree embedding and each block's messages) run
over ``ops/chunk.chunk_layout``'s chunks, each chunk's dst sorted; each
chunk's messages (E_c, (lmax+1)^2, C) sum onto their receivers in ONE
``kernels/dispatch.fused_segment_sum`` call, the segment-sum kernel on the
card. With ``remat=True`` each chunk body runs under a non-reentrant
checkpoint and re-runs once in the backward, so a calculate launches the
kernel (1 + num_layers) x 2K times for K chunks. The SO(2) and FFN
products are plain matrix products here, as they are outside any Pallas
kernel in the JAX package.

``dtype="bfloat16"`` (``distmlip_tpu/models/escn_md.py:314-325``): the
parameters are cast to bf16 except ``species_ref`` and ``energy_head``;
geometry (the fp32 Wigner core, the distance expansion) and the energy
readout stay in the positions' dtype. The segment sums accumulate in fp32
and round once, and the per-edge gathers of node rows accumulate their
gradients in fp32 (``ops/nn.gather_rows``).

A block-diagonally packed batch with ``num_experts > 1`` raises, with the
JAX package's message (its gate pools the whole graph's composition).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.dispatch import fused_segment_sum
from ..ops import radial
from ..ops.chunk import chunk_layout, scan_accumulate
from ..ops.nn import cast_params_subtrees, gather_rows
from ..ops.so3_e3nn import CoeffLayout, wigner_blocks_from_edges
from ..telemetry.trace import scope
from ..utils.checkpoint import as_list


@dataclass(frozen=True)
class ESCNMDConfig:
    max_num_elements: int = 100
    sphere_channels: int = 64       # C
    lmax: int = 2
    mmax: int = 2
    num_layers: int = 2
    hidden_channels: int = 64       # SO(2) conv hidden width
    edge_channels: int = 32         # species embeddings + rad_func hidden
    num_distance_basis: int = 64    # gaussian smearing resolution
    # fairchem's GaussianSmearing: sigma = basis_width_scalar x the offset
    # spacing; a module attribute, not a checkpoint tensor, so conversion
    # cannot recover it (2.0 in the eSCN/equiformer_v2/UMA lineage)
    basis_width_scalar: float = 2.0
    cutoff: float = 5.0
    avg_degree: float = 14.0        # edge-degree + message rescale factor
    num_experts: int = 1            # > 1: MOLE mixtures of the SO(2) weights
    # csd conditioning (UMA charge/spin/dataset)
    num_charges: int = 25
    charge_min: int = -12
    num_spins: int = 10
    num_datasets: int = 4
    use_envelope: bool = True       # smooth cutoff on messages + edge degree
    edge_chunk: int = 32768         # edges per chunk (0 = one chunk)
    remat: bool = True              # checkpoint each edge chunk
    dtype: str = "float32"          # compute dtype: "float32" or "bfloat16"

    @property
    def sphere_dim(self) -> int:
        return (self.lmax + 1) ** 2


def _uniform(gen, shape, lim):
    return (torch.rand(shape, generator=gen) * 2 - 1) * lim


def _linear_init(gen, d_in, d_out, bias=True):
    """fairchem/torch ``nn.Linear`` layout: w (d_out, d_in), b (d_out,)."""
    lim = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (d_out, d_in), lim)}
    if bias:
        p["b"] = _uniform(gen, (d_out,), lim)
    return p


def _rad_init(gen, dims):
    """RadialFunction: Linear -> LayerNorm -> SiLU per intermediate stage,
    a bare Linear last. dims = [in, hidden, out]."""
    p = {"lins": [], "lns": []}
    for i in range(len(dims) - 1):
        p["lins"].append(_linear_init(gen, dims[i], dims[i + 1]))
        if i < len(dims) - 2:
            p["lns"].append({"g": torch.ones((dims[i + 1],)),
                             "b": torch.zeros((dims[i + 1],))})
    return p


def _rad_apply(p, x):
    """``distmlip_tpu/models/escn_md.py:116-126``: the LayerNorm with the
    biased variance and eps 1e-5."""
    lins, lns = as_list(p["lins"]), as_list(p["lns"])
    for i, lin in enumerate(lins):
        x = F.linear(x, lin["w"], lin.get("b"))
        if i < len(lins) - 1:
            mu = x.mean(-1, keepdim=True)
            var = x.var(-1, keepdim=True, unbiased=False)
            x = (x - mu) * torch.rsqrt(var + 1e-5) * lns[i]["g"] + lns[i]["b"]
            x = F.silu(x)
    return x


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device):
    """A host index list on ``device``, made once (a host copy per call
    would synchronise the host with the card at every chunk)."""
    return torch.tensor(values, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _float_table(values: tuple, dtype, device):
    return torch.tensor(values, dtype=torch.float64).to(device=device, dtype=dtype)


class ESCNMD:
    supports_compute_dtype = True  # energy_fn honours cfg.dtype="bfloat16"

    def __init__(self, config: ESCNMDConfig = ESCNMDConfig()):
        if config.lmax > 6:
            raise NotImplementedError("lmax > 6: extend ops/so3 tables")
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"ESCNMD dtype={config.dtype!r}: float32 or bfloat16")
        self.cfg = config
        lay = self.lay = CoeffLayout(config.lmax, config.mmax)
        # the m-major order of the narrowed stack (m = 0, then +m and -m
        # per |m|): each |m|'s rows contiguous, l = m..lmax within; and its
        # inverse, which puts m-major rows back in the l-major stack
        order = list(lay.plus_idx[0])
        for m in range(1, lay.m_max + 1):
            order += list(lay.plus_idx[m]) + list(lay.minus_idx[m])
        inv = np.empty(lay.size, dtype=np.int64)
        inv[np.array(order)] = np.arange(lay.size)
        self._m_major = tuple(int(i) for i in order)
        self._l_major = tuple(int(i) for i in inv)
        # the degree l of each of the (lmax+1)^2 full-layout coefficients
        self._l_of_s = tuple(l for l in range(config.lmax + 1) for _ in range(2 * l + 1))
        # degree-balanced RMS-norm weights, built in float64 on the host
        # (each degree contributes equally to the norm)
        self._balance = tuple(1.0 / ((2 * l + 1) * (config.lmax + 1)) for l in self._l_of_s)
        self._rad_splits = [lay.m_size(m) for m in range(lay.m_max + 1)]

    # ---- parameters (shapes mirror the fairchem state dict 1:1) ----
    def init(self, seed: int = 0) -> dict:
        """Random parameters in the JAX package's tree layout, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's RNG stream)."""
        cfg, lay = self.cfg, self.lay
        gen = torch.Generator().manual_seed(int(seed))
        C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
        Dx = cfg.num_distance_basis + 2 * Ce
        K = cfg.num_experts
        randn = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731

        def so2_weights(c_in, c_out, extra_m0, internal):
            m0_in = lay.m_size(0) * c_in
            m0_out = lay.m_size(0) * c_out + extra_m0
            p = {"m0": _uniform(gen, ((K,) if K > 1 else ()) + (m0_out, m0_in),
                                1.0 / math.sqrt(m0_in)),
                 "m0_b": torch.zeros((m0_out,))}
            for m in range(1, lay.m_max + 1):
                nl = lay.m_size(m)
                p[f"m{m}"] = _uniform(gen, ((K,) if K > 1 else ()) + (2 * nl * c_out, nl * c_in),
                                      1.0 / math.sqrt(nl * c_in))
            if not internal:
                p["rad"] = _rad_init(gen, [Dx, Ce, sum(self._rad_splits) * c_in])
            return p

        params = {
            "sphere_embedding": {"w": randn(cfg.max_num_elements, C)},
            "source_embedding": {"w": randn(cfg.max_num_elements, Ce)},
            "target_embedding": {"w": randn(cfg.max_num_elements, Ce)},
            "csd": {
                "charge": {"w": randn(cfg.num_charges, C)},
                "spin": {"w": randn(cfg.num_spins, C)},
                "dataset": {"w": randn(cfg.num_datasets, C)},
                "mix": _linear_init(gen, 3 * C, C),
            },
            "edge_deg_rad": _rad_init(gen, [Dx, Ce, (cfg.lmax + 1) * C]),
            "blocks": [],
            "norm": {"w": torch.ones((cfg.lmax + 1, C))},
            "energy_head": {"lin1": _linear_init(gen, C, C), "lin2": _linear_init(gen, C, 1)},
            "species_ref": {"w": torch.zeros((cfg.max_num_elements,))},
        }
        if K > 1:
            params["mole_gate"] = {"lin1": _linear_init(gen, 2 * C, C),
                                   "lin2": _linear_init(gen, C, K)}
        for _ in range(cfg.num_layers):
            params["blocks"].append({
                "norm1": {"w": torch.ones((cfg.lmax + 1, C))},
                "so2_1": so2_weights(2 * C, H, cfg.lmax * H, internal=False),
                "so2_2": so2_weights(H, C, 0, internal=True),
                "ff_norm": {"w": torch.ones((cfg.lmax + 1, C))},
                "ff": {
                    "lin1": {"w": randn(cfg.lmax + 1, H, C) / math.sqrt(C),
                             "b": torch.zeros((H,))},
                    "gate": _linear_init(gen, C, cfg.lmax * H),
                    "lin2": {"w": randn(cfg.lmax + 1, C, H) / math.sqrt(H),
                             "b": torch.zeros((C,))},
                },
            })
        return params

    # ---- building blocks ----
    def _rms_norm_sh(self, w, x):
        """Degree-balanced RMS norm with a per-(l, channel) affine weight:
        each coefficient weighted 1/(2l+1)/(lmax+1), no centring, no bias."""
        bal = _float_table(self._balance, x.dtype, x.device)
        ms = (x * x * bal[:, None]).sum(-2).mean(-1)
        x = x * torch.rsqrt(ms + 1e-12)[..., None, None]
        return x * w.to(x.dtype).index_select(0, _index(self._l_of_s, x.device))

    def _so2_conv(self, p, Ws, fr, rad_scale, c_in, c_out):
        """SO(2) convolution on edge-frame features fr (E_c, S_nar, c_in)
        with the (expert-mixed) weights ``Ws`` = [W_0, W_1, ...] per |m|.

        Per |m| the (l >= m) coefficients flatten l-major to (nl c_in) and
        pass through one linear map; m > 0 mixes the (cos, sin) pair as
        y+ = W_r f+ - W_i f-, y- = W_r f- + W_i f+ (fairchem's fc output =
        [real | imag] halves). ``rad_scale`` scales each input coefficient,
        the same for the +m and -m partners. Returns the l-major output and
        the m = 0 block's extra outputs (the gate scalars; width 0 when
        there are none)."""
        lay = self.lay
        E = fr.shape[0]
        fm_all = fr.index_select(1, _index(self._m_major, fr.device))
        parts, extra = [], None
        row = off = 0
        for m in range(lay.m_max + 1):
            nl = lay.m_size(m)
            if m == 0:
                f0 = fm_all[:, row:row + nl].reshape(E, nl * c_in)
                if rad_scale is not None:
                    f0 = f0 * rad_scale[:, off:off + nl * c_in]
                out0 = F.linear(f0, Ws[0], p["m0_b"].to(fr.dtype))
                extra = out0[:, nl * c_out:]
                parts.append(out0[:, :nl * c_out].reshape(E, nl, c_out))
                row += nl
            else:
                fp = fm_all[:, row:row + nl].reshape(E, nl * c_in)
                fm = fm_all[:, row + nl:row + 2 * nl].reshape(E, nl * c_in)
                if rad_scale is not None:
                    s = rad_scale[:, off:off + nl * c_in]
                    fp, fm = fp * s, fm * s
                d_out = nl * c_out
                Wr, Wi = Ws[m][:d_out], Ws[m][d_out:]
                parts.append((F.linear(fp, Wr) - F.linear(fm, Wi)).reshape(E, nl, c_out))
                parts.append((F.linear(fm, Wr) + F.linear(fp, Wi)).reshape(E, nl, c_out))
                row += 2 * nl
            off += nl * c_in
        y = torch.cat(parts, dim=1).index_select(1, _index(self._l_major, fr.device))
        return y, extra

    def _gate_act(self, x, gates, full_layout=False):
        """Scalars -> silu; the l > 0 coefficients scaled by sigmoid(per-l
        gate scalars) broadcast over m. ``full_layout`` takes the
        (lmax+1)^2 node blocks instead of the mmax-narrowed edge-frame
        blocks."""
        cfg, lay = self.cfg, self.lay
        g = torch.sigmoid(gates.reshape(gates.shape[0], cfg.lmax, cfg.hidden_channels))
        parts = [F.silu(x[:, :1])]
        for l in range(1, cfg.lmax + 1):
            sl = slice(l * l, l * l + 2 * l + 1) if full_layout else lay.block_slices[l]
            parts.append(x[:, sl] * g[:, l - 1, None, :])
        return torch.cat(parts, dim=1)

    def _so3_linear(self, w, b, x):
        """Per-degree linear map: (N, S, a) -> (N, S, b) with (lmax+1, b, a)
        weights, the bias on the l = 0 row."""
        parts = [x[:, l * l:(l + 1) ** 2] @ w[l].to(x.dtype).T for l in range(self.cfg.lmax + 1)]
        parts[0] = parts[0] + b.to(x.dtype)
        return torch.cat(parts, dim=1)

    def _ffn(self, p, x):
        """Per-l SO3 linear -> gate activation -> SO3 linear, the gates from
        the input scalars (``distmlip_tpu/models/escn_md.py:296-311``)."""
        gates = F.linear(x[:, 0, :], p["gate"]["w"], p["gate"]["b"])
        h = self._so3_linear(p["lin1"]["w"], p["lin1"]["b"], x)
        h = self._gate_act(h, gates, full_layout=True)
        return self._so3_linear(p["lin2"]["w"], p["lin2"]["b"], h)

    # ---- forward ----
    def energy_fn(self, params, lg, positions):
        cfg, lay = self.cfg, self.lay
        C, H, S, L = cfg.sphere_channels, cfg.hidden_channels, cfg.sphere_dim, cfg.lmax
        dev, acc_dtype = positions.device, positions.dtype
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else acc_dtype
        if cfg.dtype == "bfloat16":
            params = cast_params_subtrees(params, dtype,
                                          keep_fp32=("species_ref", "energy_head"))

        # fairchem's edge vector is pos[src] - pos[dst]; lg.edge_vectors is
        # dst - src
        vec = -lg.edge_vectors(positions)
        emask = lg.edge_mask
        d = torch.linalg.norm(torch.where(emask[:, None], vec, torch.ones_like(vec)), dim=-1)
        # masked (padding) edges get a fixed safe direction: atan2's
        # gradient at the origin is NaN
        safe = torch.tensor([0.0, 0.0, 1.0], dtype=acc_dtype, device=dev)
        rhat = torch.where(emask[:, None], vec / torch.clamp(d, min=1e-9)[:, None], safe)
        env = (radial.polynomial_cutoff(d, cfg.cutoff) * emask if cfg.use_envelope
               else emask.to(acc_dtype)).to(dtype)
        # gaussian smearing over [0, cutoff], sigma = basis_width_scalar x
        # the centre spacing
        centers = _float_table(tuple(np.linspace(0.0, cfg.cutoff, cfg.num_distance_basis)),
                               acc_dtype, dev)
        width = cfg.basis_width_scalar * cfg.cutoff / (cfg.num_distance_basis - 1)
        gauss = torch.exp(-0.5 * ((d[:, None] - centers) / width) ** 2).to(dtype)

        z = lg.species
        zemb = params["sphere_embedding"]["w"].index_select(0, z).to(dtype)

        # csd (charge/spin/dataset) system embedding
        sys_state = lg.system or {}

        def sys_index(key, offset, size):
            v = torch.as_tensor(sys_state.get(key, 0), device=dev).reshape(1).long()
            return torch.clamp(v - offset, 0, size - 1)

        csd_p = params["csd"]
        csd = F.linear(torch.cat([
            csd_p["charge"]["w"].index_select(
                0, sys_index("charge", cfg.charge_min, cfg.num_charges)),
            csd_p["spin"]["w"].index_select(0, sys_index("spin", 0, cfg.num_spins)),
            csd_p["dataset"]["w"].index_select(0, sys_index("dataset", 0, cfg.num_datasets)),
        ], dim=-1).to(dtype), csd_p["mix"]["w"], csd_p["mix"]["b"])[0]  # (C,)

        h0 = zemb + csd[None, :]
        h = torch.cat([h0[:, None, :], h0.new_zeros((h0.shape[0], S - 1, C))], dim=1)

        # MOLE coefficients: the owned atoms' mean species embedding (summed
        # over partitions) and the csd vector -> softmax gate
        if cfg.num_experts > 1:
            if lg.struct_id is not None and lg.batch_size > 0:
                raise NotImplementedError(
                    "ESCNMD's MOLE gate pools composition per system; "
                    "batched (packed) graphs would mix structures. Use "
                    "models.escn.ESCN for batched inference, or "
                    "num_experts=1.")
            owned = lg.owned_mask.to(dtype)[:, None]
            comp = lg.psum((zemb * owned).sum(0))
            count = lg.psum(owned.sum())
            gate_in = torch.cat([comp / torch.clamp(count, min=1.0), csd])
            gp = params["mole_gate"]
            g = F.silu(F.linear(gate_in, gp["lin1"]["w"], gp["lin1"]["b"]))
            mole = torch.softmax(F.linear(g, gp["lin2"]["w"], gp["lin2"]["b"]), dim=-1)
        else:
            mole = None

        def mixed(p):
            """A convolution's per-|m| weights, the experts collapsed once
            for every chunk by the MOLE coefficients."""
            ws = [p[f"m{m}"] for m in range(lay.m_max + 1)]
            if mole is None:
                return ws
            return [torch.einsum("k,kab->ab", mole.to(w.dtype), w) for w in ws]

        # --- edge-chunked passes, aligned to the interior/frontier split:
        # every chunk's dst stays sorted
        row_idx, row_valid, K, _ = chunk_layout(
            lg.e_cap, cfg.edge_chunk, lg.e_split if lg.has_frontier_split else None)
        rows = torch.as_tensor(row_idx, dtype=torch.long, device=dev)
        take = lambda x: x.index_select(0, rows)  # noqa: E731
        edge_xs = (take(lg.edge_src), take(lg.edge_dst),
                   take(emask) & torch.as_tensor(row_valid, device=dev),
                   take(rhat), take(gauss), take(env))

        def rotate_in(hvecs, D):
            """Lab (E_c, S_full, c) -> edge frame (E_c, S_nar, c): the
            transposed blocks, the centre 2 min(l, mmax) + 1 rows kept."""
            return torch.cat([
                torch.bmm(D[l][:, :, lay.block_rows(l)].transpose(1, 2).to(hvecs.dtype),
                          hvecs[:, l * l:(l + 1) ** 2])
                for l in range(L + 1)], dim=1)

        def rotate_out(y, D):
            """Edge frame (E_c, S_nar, c) -> lab (E_c, S_full, c)."""
            return torch.cat([
                torch.bmm(D[l][:, :, lay.block_rows(l)].to(y.dtype), y[:, lay.block_slices[l]])
                for l in range(L + 1)], dim=1)

        def edge_scan(per_chunk):
            """Sum over the edge chunks of per_chunk(...)'s (E_c, S, C)
            message rows, segment-summed onto their dst in each chunk."""

            def body(srcc, dstc, maskc, rhatc, gaussc, envc):
                D = wigner_blocks_from_edges(L, rhatc)
                msg = per_chunk(srcc, dstc, D, gaussc, envc)
                return fused_segment_sum(msg, dstc, lg.n_cap, maskc,
                                         indices_are_sorted=True, kernels=lg.kernels)

            return scan_accumulate(body, edge_xs, K, remat=cfg.remat)

        def edge_scalars(srcc, dstc, gaussc):
            return torch.cat([
                gaussc,
                params["source_embedding"]["w"].index_select(0, z.index_select(0, srcc)).to(dtype),
                params["target_embedding"]["w"].index_select(0, z.index_select(0, dstc)).to(dtype),
            ], dim=-1)

        # --- edge-degree embedding: radial weights in the edge frame's m = 0
        # slots, rotated to the lab frame (only each D_l's centre column
        # meets a nonzero coefficient), degree-summed onto the receiver
        def deg_chunk(srcc, dstc, D, gaussc, envc):
            w = _rad_apply(params["edge_deg_rad"], edge_scalars(srcc, dstc, gaussc))
            w = w.reshape(-1, L + 1, C)
            y = torch.cat([D[l][:, :, l:l + 1].to(dtype) * w[:, l:l + 1, :]
                           for l in range(L + 1)], dim=1)
            return y * envc[:, None, None]

        inv_deg = torch.tensor(1.0 / cfg.avg_degree, dtype=dtype, device=dev)
        h = h + edge_scan(deg_chunk) * inv_deg
        h = lg.halo_exchange(h)

        for i, blk in enumerate(as_list(params["blocks"])):
            with scope(f"escn_md/block{i}"):
                # the message path reads the NORMALISED features with the system
                # embedding re-injected into the scalars; the residual keeps h
                hn = self._rms_norm_sh(blk["norm1"]["w"], h)
                hn = torch.cat([hn[:, :1] + csd[None, None, :], hn[:, 1:]], dim=1)
                W1, W2 = mixed(blk["so2_1"]), mixed(blk["so2_2"])

                def so2_chunk(srcc, dstc, D, gaussc, envc, blk=blk, hn=hn, W1=W1, W2=W2):
                    rad = _rad_apply(blk["so2_1"]["rad"], edge_scalars(srcc, dstc, gaussc))
                    fr = torch.cat([rotate_in(gather_rows(hn, srcc), D),
                                    rotate_in(gather_rows(hn, dstc), D)], dim=-1)
                    y, gates = self._so2_conv(blk["so2_1"], W1, fr, rad, 2 * C, H)
                    y = self._gate_act(y, gates)
                    y, _ = self._so2_conv(blk["so2_2"], W2, y, None, H, C)
                    return rotate_out(y, D) * envc[:, None, None]

                h = h + edge_scan(so2_chunk) * inv_deg
                # FFN with pre-norm and residual
                h = h + self._ffn(blk["ff"], self._rms_norm_sh(blk["ff_norm"]["w"], h))
                h = lg.halo_exchange(h)

        with scope("escn_md/readout"):
            h = self._rms_norm_sh(params["norm"]["w"], h)
            s = h[:, 0, :].to(acc_dtype)
            head = params["energy_head"]
            e = F.linear(F.silu(F.linear(s, head["lin1"]["w"], head["lin1"]["b"])),
                         head["lin2"]["w"], head["lin2"]["b"])[:, 0]
            return e + params["species_ref"]["w"].index_select(0, z).to(acc_dtype)
