"""CHGNet: charge-informed message passing with bond and angle graphs, torch.

Port of ``distmlip_tpu/models/chgnet.py`` (matgl's CHGNet
parameterization, so converted matgl checkpoints carry across). Same
configuration, parameter tree, layouts and arithmetic, so weights carried
across from the JAX package give the same energies and magmoms:

- learnable radial bessel bases for bonds and three-body bonds, with
  matgl's polynomial cutoff applied to the expansion VALUES, and the
  learnable interleaved Fourier angle basis;
- shared per-edge/per-bond rbf weight linears (``atom_bond_w``,
  ``bond_bond_w``, ``three_bond_w``);
- per block: the atom-graph conv (gated-MLP messages ``[v_src | v_dst |
  e] * abw`` summed to dst, bias-free out linear, residual) through
  ``LocalGraph.overlapped_edge_sum`` with the named message
  ``CHGNET_ATOM_CONV``; then the bond-graph conv: the line-graph node
  phase (``[b_src | b_dst | angle | v_center]`` messages summed to the dst
  bond through ``fused_edge_aggregate`` with ``CHGNET_LINE_CONV``) and the
  angle update. On the card both aggregations are the fused CUDA kernels
  of ``kernels/csrc/chgnet_aggregate.cu``; the gated MLP's weights go to
  them as explicit tensors;
- the sitewise readout (magmoms) runs BEFORE the final atom conv and the
  final MLP after it (matgl's order); ``energy_and_aux_fn`` returns both
  from one forward.

Skin-shell edges and bonds (beyond the cutoffs, kept for graph reuse in
MD) are masked out of every basis and message (``in_r``, ``b_real``,
``line_ok``), as the JAX model does.

``dtype="bfloat16"`` (``distmlip_tpu/models/chgnet.py:190-310``): the
features, messages and GEMMs run in bf16, the parameters cast but for the
basis frequencies, ``sitewise``, ``final``, ``species_ref`` and
``data_std``; geometry (``vec``, ``d``, the bond geometry, the cosines and
``theta``) stays in the positions' dtype, and the bases ``rbf``, ``rbf3``
and the Fourier expansion are cast after their masks. The sitewise readout
takes the features in float32 and ``_trunk`` returns them in float32, so
the readouts and the magmoms are float32. On the card both aggregations
launch the bf16 variants of their kernels (bf16 rows in, fp32 arithmetic
and accumulation, one rounding an output element; the row projections'
tables fp32); the chunked backward keeps the JAX dispatcher's fp32 views.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import CHGNET_ATOM_CONV, CHGNET_LINE_CONV, Gather, fused_edge_aggregate
from ..ops import radial
from ..ops.nn import (cast_params_subtrees, embedding, gated_mlp, gated_mlp_init,
                      gated_mlp_weights, linear, linear_init, mlp, mlp_init)
from ..utils.checkpoint import as_list


@dataclass(frozen=True)
class CHGNetConfig:
    """matgl CHGNet hyperparameters (``distmlip_tpu/models/chgnet.py:58``)."""

    num_species: int = 95     # len(element_types)
    units: int = 64           # dim_atom/bond/angle_embedding (matgl: all 64)
    num_rbf: int = 9          # max_n — radial bessel basis size
    num_angle: int = 4        # max_f — Fourier angle basis -> 2*max_f+1 feats
    num_blocks: int = 4
    cutoff: float = 5.0
    bond_cutoff: float = 3.0  # threebody_cutoff
    cutoff_exponent: int = 5
    atom_conv_hidden: tuple | None = None    # default (units,)
    bond_conv_hidden: tuple | None = None    # default (units,)
    angle_update_hidden: tuple = ()          # matgl default: single layer
    bond_update_hidden: tuple | None = None  # matgl default: no atom-graph edge update
    shared_bond_weights: str | None = "both"  # None|"bond"|"threebody"|"both"
    final_hidden: tuple | None = None        # default (units, units)
    num_site_targets: int = 1                # sitewise_readout width (magmom)
    use_bond_graph: bool = True
    dtype: str = "float32"    # compute dtype: "float32" or "bfloat16"

    @property
    def angle_dim(self) -> int:
        return 2 * self.num_angle + 1

    @property
    def _atom_hidden(self):
        return self.atom_conv_hidden if self.atom_conv_hidden is not None else (self.units,)

    @property
    def _bond_hidden(self):
        return self.bond_conv_hidden if self.bond_conv_hidden is not None else (self.units,)

    @property
    def _final_hidden(self):
        return self.final_hidden if self.final_hidden is not None else (self.units, self.units)


# the parameter subtrees that stay float32 at a bf16 compute dtype: the basis
# frequencies, the readout heads and the reference energies
# (distmlip_tpu/models/chgnet.py:196-204)
KEEP_FP32 = ("freq_bond", "freq_three", "freq_angle", "sitewise", "final", "species_ref",
             "data_std")


class CHGNet:
    supports_compute_dtype = True  # _trunk honours cfg.dtype="bfloat16"

    def __init__(self, config: CHGNetConfig = CHGNetConfig()):
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"CHGNet dtype={config.dtype!r}: float32 or bfloat16")
        self.cfg = config

    # ---- parameters ----
    def init(self, seed: int = 0) -> dict:
        """Random parameters in the JAX package's tree layout, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's RNG stream)."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(seed))
        C, R, A = cfg.units, cfg.num_rbf, cfg.angle_dim
        params = {
            # learnable basis frequencies (matgl learn_basis=True)
            "freq_bond": torch.pi * torch.arange(1, R + 1, dtype=torch.float32),
            "freq_three": torch.pi * torch.arange(1, R + 1, dtype=torch.float32),
            "freq_angle": torch.arange(0, cfg.num_angle + 1, dtype=torch.float32),
            "atom_emb": {"w": torch.randn((cfg.num_species, C), generator=gen)},
            "bond_emb": mlp_init(gen, [R, C]),
            "angle_emb": mlp_init(gen, [A, C]),
            "atom_blocks": [],
            "bond_blocks": [],
            "sitewise": linear_init(gen, C, cfg.num_site_targets),
            "final": mlp_init(gen, [C] + list(cfg._final_hidden) + [1]),
            "species_ref": {"w": torch.zeros((cfg.num_species, 1))},
            "data_std": torch.ones(()),
        }
        sw = cfg.shared_bond_weights
        if sw in ("bond", "both"):
            params["atom_bond_w"] = linear_init(gen, R, C, bias=False)
            params["bond_bond_w"] = linear_init(gen, R, C, bias=False)
        if sw in ("threebody", "both"):
            params["three_bond_w"] = linear_init(gen, R, C, bias=False)
        for _ in range(cfg.num_blocks):
            blk = {
                "node_update": gated_mlp_init(gen, 3 * C, list(cfg._atom_hidden) + [C]),
                "node_out": linear_init(gen, C, C, bias=False),
            }
            if cfg.bond_update_hidden is not None:
                blk["edge_update"] = gated_mlp_init(
                    gen, 3 * C, list(cfg.bond_update_hidden) + [C])
                blk["edge_out"] = linear_init(gen, C, C, bias=False)
            params["atom_blocks"].append(blk)
        if cfg.use_bond_graph:
            for _ in range(cfg.num_blocks - 1):
                params["bond_blocks"].append({
                    "node_update": gated_mlp_init(gen, 4 * C, list(cfg._bond_hidden) + [C]),
                    "node_out": linear_init(gen, C, C, bias=False),
                    "angle_update": gated_mlp_init(
                        gen, 4 * C, list(cfg.angle_update_hidden) + [C]),
                })
        return params

    # ---- forward ----
    def _readout(self, params, lg, v):
        e_atom = mlp(as_list(params["final"]), v)[:, 0]
        e_ref = params["species_ref"]["w"][lg.species.long(), 0]
        return params["data_std"] * e_atom + e_ref

    def energy_fn(self, params, lg, positions):
        """Per-atom energies (n_cap,) of the local graph."""
        v, _ = self._trunk(params, lg, positions)
        return self._readout(params, lg, v)

    def energy_and_aux_fn(self, params, lg, positions):
        """Per-atom energies plus the sitewise outputs (magmoms) from the
        SAME forward pass: the runtime's ``aux=True`` contract."""
        v, site = self._trunk(params, lg, positions)
        return self._readout(params, lg, v), {"magmoms": torch.abs(site[:, 0])}

    def magmom_fn(self, params, lg, positions):
        """Site-wise magnetic moments (absolute value) from a forward of
        their own; ``energy_and_aux_fn`` gives them with the energies."""
        _, site = self._trunk(params, lg, positions)
        return torch.abs(site[:, 0])

    def _expansion(self, d, freq, cutoff):
        """matgl bond_expansion: the learnable bessel basis with the
        polynomial cutoff applied elementwise to the expansion values."""
        rbf = radial.radial_bessel(d, freq, cutoff)
        env = radial.matgl_polynomial_cutoff(rbf, cutoff, self.cfg.cutoff_exponent)
        return env * rbf

    def _trunk(self, params, lg, positions):
        """Returns (atom features after the LAST conv, sitewise readout taken
        BEFORE it, matgl's ordering)."""
        cfg = self.cfg
        C = cfg.units
        # features and GEMMs in the compute dtype; geometry, the basis
        # frequencies and the readout heads in the positions' dtype
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else positions.dtype
        fp = params
        if cfg.dtype == "bfloat16":
            params = cast_params_subtrees(params, dtype, keep_fp32=KEEP_FP32)
        atom_blocks = as_list(params["atom_blocks"])
        bond_blocks = as_list(params["bond_blocks"])

        # --- geometry + bases ---
        vec = lg.edge_vectors(positions)
        emask = lg.edge_mask[:, None]
        d = torch.linalg.norm(torch.where(emask, vec, torch.ones_like(vec)), dim=-1)
        # skin-shell edges (cutoff < d <= cutoff + skin) are not in matgl's
        # graph: masked out of the basis and of every message
        in_r = lg.edge_mask & (d <= cfg.cutoff)
        rbf = (self._expansion(d, fp["freq_bond"], cfg.cutoff)
               * in_r[:, None].to(d.dtype)).to(dtype)

        v = embedding(params["atom_emb"], lg.species.long())          # (N, C)
        e = mlp(as_list(params["bond_emb"]), rbf)                      # (E, C)
        abw = linear(params["atom_bond_w"], rbf) if "atom_bond_w" in params else None
        bbw = linear(params["bond_bond_w"], rbf) if "bond_bond_w" in params else None

        use_bg = cfg.use_bond_graph and lg.has_bond_graph and len(bond_blocks) > 0
        if use_bg:
            # bond-node geometry seeded from the edges, exchanged with the
            # atom features at one sync point (the identity at P=1)
            bgeo = torch.zeros((lg.b_cap, 4), dtype=positions.dtype, device=positions.device)
            bgeo = lg.edge_to_bond(torch.cat([vec, d[:, None]], dim=-1), bgeo)
            (vx,), (bgeo,) = lg.exchange_all((v,), (bgeo,))
            b_vec, b_d = bgeo[:, :3], bgeo[:, 3]
            # padded bond rows have d = 0; skin-shell bonds (d > bond_cutoff)
            # are excluded like skin-shell edges
            b_real = (b_d > 1e-6) & (b_d <= cfg.bond_cutoff)
            rbf3 = self._expansion(torch.where(b_d > 1e-6, b_d, torch.ones_like(b_d)),
                                   fp["freq_three"], cfg.bond_cutoff)
            rbf3 = (rbf3 * b_real[:, None].to(rbf3.dtype)).to(dtype)
            tbw = linear(params["three_bond_w"], rbf3) if "three_bond_w" in params else None

            # a line edge is live only when both bonds are real
            line_ok = (lg.line_mask & b_real.index_select(0, lg.line_src)
                       & b_real.index_select(0, lg.line_dst))

            # angle at the center atom (src_bond_sign = -1)
            v1 = b_vec.index_select(0, lg.line_src)
            v2 = b_vec.index_select(0, lg.line_dst)
            d1 = torch.clamp(b_d.index_select(0, lg.line_src), min=1e-6)
            d2 = torch.clamp(b_d.index_select(0, lg.line_dst), min=1e-6)
            cos_t = -(v1 * v2).sum(-1) / (d1 * d2)
            cos_t = torch.clamp(cos_t, -1.0 + 1e-6, 1.0 - 1e-6)
            theta = torch.arccos(cos_t)
            a = mlp(as_list(params["angle_emb"]),
                    radial.matgl_fourier_expansion(theta, fp["freq_angle"]).to(dtype))  # (L, C)
            b = torch.zeros((lg.b_cap, C), dtype=e.dtype, device=e.device)
        else:
            vx = lg.halo_exchange(v)

        # --- message-passing blocks ---
        for i in range(cfg.num_blocks - 1):
            v, e = self._atom_conv(atom_blocks[i], lg, v, vx, e, abw, bbw, in_r)
            if use_bg:
                b = lg.edge_to_bond(e, b)
                (vx,), (b,) = lg.exchange_all((v,), (b,))
                blk = bond_blocks[i]
                b = self._bond_node_conv(blk, lg, vx, b, a, tbw, line_ok)
                e = lg.bond_to_edge(b, e)
                if i + 2 < cfg.num_blocks:
                    # after the last bond block nothing reads b or a: no
                    # exchange and no angle update there
                    _, (b,) = lg.exchange_all((), (b,))
                    a = self._angle_conv(blk, lg, vx, b, a, line_ok)
            else:
                vx = lg.halo_exchange(v)

        # sitewise readout BEFORE the last atom conv, on the float32 head
        site = linear(fp["sitewise"], vx.to(positions.dtype))

        # final atom conv; the readouts use owned rows only
        v, e = self._atom_conv(atom_blocks[-1], lg, v, vx, e, abw, bbw, in_r)
        return v.to(positions.dtype), site

    # ---- layers ----
    def _atom_conv(self, blk, lg, v, vx, e, abw, bbw, in_r):
        """matgl CHGNetGraphConv: optional gated edge update (plain torch),
        then gated node messages weighted per edge, summed to dst, bias-free
        out linear, residual. ``in_r`` masks padded AND skin-shell edges."""
        if "edge_update" in blk:
            feats = torch.cat([vx.index_select(0, lg.edge_src),
                               vx.index_select(0, lg.edge_dst), e], dim=-1)
            m = linear(blk["edge_out"], gated_mlp(blk["edge_update"], feats))
            if bbw is not None:
                m = m * bbw
            e = e + m * in_r[:, None].to(m.dtype)

        edge_data = (e,) if abw is None else (e, abw)
        agg = lg.overlapped_edge_sum(CHGNET_ATOM_CONV, v, vx, edge_data, mask=in_r,
                                     weights=gated_mlp_weights(blk["node_update"]))
        return vx + linear(blk["node_out"], agg), e

    def _bond_node_conv(self, blk, lg, v, b, a, tbw, line_ok):
        """Line-graph node phase: ``[b_src | b_dst | angle | v_center]``
        messages summed to the dst bond through the fused dispatcher, out
        linear, per-bond rbf weights after the aggregation, residual."""
        agg = fused_edge_aggregate(
            CHGNET_LINE_CONV,
            [Gather(b, lg.line_src), Gather(b, lg.line_dst), a, Gather(v, lg.line_center)],
            lg.line_dst, lg.b_cap, line_ok, indices_are_sorted=True, kernels=lg.kernels,
            weights=gated_mlp_weights(blk["node_update"]))
        upd = linear(blk["node_out"], agg)
        if tbw is not None:
            upd = upd * tbw
        return b + upd

    def _angle_conv(self, blk, lg, v, b, a, line_ok):
        """Line-graph edge phase: gated update of the angle features from
        ``[b_src | b_dst | angle | v_center]``, residual, no weights."""
        feats = torch.cat([b.index_select(0, lg.line_src), b.index_select(0, lg.line_dst),
                           a, v.index_select(0, lg.line_center)], dim=-1)
        m = gated_mlp(blk["angle_update"], feats)
        return a + m * line_ok[:, None].to(m.dtype)
