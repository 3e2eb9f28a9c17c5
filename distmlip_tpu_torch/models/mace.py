"""MACE: higher-order equivariant message passing (ACE product basis), torch.

Port of ``distmlip_tpu/models/mace.py`` (Batatia et al. 2022; reference
implementations/mace/models.py:45-220). Same configuration, parameter tree,
layouts and arithmetic, so weights carried across from the JAX package give
the same energies:

- equivariant node features are a dict ``{l: (N, 2l+1, C)}``, channels last;
- the density projection folds every (l_h, l_Y, l_out) Clebsch-Gordan path
  into one block matrix (``_projection_tables``) and runs per edge chunk:
      A_i^{l3} = (1/avg_n) sum_j sum_{l1,l2} R^{l1l2l3}(r_ij) *
                 CG[(l1,l2,l3)] (h_j^{l1}, Y^{l2}(r_ij))
  with ONE dst-sorted segment sum per chunk carrying all Q path
  components — the call that launches the CUDA segment-sum kernel
  (``kernels/dispatch.fused_segment_sum``);
- the symmetric contraction uses MACE's U-matrix form (orthonormal
  symmetric coupling bases per (l_out, correlation)), Horner-style over
  node chunks;
- per-layer invariant readouts accumulate into the site energy under
  scale/shift + E0s, with multi-head selection.

Rematerialization: with ``remat=True`` every edge chunk and node chunk runs
under ``torch.utils.checkpoint``, so the backward holds one chunk's
intermediates at a time. The JAX package also checkpoints each whole
interaction; in PyTorch that outer checkpoint would re-run every inner
chunk forward a second time in the backward, so the port keeps only the
per-chunk checkpoints (which bound the same per-edge memory).

With ``zbl=True`` the ZBL screened pair repulsion of MACE-MP-0b
(``models/pair.py`` ``zbl_edge_energy``, half per directed edge) joins the
interaction energies inside scale/shift; its per-atom edge sum is one
``aggregate_edges`` call at width 1, so it launches the segment-sum kernel
once more per calculate (per edge segment of a split graph).

``dtype="bfloat16"`` (``distmlip_tpu/models/mace.py:320-383``, ``:410-445``,
``:492-580``): features, messages and every GEMM of the interactions run in
bf16 (the bessel/envelope features, the spherical harmonics, ``h``, the
interaction's parameters, the projection and coupling tables, ``1/avg``);
geometry, the site energies, ``scale``/``shift``, the readouts and ZBL stay
in the positions' dtype. The segment sums accumulate in fp32 and round to
bf16 once (the bf16 kernel on the card), and the per-edge gather of the
sender rows accumulates its gradient in fp32 (``ops/nn.gather_rows``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.dispatch import fused_segment_sum
from ..ops import radial
from ..ops.chunk import chunk_layout, remat_wrap, scan_accumulate
from ..ops.nn import (cast_params_subtrees, gather_rows, linear, linear_init, linear_init_vp,
                      mlp, mlp_init, mlp_init_vp)
from ..ops.so3 import real_clebsch_gordan, spherical_harmonics, symmetric_coupling_basis
from ..utils.checkpoint import as_list


@dataclass(frozen=True)
class MACEConfig:
    num_species: int = 95
    channels: int = 64
    l_max: int = 3            # spherical-harmonic order on edges
    a_lmax: int = 2           # irreps kept in the density A / product basis
    hidden_lmax: int = 1      # irreps of hidden node features (0..L)
    correlation: int = 3      # body order - 1 (ACE correlation)
    num_interactions: int = 2
    scalar_last: bool = True  # only scalar (l=0) hidden features out of the
                              # final interaction/product (upstream MACE)
    num_bessel: int = 8
    radial_mlp: int = 64
    radial_layers: int = 3    # hidden layers in the radial MLP (no biases)
    radial_scale: float = 16.0  # INIT-time gain folded into the radial MLP's
                                # output layer; not applied at runtime
    cutoff: float = 5.0
    cutoff_p: int = 6         # polynomial-envelope power
    avg_num_neighbors: float = 14.0
    num_heads: int = 1        # multi-head readouts (per-head E0s/scale/
    head: int = 0             # shift/readout columns); ``head`` is evaluated
    zbl: bool = False         # ZBL screened pair repulsion under the
                              # learned potential (MACE-MP-0b)
    atomic_numbers: tuple | None = None  # species index -> Z (for ZBL);
                                         # None: species index + 1
    remat: bool = True        # checkpoint each edge/node chunk
    edge_chunk: int = 32768   # edges per chunk of the density projection
                              # (0 disables chunking)
    node_chunk: int = 4096    # nodes per chunk of the symmetric contraction
    dtype: str = "float32"   # compute dtype: "float32" or "bfloat16"


def _triangle(l1, l2, l3):
    return abs(l1 - l2) <= l3 <= l1 + l2


def _message_paths(h_ls, l_max, out_ls):
    """(l_h, l_Y, l_out) combos for the density projection: parity-filtered
    (l_h + l_Y + l_out even, as upstream MACE's conv_tp) and sorted by
    output irrep (upstream's instruction order) — required for weight
    parity."""
    paths = [
        (lh, ly, lo)
        for lh in h_ls
        for ly in range(l_max + 1)
        for lo in out_ls
        if _triangle(lh, ly, lo) and (lh + ly + lo) % 2 == 0
    ]
    return sorted(paths, key=lambda p: p[2])


def _projection_tables(h_ls, l_max, paths):
    """Density projection tables: fold ALL (l_h, l_Y, l_out) CG couplings
    into one dense block matrix.

        W[(l_h m) * S_Y + (l_Y n), q(path, p)] = CG^{l_h l_Y l_out}[m, n, p]

    Per edge chunk the contraction is factored through the channel-free
    intermediate T[e, m, q] = sum_n Y[e, n] W[(m, n), q], then
    M[e, q, c] = sum_m T[e, m, q] h_src[e, m, c].

    Returns dict with: W (K, Q) float64, q_path (Q,) path index per column,
    h_off {l: row-block offset}, S_h, S_Y, and lo_cols {l_out: (P_l, 2l+1)}
    column groups for the per-path output mixing.
    """
    S_Y = (l_max + 1) ** 2
    h_off = {}
    off = 0
    for l in h_ls:
        h_off[l] = off
        off += 2 * l + 1
    S_h = off
    y_off = {l: l * l for l in range(l_max + 1)}

    Q = sum(2 * lo + 1 for (_, _, lo) in paths)
    W = np.zeros((S_h * S_Y, Q))
    q_path = np.zeros(Q, dtype=np.int32)
    cols_by_lo: dict[int, list] = {}
    q = 0
    for pi, (lh, ly, lo) in enumerate(paths):
        cg = real_clebsch_gordan(lh, ly, lo)  # (2lh+1, 2ly+1, 2lo+1)
        mi = h_off[lh] + np.arange(2 * lh + 1)
        ni = y_off[ly] + np.arange(2 * ly + 1)
        rows = (mi[:, None] * S_Y + ni[None, :]).reshape(-1)
        W[np.ix_(rows, np.arange(q, q + 2 * lo + 1))] = cg.reshape(-1, 2 * lo + 1)
        q_path[q : q + 2 * lo + 1] = pi
        cols_by_lo.setdefault(lo, []).append(np.arange(q, q + 2 * lo + 1))
        q += 2 * lo + 1
    lo_cols = {lo: np.stack(cols) for lo, cols in cols_by_lo.items()}
    return {
        "W": W, "q_path": q_path, "h_off": h_off, "S_h": S_h, "S_Y": S_Y,
        "lo_cols": lo_cols,
    }


class MACE:
    supports_compute_dtype = True  # energy_fn honours cfg.dtype="bfloat16"

    def __init__(self, config: MACEConfig = MACEConfig()):
        self.cfg = config
        c = config
        if not 0 <= c.head < c.num_heads:
            raise ValueError(
                f"head={c.head} out of range for num_heads={c.num_heads}"
            )
        if c.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"MACE dtype={c.dtype!r}: float32 or bfloat16")
        self.h_ls0 = [0]
        self.h_ls = list(range(c.hidden_lmax + 1))
        self.a_ls = list(range(c.a_lmax + 1))
        self.h_ls_in: list[list[int]] = []
        self.h_ls_out: list[list[int]] = []
        prev = self.h_ls0
        for t in range(c.num_interactions):
            self.h_ls_in.append(prev)
            out = (
                [0]
                if (c.scalar_last and t == c.num_interactions - 1)
                else self.h_ls
            )
            self.h_ls_out.append(out)
            prev = out
        self.msg_paths = [
            _message_paths(self.h_ls_in[t], c.l_max, self.a_ls)
            for t in range(c.num_interactions)
        ]
        self.proj = [
            _projection_tables(self.h_ls_in[t], c.l_max, self.msg_paths[t])
            for t in range(c.num_interactions)
        ]
        # ACE product basis: orthonormal symmetric U tensors per
        # (l_out, correlation), shared across interactions
        self.prod_U = {
            l: {
                nu: symmetric_coupling_basis(tuple(self.a_ls), l, nu)
                for nu in range(1, c.correlation + 1)
            }
            for l in self.h_ls
        }
        self._const_cache: dict = {}

    # ---- parameters ----
    def init(self, seed: int = 0) -> dict:
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` (CPU float32 tensors; the JAX package's tree layout and
        distributions, not its random stream)."""
        cfg = self.cfg
        C = cfg.channels
        gen = torch.Generator().manual_seed(int(seed))
        randn = lambda *shape: torch.randn(shape, generator=gen)
        params = {
            "species_emb": {"w": randn(cfg.num_species, C)},
            "species_ref": {"w": torch.zeros((cfg.num_heads, cfg.num_species))},
            "scale": torch.ones((cfg.num_heads,)),
            "shift": torch.zeros((cfg.num_heads,)),
            "interactions": [],
        }
        if cfg.zbl:
            params["zbl"] = {"a_exp": torch.tensor(0.300),
                             "a_prefactor": torch.tensor(0.4543)}
        for t in range(cfg.num_interactions):
            n_paths = len(self.msg_paths[t])
            in_ls, out_ls = self.h_ls_in[t], self.h_ls_out[t]
            radial_mlp = mlp_init_vp(
                gen, [cfg.num_bessel] + [cfg.radial_mlp] * cfg.radial_layers
                + [n_paths * C])
            radial_mlp[-1]["w"] = radial_mlp[-1]["w"] * cfg.radial_scale
            n_lo = {l: self.proj[t]["lo_cols"][l].shape[0] for l in self.a_ls}
            inter = {
                "lin_up": {str(l): linear_init_vp(gen, C, C) for l in in_ls},
                "radial": radial_mlp,
                "lin_A": {
                    str(l): randn(n_lo[l], C, C) / math.sqrt(n_lo[l] * C)
                    for l in self.a_ls
                },
                "product": {
                    str(l): {
                        f"w{nu}": randn(cfg.num_species, U.shape[-1], C)
                        / math.sqrt(U.shape[-1])
                        for nu, U in self.prod_U[l].items()
                        if U is not None
                    }
                    for l in out_ls
                },
                "lin_msg": {str(l): linear_init_vp(gen, C, C) for l in out_ls},
                "lin_res": {
                    str(l): randn(cfg.num_species, C, C) / math.sqrt(C)
                    for l in out_ls
                    if l in in_ls
                },
                "readout": (
                    mlp_init(gen, [C, 16, cfg.num_heads], bias=False)
                    if t == cfg.num_interactions - 1
                    else [linear_init(gen, C, cfg.num_heads, bias=False)]
                ),
            }
            params["interactions"].append(inter)
        return params

    def _consts(self, device, dtype):
        """Per-device tensors of the host tables (projection block matrices,
        path/column indices, transposed U bases), built once."""
        key = (str(device), dtype)
        cached = self._const_cache.get(key)
        if cached is not None:
            return cached
        as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                                  device=device)
        per_t = []
        for proj in self.proj:
            per_t.append({
                "Wp3": as_t(proj["W"].reshape(proj["S_h"], proj["S_Y"], -1)),
                "q_path": as_t(proj["q_path"], torch.long),
                "lo_cols": {l: as_t(v, torch.long)
                            for l, v in proj["lo_cols"].items()},
            })
        # U stored (S,)*nu + (d, k) -> transpose to (d, S..., k)
        U_t = {l: {nu: as_t(np.moveaxis(U, -2, 0))
                   for nu, U in Us.items() if U is not None}
               for l, Us in self.prod_U.items()}
        cached = self._const_cache[key] = (per_t, U_t)
        return cached

    # ---- packing helpers for the halo exchange ----
    def _pack(self, h):
        return torch.cat(
            [h[l].reshape(h[l].shape[0], -1) for l in sorted(h)], dim=-1)

    def _unpack(self, flat, ls, C):
        out = {}
        o = 0
        for l in ls:
            d = C * (2 * l + 1)
            out[l] = flat[:, o : o + d].reshape(-1, 2 * l + 1, C)
            o += d
        return out

    # ---- forward ----
    def energy_fn(self, params, lg, positions):
        cfg = self.cfg
        C = cfg.channels
        # geometry stays in the positions dtype; features and messages run
        # in the compute dtype; per-atom energy terms accumulate in the
        # positions dtype (bf16 has too few mantissa bits for them)
        acc_dtype = positions.dtype
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else acc_dtype
        per_t, U_t = self._consts(positions.device, dtype)

        vec = lg.edge_vectors(positions)
        emask = lg.edge_mask
        d = torch.linalg.norm(
            torch.where(emask[:, None], vec, torch.ones_like(vec)), dim=-1)
        rhat = vec / torch.clamp(d, min=1e-9)[:, None]
        env = (radial.polynomial_cutoff(d, cfg.cutoff, p=cfg.cutoff_p) * emask).to(dtype)
        # envelope multiplies the bessel features BEFORE the radial MLP
        # (upstream's RadialEmbeddingBlock); the bias-free MLP maps 0 -> 0
        bessel = (radial.spherical_bessel_basis(d, cfg.cutoff, cfg.num_bessel)
                  * env[:, None]).to(dtype)
        Y_full = torch.cat(
            [spherical_harmonics(l, rhat) for l in range(cfg.l_max + 1)],
            dim=-1).to(dtype)                              # (E, S_Y)

        # edge-chunk layout, shared by every interaction, aligned to the
        # interior/frontier split: every chunk's dst stays sorted (the
        # kernel's CSR offsets depend on it)
        row_idx, row_valid, K, _ = chunk_layout(
            lg.e_cap, cfg.edge_chunk, lg.e_split if lg.has_frontier_split else None)
        rows = torch.as_tensor(row_idx, dtype=torch.long, device=positions.device)
        valid = torch.as_tensor(row_valid, device=positions.device)
        edges = (lg.edge_src[rows], lg.edge_dst[rows], emask[rows] & valid,
                 Y_full[rows], bessel[rows])

        z = lg.species
        h = {0: params["species_emb"]["w"][z][:, None, :].to(dtype)}
        h = self._unpack(lg.halo_exchange(self._pack(h)), [0], C)

        head = cfg.head
        e_site = params["species_ref"]["w"][head][z].to(acc_dtype)
        acc = torch.zeros(positions.shape[0], dtype=acc_dtype, device=positions.device)
        if cfg.zbl:
            # ZBL joins the interaction energies inside scale * (...) +
            # shift, as upstream ScaleShiftMACE sums pair_node_energy into
            # them (distmlip_tpu/models/mace.py:353-360)
            acc = acc + self._zbl_site(params, lg, d)
        interactions = as_list(params["interactions"])
        for t, inter in enumerate(interactions):
            h = self._interaction(inter, h, lg=lg, edges=edges, K=K, z=z, t=t,
                                  consts=per_t[t], U_t=U_t)
            h = self._unpack(lg.halo_exchange(self._pack(h)), self.h_ls_out[t], C)

            # invariant readout (head column selected), in the positions
            # dtype on the uncast readout weights: the JAX package's bf16
            # scalars times its fp32 weights promote to fp32
            scalars = h[0][:, 0, :].to(acc_dtype)
            readout = as_list(inter["readout"])
            if t == cfg.num_interactions - 1:
                r_out = mlp(readout, scalars)[:, head]
            else:
                r_out = linear(readout[0], scalars)[:, head]
            acc = acc + r_out

        scale = params["scale"][head].to(acc_dtype)
        shift = params["shift"][head].to(acc_dtype)
        return e_site + scale * acc + shift

    def _zbl_site(self, params, lg, d):
        """Per-atom ZBL pair repulsion, half per directed edge
        (``distmlip_tpu/models/mace.py:385-407``): one width-1 segment sum
        of the masked edge energies onto their dst atoms."""
        from .pair import zbl_edge_energy

        cfg = self.cfg
        if cfg.atomic_numbers is not None:
            z_of = torch.as_tensor(np.asarray(cfg.atomic_numbers, dtype=np.int32),
                                   device=d.device)
        else:
            z_of = torch.arange(1, cfg.num_species + 1, dtype=torch.int32, device=d.device)
        z_num = z_of[lg.species]
        e_edge = zbl_edge_energy(z_num[lg.edge_src], z_num[lg.edge_dst], d,
                                 a_exp=params["zbl"]["a_exp"],
                                 a_prefactor=params["zbl"]["a_prefactor"], p=cfg.cutoff_p)
        e_edge = torch.where(lg.edge_mask, e_edge, torch.zeros_like(e_edge))
        return 0.5 * lg.aggregate_edges(e_edge[:, None])[:, 0]

    def _interaction(self, inter, h, *, lg, edges, K, z, t, consts, U_t):
        """One MACE interaction: density projection + symmetric contraction +
        linear update."""
        cfg = self.cfg
        C = cfg.channels
        dtype = h[0].dtype
        # the whole interaction in the compute dtype: its parameters cast
        # (a no-op in float32)
        inter = cast_params_subtrees(inter, dtype)
        n_nodes = h[0].shape[0]
        h_ls = self.h_ls_in[t]
        out_ls = self.h_ls_out[t]
        n_paths = len(self.msg_paths[t])
        Wp3 = consts["Wp3"]                                # (S_h, S_Y, Q)
        q_path = consts["q_path"]                          # (Q,)

        # sender features, channel-mixed per l, packed (N, S_h, C)
        hu = torch.cat(
            [torch.einsum("nmc,cd->nmd", h[l], inter["lin_up"][str(l)]["w"])
             for l in h_ls],
            dim=1,
        )
        radial_w = as_list(inter["radial"])

        def chunk_body(srcc, dstc, maskc, Yc, besc):
            Rc = mlp(radial_w, besc).reshape(besc.shape[0], n_paths, C)
            # factor the CG contraction: T[e,m,q] = sum_n Y[e,n] W[(m,n),q]
            # is channel-free and tiny; contracting it with h_src over m
            # costs S_h multiply-adds per (q, c)
            T = torch.einsum("en,mnq->emq", Yc, Wp3)
            M = torch.einsum("emq,emc->eqc", T, gather_rows(hu, srcc))  # (E_c, Q, C)
            M = M * Rc[:, q_path, :]                       # per-path radial
            return fused_segment_sum(M, dstc, n_nodes, maskc,
                                     indices_are_sorted=True,
                                     kernels=lg.kernels)

        A_all = scan_accumulate(chunk_body, edges, K, remat=cfg.remat)
        # per-path output mixing on nodes (upstream's post-conv_tp linear)
        inv_avg = torch.tensor(1.0 / cfg.avg_num_neighbors, dtype=dtype, device=A_all.device)
        A = {
            l: torch.einsum(
                "npmc,pcd->nmd",
                A_all[:, consts["lo_cols"][l]] * inv_avg,
                inter["lin_A"][str(l)],
            )
            for l in self.a_ls
        }

        # ---- symmetric contraction (ACE product basis, U-matrix form) ----
        A_flat = torch.cat([A[l] for l in self.a_ls], dim=1)  # (N, S_A, C)
        h_in_ls = [l for l in h_ls if l in h]
        h_flat = torch.cat([h[l] for l in h_in_ls], dim=1)
        nchunk = cfg.node_chunk if cfg.node_chunk > 0 else n_nodes
        nchunk = min(nchunk, n_nodes)
        Kn = -(-n_nodes // nchunk)
        padn = Kn * nchunk - n_nodes

        def padn_c(x):
            if padn == 0:
                return x
            return torch.cat([x, x.new_zeros((padn,) + tuple(x.shape[1:]))])

        def node_body(Ac, zc, hc):
            outs = []
            for l in out_ls:
                B = self._sym_contract(inter["product"][str(l)], U_t[l], Ac, zc)
                m = torch.einsum("nmc,cd->nmd", B, inter["lin_msg"][str(l)]["w"])
                if l in h_in_ls and str(l) in inter["lin_res"]:
                    off = sum(2 * ll + 1 for ll in h_in_ls if ll < l)
                    hl = hc[:, off : off + 2 * l + 1, :]
                    Wr = inter["lin_res"][str(l)][zc]       # (n, C, C)
                    m = m + torch.einsum("nmc,ncd->nmd", hl, Wr)
                outs.append(m)
            return torch.cat(outs, dim=1)

        body = remat_wrap(node_body, cfg.remat)
        parts = [body(Ac, zc, hc) for Ac, zc, hc in zip(
            torch.chunk(padn_c(A_flat), Kn), torch.chunk(padn_c(z), Kn),
            torch.chunk(padn_c(h_flat), Kn))]
        out_flat = (parts[0] if Kn == 1 else torch.cat(parts))[:n_nodes]

        h_new = {}
        o = 0
        for l in out_ls:
            d = 2 * l + 1
            h_new[l] = out_flat[:, o : o + d, :]
            o += d
        return h_new

    def _sym_contract(self, wts, U_t, Ac, zc):
        """B(A)[n, d, c] = sum_nu W_nu[z_n] . U_nu . A^(x nu) — evaluated
        highest correlation first in Horner form (MACE's contraction order:
        each step adds the next-lower U.W block, then contracts one A index).
        Ac: (n, S_A, C); returns (n, 2l+1, C)."""
        numax = max(U_t)
        letters = "uvwxy"
        w = {nu: wts[f"w{nu}"][zc] for nu in U_t}         # (n, k, C)
        s_in = letters[: numax - 1]
        # G[n,k,q,c] = w[n,k,c] A[n,q,c]: fold the path and last tensor
        # index into one contraction of U against G
        G = torch.einsum("nkc,nqc->nkqc", w[numax], Ac)
        t = torch.einsum(f"d{s_in}qk,nkqc->nd{s_in}c", U_t[numax], G)
        for nu in range(numax - 1, 0, -1):
            s_cur = letters[:nu]
            if nu in U_t:
                t = t + torch.einsum(f"d{s_cur}k,nkc->nd{s_cur}c", U_t[nu], w[nu])
            t = torch.einsum(f"nd{s_cur}c,n{s_cur[-1]}c->nd{s_cur[:-1]}c", t, Ac)
        return t
