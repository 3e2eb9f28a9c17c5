"""Synthetic upstream-named state dicts for the port's ``from_torch``, built
from the port's model configs with numpy only (no JAX, no upstream
package), so ``chip_smoke.py`` can convert full-width checkpoints on the
card.

- ``mace_state_dict(model, rng)``: mace-torch ``ScaleShiftMACE`` names and
  layouts for a port ``MACE`` (flat e3nn Linear weights, per-instruction
  blocks, U-matrix buffers in a rotated basis of the same coupling space,
  optional ZBL buffers). It draws from ``rng`` in the order of
  ``tests/test_convert.py``'s ``synthetic_mace_state_dict``, so one seed
  gives that dict value for value.
- ``chgnet_state_dict(cfg, rng)``: the names and shapes of matgl CHGNet's
  module tree (``tests/test_convert_chgnet.py``'s ``TCHGNet``).
- ``tensornet_state_dict(cfg, rng)``: matgl TensorNet's
  (``tests/test_convert_tensornet.py``'s ``TTensorNet``), with the
  bessel-frequency buffer of a real checkpoint.
- ``escn_state_dict(cfg, rng)``: fairchem ``eSCNMDBackbone`` names
  (``backbone.`` prefix, ``heads.energy.mlp``), the SO(2) weights stacked
  on a leading expert axis when ``cfg.num_experts > 1``
  (``tests/test_convert_escn.py``'s ``synthetic_escn_state_dict``).

Linear weights are N(0, 1/fan_in) and biases N(0, 0.1^2) (MACE's raw e3nn
weights N(0, 1), as upstream stores them before its path normalisation).
``tests/test_torch_convert.py`` holds every dict's names and shapes
against the JAX tests' dicts.
"""

from __future__ import annotations

import numpy as np


def _rand_orth(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return q


def mace_state_dict(model, rng):
    """A ScaleShiftMACE-named state dict for ``model``'s config."""
    from distmlip_tpu_torch.models.pair import COVALENT_RADII
    from distmlip_tpu_torch.ops.so3 import symmetric_coupling_basis

    cfg = model.cfg
    S, C, H = cfg.num_species, cfg.channels, cfg.num_heads
    sd = {}
    r = lambda *shape: rng.normal(size=shape).astype(np.float64)  # noqa: E731

    sd["atomic_numbers"] = (np.arange(1, S + 1) if cfg.atomic_numbers is None
                            else np.asarray(cfg.atomic_numbers))
    sd["r_max"] = np.array(cfg.cutoff)
    sd["num_interactions"] = np.array(cfg.num_interactions)
    sd["node_embedding.linear.weight"] = r(S * C)
    sd["atomic_energies_fn.atomic_energies"] = r(S)
    sd["radial_embedding.bessel_fn.bessel_weights"] = np.pi * np.arange(1, cfg.num_bessel + 1)
    sd["radial_embedding.cutoff_fn.p"] = np.array(float(cfg.cutoff_p))
    sd["radial_embedding.cutoff_fn.r_max"] = np.array(cfg.cutoff)

    a_ls = tuple(model.a_ls)
    S_A = sum(2 * l + 1 for l in a_ls)
    for t in range(cfg.num_interactions):
        h_ls_in, h_ls_out = model.h_ls_in[t], model.h_ls_out[t]
        res_ls = [l for l in h_ls_out if l in h_ls_in]
        pre = f"interactions.{t}."
        sd[pre + "linear_up.weight"] = r(len(h_ls_in) * C * C)
        sd[pre + "linear_up.output_mask"] = np.ones(1)
        n_paths = len(model.msg_paths[t])
        dims = [cfg.num_bessel] + [cfg.radial_mlp] * cfg.radial_layers + [n_paths * C]
        for li, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            sd[pre + f"conv_tp_weights.layer{li}.weight"] = r(a, b)
        sd[pre + "linear.weight"] = r(n_paths * C * C)
        sd[pre + "linear.output_mask"] = np.ones(1)
        sd[pre + "skip_tp.weight"] = r(len(res_ls) * C * S * C)
        sd[pre + "skip_tp.output_mask"] = np.ones(1)

        ppre = f"products.{t}."
        for i, l in enumerate(h_ls_out):
            cpre = ppre + f"symmetric_contractions.contractions.{i}."
            numax = cfg.correlation
            for nu in range(1, numax + 1):
                U = symmetric_coupling_basis(a_ls, l, nu)
                k = U.shape[-1]
                flat = U.reshape(-1, k) @ _rand_orth(rng, k)  # same span, new basis
                up = flat.reshape((S_A,) * nu + (2 * l + 1, k))
                sd[cpre + f"U_matrix_{nu}"] = np.moveaxis(up, nu, 0)  # upstream: d leading
                key = "weights_max" if nu == numax else f"weights.{numax - 1 - nu}"
                sd[cpre + key] = r(S, k, C)
        sd[ppre + "linear.weight"] = r(len(h_ls_out) * C * C)
        sd[ppre + "linear.output_mask"] = np.ones(1)

        rpre = f"readouts.{t}."
        if t == cfg.num_interactions - 1:
            sd[rpre + "linear_1.weight"] = r(C * 16)
            sd[rpre + "linear_2.weight"] = r(16 * H)
            sd[rpre + "linear_1.output_mask"] = np.ones(1)
            sd[rpre + "linear_2.output_mask"] = np.ones(1)
        else:
            sd[rpre + "linear.weight"] = r(C * H)
            sd[rpre + "linear.output_mask"] = np.ones(1)

    sd["scale_shift.scale"] = np.array(0.8)
    sd["scale_shift.shift"] = np.array(-0.1)
    if cfg.zbl:
        sd["pair_repulsion_fn.a_exp"] = np.array(0.3)
        sd["pair_repulsion_fn.a_prefactor"] = np.array(0.4543)
        sd["pair_repulsion_fn.c"] = np.array([0.18175, 0.50986, 0.28022, 0.02817])
        # upstream stores ase's covalent-radii table (119 entries)
        radii = np.full(119, 0.2)
        radii[: len(COVALENT_RADII)] = COVALENT_RADII
        sd["pair_repulsion_fn.covalent_radii"] = radii
        sd["pair_repulsion_fn.p"] = np.array(float(cfg.cutoff_p))
    return sd


def _linear(sd, rng, name, d_out, d_in, bias=True, experts=0):
    shape = ((experts,) if experts > 1 else ()) + (d_out, d_in)
    sd[name + ".weight"] = rng.normal(size=shape) / np.sqrt(d_in)
    if bias:
        sd[name + ".bias"] = 0.1 * rng.normal(size=(d_out,))


def _mlp(sd, rng, prefix, dims, seq="layers"):
    """matgl MLP: Linears at even positions of ``seq``, activations between."""
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        _linear(sd, rng, f"{prefix}.{seq}.{2 * j}", b, a)


def _gated_mlp(sd, rng, prefix, dims):
    _mlp(sd, rng, prefix, dims, "layers")
    _mlp(sd, rng, prefix, dims, "gates")


def chgnet_state_dict(cfg, rng):
    """A matgl CHGNet-named state dict for a port ``CHGNetConfig``."""
    S, C, R, F = cfg.num_species, cfg.units, cfg.num_rbf, cfg.num_angle
    sd = {
        "bond_expansion.frequencies": np.pi * np.arange(1, R + 1),
        "threebody_bond_expansion.frequencies": np.pi * np.arange(1, R + 1),
        "angle_expansion.frequencies": np.arange(0, F + 1, dtype=np.float64),
        "atom_embedding.weight": rng.normal(size=(S, C)),
    }
    _mlp(sd, rng, "bond_embedding", [R, C])
    _mlp(sd, rng, "angle_embedding", [2 * F + 1, C])
    for name in ("atom_bond_weights", "bond_bond_weights", "threebody_bond_weights"):
        _linear(sd, rng, name, C, R, bias=False)
    for i in range(cfg.num_blocks):
        pre = f"atom_graph_layers.{i}.conv_layer."
        _gated_mlp(sd, rng, pre + "node_update_func", [3 * C, *cfg._atom_hidden, C])
        _linear(sd, rng, pre + "node_out_func", C, C, bias=False)
    for i in range(cfg.num_blocks - 1):
        pre = f"bond_graph_layers.{i}.conv_layer."
        _gated_mlp(sd, rng, pre + "node_update_func", [4 * C, *cfg._bond_hidden, C])
        _linear(sd, rng, pre + "node_out_func", C, C, bias=False)
        _gated_mlp(sd, rng, pre + "edge_update_func", [4 * C, *cfg.angle_update_hidden, C])
    _linear(sd, rng, "sitewise_readout", cfg.num_site_targets, C)
    final = cfg.final_hidden if cfg.final_hidden is not None else (C, C)
    _mlp(sd, rng, "final_layer", [C, *final, 1])
    return sd


def tensornet_state_dict(cfg, rng):
    """A matgl TensorNet-named state dict for a port ``TensorNetConfig``,
    with the bessel frequencies of ``bond_expansion``."""
    S, C, R = cfg.num_species, cfg.units, cfg.num_rbf
    te = "tensor_embedding."
    sd = {te + "emb.weight": rng.normal(size=(S, C))}
    _linear(sd, rng, te + "emb2", C, 2 * C)
    for i in range(3):
        _linear(sd, rng, te + f"distance_proj{i + 1}", C, R)
    _linear(sd, rng, te + "linears_scalar.0", 2 * C, C)
    _linear(sd, rng, te + "linears_scalar.1", 3 * C, 2 * C)
    for i in range(3):
        _linear(sd, rng, te + f"linears_tensor.{i}", C, C, bias=False)
    sd[te + "init_norm.weight"] = 1.0 + 0.1 * rng.normal(size=(C,))
    sd[te + "init_norm.bias"] = 0.1 * rng.normal(size=(C,))
    for t in range(cfg.num_layers):
        pre = f"layers.{t}."
        _linear(sd, rng, pre + "linears_scalar.0", C, R)
        _linear(sd, rng, pre + "linears_scalar.1", 2 * C, C)
        _linear(sd, rng, pre + "linears_scalar.2", 3 * C, 2 * C)
        for i in range(6):
            _linear(sd, rng, pre + f"linears_tensor.{i}", C, C, bias=False)
    sd["out_norm.weight"] = 1.0 + 0.1 * rng.normal(size=(3 * C,))
    sd["out_norm.bias"] = 0.1 * rng.normal(size=(3 * C,))
    _linear(sd, rng, "linear", C, 3 * C)
    _mlp(sd, rng, "final_layer.gated", [C, *cfg._final_hidden, 1])
    sd["bond_expansion.rbf.frequencies"] = np.pi * np.arange(1, R + 1)
    return sd


def _rad(sd, rng, prefix, d_in, d_hidden, d_out):
    _linear(sd, rng, prefix + ".net.0", d_hidden, d_in)
    sd[prefix + ".net.1.weight"] = 1.0 + 0.1 * rng.normal(size=(d_hidden,))
    sd[prefix + ".net.1.bias"] = 0.1 * rng.normal(size=(d_hidden,))
    _linear(sd, rng, prefix + ".net.3", d_out, d_hidden)


def escn_state_dict(cfg, rng):
    """A fairchem eSCNMDBackbone-named state dict (``backbone.`` prefix and
    ``heads.energy.mlp``) for a port ``ESCNMDConfig``."""
    from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout

    lay = CoeffLayout(cfg.lmax, cfg.mmax)
    Z, C, H, CE = cfg.max_num_elements, cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    L, K = cfg.lmax, cfg.num_experts
    DX = cfg.num_distance_basis + 2 * CE
    b = "backbone."
    sd = {
        b + "sphere_embedding.weight": rng.normal(size=(Z, C)),
        b + "source_embedding.weight": rng.normal(size=(Z, CE)),
        b + "target_embedding.weight": rng.normal(size=(Z, CE)),
        b + "csd_embedding.charge_embedding.weight": rng.normal(size=(cfg.num_charges, C)),
        b + "csd_embedding.spin_embedding.weight": rng.normal(size=(cfg.num_spins, C)),
        b + "csd_embedding.dataset_embedding.weight": rng.normal(size=(cfg.num_datasets, C)),
    }
    _linear(sd, rng, b + "csd_embedding.mix_csd", C, 3 * C)
    sd[b + "distance_expansion.offset"] = np.linspace(0.0, cfg.cutoff, cfg.num_distance_basis)
    _rad(sd, rng, b + "edge_degree_embedding.rad_func", DX, CE, (L + 1) * C)
    rad_len = sum(lay.m_size(m) for m in range(lay.m_max + 1)) * 2 * C
    for i in range(cfg.num_layers):
        bp = f"{b}blocks.{i}"
        sd[bp + ".norm_1.affine_weight"] = 1.0 + 0.1 * rng.normal(size=(L + 1, C))
        # so2_conv_1: in 2C, out H, extra gate scalars L H
        _rad(sd, rng, bp + ".so2_conv_1.rad_func", DX, CE, rad_len)
        _linear(sd, rng, bp + ".so2_conv_1.fc_m0", lay.m_size(0) * H + L * H,
                lay.m_size(0) * 2 * C, experts=K)
        for m in range(1, lay.m_max + 1):
            nl = lay.m_size(m)
            _linear(sd, rng, f"{bp}.so2_conv_1.so2_m_conv.{m - 1}.fc", 2 * nl * H, nl * 2 * C,
                    bias=False, experts=K)
        # so2_conv_2: in H, out C, internal weights
        _linear(sd, rng, bp + ".so2_conv_2.fc_m0", lay.m_size(0) * C, lay.m_size(0) * H,
                experts=K)
        for m in range(1, lay.m_max + 1):
            nl = lay.m_size(m)
            _linear(sd, rng, f"{bp}.so2_conv_2.so2_m_conv.{m - 1}.fc", 2 * nl * C, nl * H,
                    bias=False, experts=K)
        sd[bp + ".ff_norm.affine_weight"] = 1.0 + 0.1 * rng.normal(size=(L + 1, C))
        sd[bp + ".ff.so3_linear_1.weight"] = rng.normal(size=(L + 1, H, C)) / np.sqrt(C)
        sd[bp + ".ff.so3_linear_1.bias"] = 0.1 * rng.normal(size=(H,))
        _linear(sd, rng, bp + ".ff.gating_linear", L * H, C)
        sd[bp + ".ff.so3_linear_2.weight"] = rng.normal(size=(L + 1, C, H)) / np.sqrt(H)
        sd[bp + ".ff.so3_linear_2.bias"] = 0.1 * rng.normal(size=(C,))
    sd[b + "norm.affine_weight"] = 1.0 + 0.1 * rng.normal(size=(L + 1, C))
    _linear(sd, rng, "heads.energy.mlp.0", C, C)
    _linear(sd, rng, "heads.energy.mlp.2", 1, C)
    return sd
