"""Weight ingestion on the port: ``distmlip_tpu_torch.models.convert``
against the JAX package's ``from_torch``, and the converted models against
the JAX package and the torch oracles.

For each family the same upstream-named synthetic dict goes through both
converters: ``tests/test_convert.py``'s ``synthetic_mace_state_dict`` (the
``SMALL`` MACE with ZBL), ``tests/test_convert_chgnet.py``'s ``TCHGNet``,
``tests/test_convert_tensornet.py``'s ``TTensorNet`` and
``tests/test_convert_escn.py``'s ``synthetic_escn_state_dict``, onto the
same initial tree (the port model's ``init`` as numpy, the JAX model's
tree layout). The trees must be equal leaf for leaf, bit for
bit, with zero unmapped tensors on both sides.

Tolerances: float32 energy, forces and stress through the port's
``DistPotential(device="cpu")`` against the JAX package's
``DistPotential(num_partitions=1)`` on the converted parameters: rel dE <
1e-5, max |dF|, |dS| < 1e-4 (both sides float32, summed in different
orders). Against the float64 torch oracles, the JAX tests' bars on float64
graphs and parameters (CHGNet E rtol 1e-9, F rtol 1e-7 atol 1e-9, magmoms
1e-9; TensorNet E 1e-9, F rtol 1e-7 atol 1e-10; eSCN |dE|/atom < 1e-9, F
atol 1e-8). MACE has no oracle module: its converted radial chain is held
to e3nn's FullyConnectedNet semantics (rtol 1e-4) and its basis change to
the upstream contraction tensor (atol 1e-8), as ``tests/test_convert.py``
does.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import tests.test_convert_chgnet as tc
import tests.test_convert_escn as te
import tests.test_convert_tensornet as tt
from distmlip_tpu import models as jmodels
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models.convert import from_torch as jax_from_torch
from distmlip_tpu_torch import models
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models.convert import MAPPINGS, from_torch
from distmlip_tpu_torch.neighbors import neighbor_list_numpy
from distmlip_tpu_torch.ops.nn import mlp, silu_2mom_gain
from distmlip_tpu_torch.ops.so3 import symmetric_coupling_basis
from distmlip_tpu_torch.parallel import make_potential_fn
from distmlip_tpu_torch.partition import build_partitioned_graph, build_plan
from distmlip_tpu_torch.tools import export_upstream, verify_upstream
from distmlip_tpu_torch.utils import params_from_numpy
from tests import torch_upstream_dicts as upstream
from tests.test_convert import SMALL, synthetic_mace_state_dict
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.utils import make_crystal

FAMILIES = ("mace", "chgnet", "tensornet", "escn")
MACE_KW = dict(SMALL.__dict__)
CHGNET_KW = dict(num_species=tc.S, units=tc.C, num_rbf=tc.R, num_angle=tc.F,
                 num_blocks=tc.NB, cutoff=tc.CUT, bond_cutoff=tc.BCUT)
TENSORNET_KW = dict(num_species=tt.S, units=tt.C, num_rbf=tt.R, num_layers=tt.NL,
                    cutoff=tt.CUT)
ESCN_KW = dict(te.CFG.__dict__)
KW = {"mace": MACE_KW, "chgnet": CHGNET_KW, "tensornet": TENSORNET_KW, "escn": ESCN_KW}
JAX_CLS = {"mace": (jmodels.MACE, jmodels.MACEConfig),
           "chgnet": (jmodels.CHGNet, jmodels.CHGNetConfig),
           "tensornet": (jmodels.TensorNet, jmodels.TensorNetConfig),
           "escn": (jmodels.ESCNMD, jmodels.ESCNMDConfig)}
PORT_CLS = {"mace": (models.MACE, models.MACEConfig),
            "chgnet": (models.CHGNet, models.CHGNetConfig),
            "tensornet": (models.TensorNet, models.TensorNetConfig),
            "escn": (models.ESCNMD, models.ESCNMDConfig)}
# the JAX float32 evaluation's structure per family: (a, species, info);
# CHGNet's bond cutoff 2.0 Å needs the 1.9 Å neighbours of a = 2.7
STRUCTURE = {"mace": (3.5, SMALL.num_species, {}), "chgnet": (2.7, tc.S, {}),
             "tensornet": (3.5, tt.S, {}), "escn": (3.5, te.Z, {"charge": 2, "spin": 1,
                                                                "dataset": 1})}


def jax_model(family):
    cls, cfg = JAX_CLS[family]
    return cls(cfg(**KW[family]))


def port_model(family, **extra):
    cls, cfg = PORT_CLS[family]
    return cls(cfg(**dict(KW[family], **extra)))


def state_dict(family):
    """The JAX tests' synthetic upstream dict of ``family`` (float64)."""
    if family == "mace":
        return synthetic_mace_state_dict(jax_model("mace"), np.random.default_rng(0))
    if family == "escn":
        torch.manual_seed(0)
        return {k: v.numpy() for k, v in te.synthetic_escn_state_dict().items()}
    torch.manual_seed(1)
    torch.set_default_dtype(torch.float64)
    try:
        tm = (tc.TCHGNet(tc.S, tc.C, tc.R, tc.F, tc.NB, tc.CUT, tc.BCUT, jitter=0.05)
              if family == "chgnet" else tt.TTensorNet(tt.S, tt.C, tt.R, tt.NL, tt.CUT))
    finally:
        torch.set_default_dtype(torch.float32)
    return tm, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def converted():
    """Per family: the upstream dict (and torch module), the initial tree
    (the port model's ``init``, which has the JAX model's layout), and each
    converter's result on it, in float32."""
    out = {}
    for family in FAMILIES:
        sd = state_dict(family)
        tm, sd = sd if isinstance(sd, tuple) else (None, sd)
        init = _numpy(port_model(family).init(0))
        jp, jrep = jax_from_torch(family, sd, copy.deepcopy(init), model=jax_model(family))
        pp, prep = from_torch(family, sd, params_from_numpy(init), model=port_model(family))
        out[family] = dict(sd=sd, module=tm, init=init, jax=(jp, jrep), port=(pp, prep))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_trees_equal_the_jax_converter_bit_for_bit(converted, family):
    c = converted[family]
    (jp, jrep), (pp, prep) = c["jax"], c["port"]
    assert jrep["unused_torch"] == [] and prep["unused_torch"] == []
    assert prep["mapped"] == jrep["mapped"] == len(c["sd"])
    want, got = dict(leaves(params_from_numpy(jp))), dict(leaves(pp))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path
    # the caller's tree is not written into
    init = dict(leaves(params_from_numpy(c["init"])))
    assert any(not torch.equal(init[p], got[p]) for p in init)


@pytest.fixture(scope="module")
def jax_results(converted):
    """The JAX package's float32 result on each family's converted
    parameters and structure."""
    out = {}
    for family in FAMILIES:
        cart, lat, spec, info = _structure(family)
        pot = JDistPotential(jax_model(family), converted[family]["jax"][0], num_partitions=1)
        out[family] = pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat, info=info))
    return out


def _structure(family):
    a, n_species, info = STRUCTURE[family]
    cart, lat, spec = make_crystal(np.random.default_rng(3), reps=(2, 2, 2), a=a, noise=0.1,
                                   n_species=n_species)
    return cart, lat, spec, info


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_models_match_the_jax_package(converted, jax_results, family):
    cart, lat, spec, info = _structure(family)
    pot = DistPotential(port_model(family), converted[family]["port"][0], device="cpu")
    res = pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat, info=info))
    ref = jax_results[family]
    assert np.abs(ref["forces"]).max() > 5e-3  # non-degeneracy guard
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=1e-4)
    if family == "chgnet":
        assert pot.last_stats["n_lines"] > 0


def _float64_run(model, params, cart, lat, spec, r, br=0.0, system=None, aux=False):
    """The port's runtime on a float64 P = 1 graph: energy, forces (and
    magmoms with ``aux``)."""
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r, bond_r=br)
    g, h = build_partitioned_graph(build_plan(nl, lat, [1, 1, 1], 1, r, br, br > 0), nl, spec,
                                   lat, dtype=np.float64, system=system)
    g = g.to("cpu")
    fn = model.energy_and_aux_fn if aux else model.energy_fn
    out = make_potential_fn(fn, compute_stress=False, aux=aux)(params, g, g.positions)
    forces = h.gather_owned(out["forces"].numpy(), len(cart))
    assert forces.dtype == np.float64
    mag = h.gather_owned(out["aux"]["magmoms"].numpy(), len(cart)) if aux else None
    return float(out["energy"]), forces, mag


def _params64(converted, family):
    init64 = jax.tree.map(lambda x: np.asarray(x, np.float64), converted[family]["init"])
    params, report = from_torch(family, converted[family]["sd"], params_from_numpy(init64),
                                model=port_model(family))
    assert report["unused_torch"] == []
    return params


def test_chgnet_float64_matches_the_torch_oracle(converted):
    tm = converted["chgnet"]["module"]
    params = _params64(converted, "chgnet")
    assert params["atom_emb"]["w"].dtype == torch.float64
    rng = np.random.default_rng(3)
    pos = tc._cluster(rng) + 10.0
    Z = rng.integers(0, tc.S, len(pos))
    pos_t = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    e_t, site_t = tm.oracle(pos_t, torch.tensor(Z))
    e_t.backward()
    e, f, m = _float64_run(port_model("chgnet"), params, pos, np.eye(3) * 20.0,
                           Z.astype(np.int32), tc.CUT, tc.BCUT, aux=True)
    assert np.abs(pos_t.grad.numpy()).max() > 1e-3
    np.testing.assert_allclose(e, float(e_t.detach()), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(f, -pos_t.grad.numpy(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(m, np.abs(site_t.detach().numpy()), rtol=1e-9, atol=1e-9)


def test_tensornet_float64_matches_the_torch_oracle(converted):
    tm = converted["tensornet"]["module"]
    params = _params64(converted, "tensornet")
    rng = np.random.default_rng(11)
    while True:
        pos = rng.uniform(-2.0, 2.0, (8, 3))
        off = np.linalg.norm(pos[:, None] - pos[None], axis=-1)[~np.eye(8, dtype=bool)]
        if off.min() > 0.9 and np.abs(off - tt.CUT).min() > 0.05:
            break
    pos = pos + 10.0
    Z = rng.integers(0, tt.S, 8)
    pos_t = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    e_t = tm.oracle(pos_t, torch.tensor(Z))
    e_t.backward()
    e, f, _ = _float64_run(port_model("tensornet"), params, pos, np.eye(3) * 20.0,
                           Z.astype(np.int32), tt.CUT)
    assert np.abs(pos_t.grad.numpy()).max() > 1e-4
    np.testing.assert_allclose(e, float(e_t.detach()), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(f, -pos_t.grad.numpy(), rtol=1e-7, atol=1e-10)


def test_escn_float64_matches_the_torch_oracle(converted):
    sd = {k: torch.as_tensor(v) for k, v in converted["escn"]["sd"].items()}
    params = _params64(converted, "escn")
    cart, lattice, species = te._cluster(np.random.default_rng(5))
    charge, spin, dataset = 2, 1, 1
    dist = np.linalg.norm(cart[:, None] - cart[None, :], axis=-1)
    src, dst = np.nonzero((dist < te.CUT) & (dist > 0))
    pos_t = torch.tensor(cart, dtype=torch.float64, requires_grad=True)
    e_t = te.oracle_forward(sd, pos_t, torch.as_tensor(species, dtype=torch.long),
                            torch.as_tensor(src), torch.as_tensor(dst),
                            charge - te.CFG.charge_min, spin, dataset)
    e_t.backward()
    e, f, _ = _float64_run(port_model("escn"), params, cart, lattice, species, te.CUT,
                           system={"charge": charge, "spin": spin, "dataset": dataset})
    assert abs(e - float(e_t.detach())) / len(cart) < 1e-9
    np.testing.assert_allclose(f, -pos_t.grad.numpy(), atol=1e-8)


def test_mace_radial_chain_and_basis_change_match_upstream(converted):
    """e3nn's FullyConnectedNet on the raw upstream weights equals the
    port's radial MLP on the converted ones; the converted product weights
    reproduce the upstream U-basis contraction exactly."""
    sd, params = converted["mace"]["sd"], _params64(converted, "mace")
    model = port_model("mace")
    x = np.random.default_rng(6).normal(size=(40, SMALL.num_bessel)) * 0.5
    gain = silu_2mom_gain()
    h = x
    raw = [sd[f"interactions.0.conv_tp_weights.layer{i}.weight"]
           for i in range(SMALL.radial_layers + 1)]
    for i, w in enumerate(raw):
        h = h @ (w / np.sqrt(w.shape[0]))
        if i < len(raw) - 1:
            h = gain * h / (1.0 + np.exp(-h))
    got = mlp(params["interactions"][0]["radial"], torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, h, rtol=1e-4, atol=1e-6)
    a_ls = tuple(model.a_ls)
    for i, l in enumerate(model.h_ls):
        cpre = f"products.0.symmetric_contractions.contractions.{i}."
        for nu, key in ((3, "weights_max"), (2, "weights.0"), (1, "weights.1")):
            U = symmetric_coupling_basis(a_ls, l, nu)
            k = U.shape[-1]
            up = np.moveaxis(sd[cpre + f"U_matrix_{nu}"], 0, nu).reshape(-1, k)
            w = params["interactions"][0]["product"][str(l)][f"w{nu}"].numpy()
            np.testing.assert_allclose(np.einsum("fq,zqc->zfc", up, sd[cpre + key]),
                                       np.einsum("fp,zpc->zfc", U.reshape(-1, k), w),
                                       atol=1e-8)
    np.testing.assert_allclose(params["scale"].numpy(), [0.8])
    np.testing.assert_allclose(float(params["zbl"]["a_exp"]), 0.3)


def test_mace_cg_sign_calibration_flips_its_paths(converted):
    sd, init = dict(converted["mace"]["sd"]), converted["mace"]["init"]
    model = port_model("mace")
    plain, _ = from_torch("mace", sd, params_from_numpy(init), model=model)
    for t in range(SMALL.num_interactions):
        for lh, ly, lo in model.msg_paths[t]:
            sd[f"__cg_sign__.{lh}.{ly}.{lo}"] = np.array(1.0)
    sd["__cg_sign__.0.1.1"] = np.array(-1.0)
    cal, report = from_torch("mace", sd, params_from_numpy(init), model=model)
    assert report["unused_torch"] == []
    paths = model.msg_paths[0]
    idx = paths.index((0, 1, 1))
    shape = (SMALL.radial_mlp, len(paths), SMALL.channels)
    w_plain = plain["interactions"][0]["radial"][-1]["w"].reshape(shape)
    w_cal = cal["interactions"][0]["radial"][-1]["w"].reshape(shape)
    torch.testing.assert_close(w_cal[:, idx], -w_plain[:, idx], rtol=0, atol=0)
    other = [i for i in range(len(paths)) if i != idx]
    torch.testing.assert_close(w_cal[:, other], w_plain[:, other], rtol=0, atol=0)


def _without_u(sd):
    return {k: v for k, v in sd.items() if "U_matrix" not in k}


LOUD = {
    # (family, edit of the dict, strict, the error's type and words)
    "mace_missing_u": ("mace", _without_u, False, (ValueError, "U_matrix")),
    "mace_partial_cg_calibration": (
        "mace", lambda sd: dict(sd, **{"__cg_sign__.0.0.0": np.array(1.0)}), True,
        (ValueError, "no entry for")),
    "mace_envelope_power": ("mace", lambda sd: dict(
        sd, **{"radial_embedding.cutoff_fn.p": np.array(5.0)}), True,
        (ValueError, "envelope power")),
    "mace_bessel_frequencies": ("mace", lambda sd: dict(
        sd, **{"radial_embedding.bessel_fn.bessel_weights":
               sd["radial_embedding.bessel_fn.bessel_weights"] * 1.1}), True,
        (ValueError, "bessel")),
    "escn_mole_routing_nonstrict": ("escn", lambda sd: dict(
        sd, **{"backbone.mole_coefficient_net.0.weight": np.ones((4, 8))}), False,
        (ValueError, "routing")),
    "tensornet_trained_frequencies": ("tensornet", lambda sd: dict(
        sd, **{"bond_expansion.rbf.frequencies": np.pi * np.arange(1, tt.R + 1) * 1.1}),
        True, (ValueError, "frequencies")),
    "chgnet_data_mean": ("chgnet", lambda sd: dict(
        {"model." + k: v for k, v in sd.items()}, data_mean=np.array(1.0)), True,
        (ValueError, "data_mean")),
    "escn_gaussian_offsets": ("escn", lambda sd: dict(
        sd, **{"backbone.distance_expansion.offset":
               sd["backbone.distance_expansion.offset"] * 1.01}), True,
        (ValueError, "gaussian offsets")),
    "unknown_architecture": ("nequip", lambda sd: sd, True, (KeyError, "no mapping")),
}


@pytest.mark.parametrize("name", sorted(LOUD))
def test_loud_failures_match_the_jax_converter(converted, name):
    family, edit, strict, (err, words) = LOUD[name]
    base = family if family in converted else "mace"
    sd = edit(dict(converted[base]["sd"]))
    init = converted[base]["init"]
    model = port_model(base)
    with pytest.raises(err, match=words):
        from_torch(family, sd, params_from_numpy(init), strict=strict, model=model)
    with pytest.raises(err, match=words):
        jax_from_torch(family, sd, copy.deepcopy(init), strict=strict, model=jax_model(base))


def test_mole_guard_and_matgl_potential_dumps(converted):
    """A name merely containing "mole" (molecule_embedding) is reported as
    unused, not refused; MOLE expert-stacked SO(2) weights convert into a
    3-expert model; a matgl Potential dump maps element_refs and data_std."""
    sd = dict(converted["escn"]["sd"], **{"backbone.molecule_embedding.weight": np.ones((4, 8))})
    init = params_from_numpy(converted["escn"]["init"])
    _, report = from_torch("escn", sd, init, strict=False, model=port_model("escn"))
    assert report["unused_torch"] == ["backbone.molecule_embedding.weight"]
    experts = port_model("escn", num_experts=3)
    moe = upstream.escn_state_dict(experts.cfg, np.random.default_rng(2))
    params, report = from_torch("escn", moe, experts.init(1), model=experts)
    assert report["unused_torch"] == [] and params["blocks"][0]["so2_1"]["m1"].shape[0] == 3
    dump = {"model." + k: v for k, v in converted["chgnet"]["sd"].items()}
    dump.update({"element_refs.property_offset": np.arange(tc.S, dtype=np.float64),
                 "data_std": np.array(2.5), "data_mean": np.array(0.0)})
    params, report = from_torch("chgnet", dump, params_from_numpy(converted["chgnet"]["init"]),
                                model=port_model("chgnet"))
    assert report["unused_torch"] == []
    np.testing.assert_array_equal(params["species_ref"]["w"].numpy().ravel(), np.arange(tc.S))
    assert float(params["data_std"]) == 2.5


FULL_WIDTH = {
    # MACE-MP-0-medium (tests/test_convert.py:183), MPtrj
    # (tests/test_convert_chgnet.py:328), MatPES (tests/test_convert_tensornet.py:228)
    "mace_mp0_medium": ("mace", dict(num_species=89, channels=128, l_max=3, a_lmax=3,
                                     hidden_lmax=1, correlation=3, num_interactions=2,
                                     num_bessel=8, radial_mlp=64, cutoff=6.0, cutoff_p=5,
                                     avg_num_neighbors=35.0)),
    "chgnet_mptrj": ("chgnet", dict(num_species=89, units=64, num_rbf=31, num_angle=4,
                                    num_blocks=4, cutoff=6.0, bond_cutoff=3.0)),
    "tensornet_matpes": ("tensornet", dict(num_species=89, units=64, num_rbf=32, num_layers=2,
                                           cutoff=5.0)),
}


def _jax_side_dict(family, kw):
    """The JAX tests' synthetic dict of ``family`` at config ``kw``."""
    if family == "mace":
        return synthetic_mace_state_dict(jmodels.MACE(jmodels.MACEConfig(**kw)),
                                         np.random.default_rng(2))
    if family == "escn":
        return {k: v.numpy() for k, v in te.synthetic_escn_state_dict().items()}
    torch.set_default_dtype(torch.float64)
    try:
        tm = (tc.TCHGNet(kw["num_species"], kw["units"], kw["num_rbf"], kw["num_angle"],
                         kw["num_blocks"], kw["cutoff"], kw["bond_cutoff"])
              if family == "chgnet" else
              tt.TTensorNet(kw["num_species"], kw["units"], kw["num_rbf"], kw["num_layers"],
                            kw["cutoff"]))
    finally:
        torch.set_default_dtype(torch.float32)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    if family == "tensornet":
        sd["bond_expansion.rbf.frequencies"] = np.pi * np.arange(1, kw["num_rbf"] + 1)
    return sd


MAKERS = {"mace": lambda m, rng: upstream.mace_state_dict(m, rng),
            "chgnet": lambda m, rng: upstream.chgnet_state_dict(m.cfg, rng),
            "tensornet": lambda m, rng: upstream.tensornet_state_dict(m.cfg, rng),
            "escn": lambda m, rng: upstream.escn_state_dict(m.cfg, rng)}
HELPER_CASES = {**FULL_WIDTH, **{f"{f}_small": (f, KW[f]) for f in FAMILIES}}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_helper_dicts_match_the_jax_test_dicts_and_convert(name):
    """``tests/torch_upstream_dicts.py`` (what ``chip_smoke.py`` converts)
    has the JAX tests' dicts' names and shapes, MACE's its values too
    (same draws); its dicts and the full-width JAX-side ones convert onto
    the port's models with zero unmapped tensors."""
    family, kw = HELPER_CASES[name]
    model = PORT_CLS[family][0](PORT_CLS[family][1](**kw))
    ours = MAKERS[family](model, np.random.default_rng(2))
    theirs = _jax_side_dict(family, kw)
    assert {k: np.shape(v) for k, v in ours.items()} == {k: np.shape(v)
                                                         for k, v in theirs.items()}
    if family == "mace":
        assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    for sd in (ours, theirs) if name in FULL_WIDTH else (ours,):
        _, report = from_torch(family, sd, model.init(0), model=model)
        assert report["unused_torch"] == [] and report["mapped"] == len(sd)


def test_export_roundtrip_and_direct_state_dict(converted, tmp_path):
    """A fairchem-style checkpoint ({"state_dict": {"module....": tensors}})
    exports to an npz that converts with zero unmapped tensors, and its
    state dict read directly (no npz) converts to the same tree."""
    sd = {k: torch.as_tensor(v) for k, v in converted["escn"]["sd"].items()}
    ckpt = str(tmp_path / "uma.pt")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, ckpt)
    out = str(tmp_path / "uma.npz")
    assert export_upstream.main(["escn", ckpt, out]) == 0
    back = dict(np.load(out))
    assert set(back) == set(sd)
    init = params_from_numpy(converted["escn"]["init"])
    via_npz, report = from_torch("escn", back, init, model=port_model("escn"))
    assert report["unused_torch"] == []
    direct = export_upstream.load_state_dict(ckpt)
    assert all(isinstance(v, torch.Tensor) for v in direct.values())
    via_torch, _ = from_torch("escn", direct, init, model=port_model("escn"))
    a, b = dict(leaves(via_npz)), dict(leaves(via_torch))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert sorted(MAPPINGS) == ["chgnet", "escn", "mace", "tensornet"]
    assert export_upstream.main(["nequip", ckpt, out]) == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_verify_upstream_infers_each_config(converted, family):
    """Config inference from tensor shapes gives back the config the dict
    was built for (the hyperparameters no tensor carries aside)."""
    cfg, assumed, zs, _ = verify_upstream._INFER[family](converted[family]["sd"], {})
    want = PORT_CLS[family][1](**KW[family])
    keys = {"mace": ("num_species", "channels", "a_lmax", "hidden_lmax", "correlation",
                     "num_interactions", "num_bessel", "radial_mlp", "radial_layers", "cutoff",
                     "cutoff_p", "l_max", "zbl"),
            "chgnet": ("num_species", "units", "num_rbf", "num_angle", "num_blocks"),
            "tensornet": ("num_species", "units", "num_rbf", "num_layers"),
            "escn": ("max_num_elements", "sphere_channels", "lmax", "mmax", "num_layers",
                     "hidden_channels", "edge_channels", "num_distance_basis", "num_charges",
                     "num_spins", "num_datasets", "cutoff", "num_experts")}[family]
    assert {k: getattr(cfg, k) for k in keys} == {k: getattr(want, k) for k in keys}
    assert isinstance(assumed, list) and len(zs) > 0


def test_verify_upstream_runs_ours_and_names_the_missing_package(converted, tmp_path):
    """``main`` on an npz converts, evaluates P = 1 and P = 2 on the CPU and
    reports the upstream comparison skipped (rc 3); ``eval_upstream``
    raises ``UpstreamUnavailable`` naming what is missing."""
    npz = str(tmp_path / "tn.npz")
    np.savez(npz, **converted["tensornet"]["sd"])
    out = str(tmp_path / "report.json")
    rc = verify_upstream.main(["tensornet", npz, "--set", f"cutoff={tt.CUT}",
                               "--device", "cpu", "--out", out])
    assert rc == 3
    assert '"upstream_skipped"' in open(out).read()
    numbers, cart, lattice = verify_upstream.make_fixture(tt.CUT, np.arange(1, tt.S + 1))
    with pytest.raises(verify_upstream.UpstreamUnavailable, match="npz"):
        verify_upstream.eval_upstream("tensornet", npz, numbers, cart, lattice, {})
    with pytest.raises(verify_upstream.UpstreamUnavailable, match="not importable"):
        verify_upstream.eval_upstream("escn", str(tmp_path / "uma.pt"), numbers, cart,
                                      lattice, {})
    assert verify_upstream.main(["tensornet", npz, "--set", "grid=2,2.5"]) == 2
