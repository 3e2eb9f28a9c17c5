"""The slice end to end: eSCN through ``DistPotential`` at P=1, JAX vs port.

The small eSCN of ``tests/test_escn.py`` (C 16, l_max 2, 2 layers, 6
Bessel, 4 experts, cutoff 3.2 Å, 4 species) and an l_max-4 case at C 8,
on a 32-atom fcc crystal at a = 3.5 Å rattled by 0.1 Å, with a 0.5 Å skin
(skin-shell edges between 3.2 and 3.7 Å are in the graph and masked by the
envelope) and non-default charge, spin and dataset in ``atoms.info``.
``edge_chunk=256`` gives K = 3 edge chunks (e_cap 768); the default 32768
gives K = 1, the shared-Wigner path.

JAX side: ``distmlip_tpu.calculators.DistPotential(num_partitions=1)``
with its own initialised parameters, with ``kernels=False`` (plain XLA)
and ``kernels="interpret"`` (the Pallas segment-sum and SO(2) kernels in
interpret mode). Port side: ``DistPotential(device="cpu")`` with those
parameters carried across by ``params_from_numpy`` and, once more, through
``save_params`` -> ``load_params``.

Tolerances: both sides compute in float32 with the same arithmetic summed
in different orders: rel dE < 1e-5 and max |dF|, |dS| < 1e-4, as
``tests/test_torch_chgnet.py`` states them. The float64 lane runs both
packages' runtimes on float64 graphs and parameters: rel dE < 1e-10 and
max |dF|, |dS| < 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import ESCN as JESCN
from distmlip_tpu.models import ESCNConfig as JESCNConfig
from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.parallel import make_potential_fn as jax_make_potential_fn
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu.utils.checkpoint import save_params
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import ESCN, ESCNConfig
from distmlip_tpu_torch.models import escn as escn_module
from distmlip_tpu_torch.neighbors import neighbor_list_numpy
from distmlip_tpu_torch.ops.chunk import chunk_layout
from distmlip_tpu_torch.parallel import halo, make_potential_fn
from distmlip_tpu_torch.partition import CapacityPolicy, build_partitioned_graph, build_plan
from distmlip_tpu_torch.tools.workload import ESCN_INFO, ESCN_KW
from distmlip_tpu_torch.utils import load_params, params_from_numpy
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6, num_experts=4,
           cutoff=3.2, avg_num_neighbors=12.0)
CFG_L4 = dict(CFG, channels=8, l_max=4)
SKIN = 0.5
INFO = {"charge": 2, "spin": 3, "dataset": 1}
CASES = {
    "lmax2_experts4_k3": dict(CFG, edge_chunk=256),
    "lmax2_experts4_k1": dict(CFG),
    "lmax4_c8_experts1_k3": dict(CFG_L4, num_experts=1, edge_chunk=256),
    "lmax4_c8_experts2_k1": dict(CFG_L4, num_experts=2),
}


def _structure(seed=1):
    return make_crystal(np.random.default_rng(seed), reps=(2, 2, 2), a=3.5, noise=0.1,
                        n_species=4)


def _jax_params(cfg, seed=0):
    params = jax.tree.map(np.array, JESCN(JESCNConfig(**cfg)).init(jax.random.PRNGKey(seed)))
    # reference energies off their zero default, so a dropped term shows
    params["species_ref"]["w"] = np.array([0.3, -1.2, 0.7, 2.0], np.float32)
    return params


def _jax_calculate(cfg, params, structure, kernels, info=INFO):
    cart, lat, spec = structure
    pot = JDistPotential(JESCN(JESCNConfig(**cfg)), params, num_partitions=1, skin=SKIN,
                         kernels=kernels)
    return pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat, info=dict(info)))


def _atoms(structure, info=INFO):
    cart, lat, spec = structure
    return Atoms(numbers=spec, positions=cart.copy(), cell=lat, info=dict(info))


def _port(cfg, params, **kw):
    return DistPotential(ESCN(ESCNConfig(**cfg)), params, device="cpu", skin=SKIN, **kw)


def _assert_close(res, ref, rel_e=1e-5, atol=1e-4):
    assert abs(res["energy"] - ref["energy"]) < rel_e * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 5e-3  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=atol)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def jax_refs():
    """Per case: (params, the JAX kernels=False result), computed once."""
    structure = _structure()
    out = {}
    for name, cfg in CASES.items():
        params = _jax_params(cfg)
        out[name] = (params, _jax_calculate(cfg, params, structure, False))
    return structure, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_escn_matches_jax_params_from_numpy(jax_refs, name):
    structure, refs = jax_refs
    params, ref = refs[name]
    cfg = CASES[name]
    pot = _port(cfg, params_from_numpy(params))
    res = pot.calculate(_atoms(structure))
    _assert_close(res, ref)
    k = chunk_layout(pot.last_stats["e_cap"], ESCNConfig(**cfg).edge_chunk)[2]
    assert k == (3 if name.endswith("k3") else 1)


@pytest.mark.parametrize("name", ["lmax2_experts4_k3", "lmax4_c8_experts2_k1"])
def test_escn_matches_jax_interpret_kernels(jax_refs, name):
    """Against the JAX package with its Pallas kernels (the segment sum and
    the SO(2) convolution) in interpret mode."""
    structure, refs = jax_refs
    params, _ = refs[name]
    ref = _jax_calculate(CASES[name], params, structure, "interpret")
    _assert_close(_port(CASES[name], params).calculate(_atoms(structure)), ref)


@pytest.mark.parametrize("name", ["lmax2_experts4_k3", "lmax4_c8_experts1_k3"])
def test_escn_matches_jax_through_checkpoint(jax_refs, tmp_path, name):
    """save_params -> load_params: lists come back as dicts keyed "0", "1",
    ..., and ``mole_gate: None`` (one expert) is dropped by the save."""
    structure, refs = jax_refs
    params, ref = refs[name]
    path = str(tmp_path / "escn.npz")
    save_params(path, params)
    loaded = load_params(path)
    assert ("mole_gate" in loaded) == (CASES[name]["num_experts"] > 1)
    assert set(loaded["layers"]) == {"0", "1"}
    assert tuple(loaded["layers"]["1"]["so2"]["m1r"].shape) == tuple(
        params["layers"][1]["so2"]["m1r"].shape)
    _assert_close(_port(CASES[name], loaded, kernels=False).calculate(_atoms(structure)), ref)


def test_escn_matches_jax_float64():
    """Both runtimes on float64 graphs and float64 parameters, conditioning
    on, K = 3: only the summation order differs."""
    cfg = CASES["lmax2_experts4_k3"]
    cart, lat, spec = _structure()
    r = cfg["cutoff"] + SKIN
    params64 = jax.tree.map(lambda x: np.asarray(x, np.float64), _jax_params(cfg))
    jax.config.update("jax_enable_x64", True)
    try:
        nl = jax_nl(cart, lat, [1, 1, 1], r)
        jg, jh = jax_build_graph(jax_build_plan(nl, lat, [1, 1, 1], 1, r), nl, spec, lat,
                                 caps=JCaps(), dtype=np.float64, system=INFO)
        jout = jax_make_potential_fn(JESCN(JESCNConfig(**cfg)).energy_fn, None)(
            jax.tree.map(jax.numpy.asarray, params64), jg, jg.positions)
        ref = {"energy": float(jout["energy"]),
               "forces": jh.gather_owned(np.asarray(jout["forces"]), len(cart)),
               "stress": np.asarray(jout["stress"])}
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref["forces"].dtype == np.float64
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r)
    g, h = build_partitioned_graph(build_plan(nl, lat, [1, 1, 1], 1, r), nl, spec, lat,
                                   caps=CapacityPolicy(), dtype=np.float64, system=INFO)
    g = g.to("cpu")
    assert int(g.system["charge"]) == 2 and g.system["spin"].dtype == torch.int32
    out = make_potential_fn(ESCN(ESCNConfig(**cfg)).energy_fn)(
        params_from_numpy(params64), g, g.positions)
    res = {"energy": float(out["energy"]),
           "forces": h.gather_owned(out["forces"].numpy(), len(cart)),
           "stress": out["stress"].numpy()}
    assert res["forces"].dtype == np.float64
    _assert_close(res, ref, rel_e=1e-10, atol=1e-9)


@pytest.mark.parametrize("experts", [1, 4])
def test_params_carry_the_escn_tree_unchanged(experts):
    """The ``layers`` list, the ``so2`` dicts of (E_exp, d, d) matrices and
    ``mole_gate`` (None with one expert) keep their structure, shapes and
    values; the port's own init has the same tree."""
    cfg = dict(CFG, num_experts=experts)
    params = _jax_params(cfg)
    carried = params_from_numpy(params)
    own = ESCN(ESCNConfig(**cfg)).init(0)

    def walk(a, b, c):
        if a is None:
            assert b is None and c is None
            return
        assert type(a) is type(b) is type(c) or not isinstance(a, (dict, list))
        if isinstance(a, dict):
            assert a.keys() == b.keys() == c.keys()
            for k in a:
                walk(a[k], b[k], c[k])
        elif isinstance(a, list):
            assert len(a) == len(b) == len(c)
            for x, y, z in zip(a, b, c):
                walk(x, y, z)
        else:
            assert tuple(b.shape) == np.shape(a) == tuple(c.shape)
            assert b.dtype == c.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)

    walk(params, carried, own)
    assert (carried["mole_gate"] is None) == (experts == 1)
    so2 = carried["layers"][0]["so2"]
    assert sorted(so2) == ["m0", "m1i", "m1r", "m2i", "m2r"]
    assert tuple(so2["m1r"].shape) == (experts, 32, 32)


def test_conditioning_moves_the_energy_and_is_part_of_the_cache_key(jax_refs):
    """A change of charge changes the energy, as in the JAX package, and
    rebuilds the skin-cached graph; the same charge again is a cache hit."""
    structure, refs = jax_refs
    params, _ = refs["lmax2_experts4_k3"]
    cfg = CASES["lmax2_experts4_k3"]
    pot = _port(cfg, params)
    atoms = _atoms(structure)
    a = pot.calculate(atoms)
    atoms.info["charge"] = -3
    b = pot.calculate(atoms)
    assert pot.rebuild_count == 2
    jb = _jax_calculate(cfg, params, structure, False, dict(INFO, charge=-3))
    _assert_close(b, jb)
    assert abs(a["energy"] - b["energy"]) > 1e-3
    atoms.positions += 0.01
    pot.calculate(atoms)
    assert pot.rebuild_count == 2
    atoms.info = {}
    neutral = pot.calculate(atoms)
    assert pot.rebuild_count == 3
    assert neutral["energy"] != b["energy"]


def test_skin_shell_masking_is_exact_and_the_cache_holds(jax_refs):
    """The skin graph carries extra edges and the envelope zeroes them:
    skin 0.5 equals skin 0. Three small moves reuse the graph and match
    fresh builds."""
    structure, refs = jax_refs
    params, _ = refs["lmax2_experts4_k3"]
    model = ESCN(ESCNConfig(**CASES["lmax2_experts4_k3"]))
    cached = DistPotential(model, params, device="cpu", skin=SKIN)
    fresh = DistPotential(model, params, device="cpu", skin=0.0)
    atoms = _atoms(structure)
    a, b = cached.calculate(atoms), fresh.calculate(atoms)
    assert cached.last_stats["n_edges"] > fresh.last_stats["n_edges"]
    _assert_close(a, b)
    rng = np.random.default_rng(7)
    for _ in range(3):
        atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        _assert_close(cached.calculate(atoms), fresh.calculate(atoms))
    assert cached.rebuild_count == 1


@pytest.mark.parametrize("info,match", [
    ({"charge": 13}, "charge 13 outside"), ({"charge": -13}, "charge -13 outside"),
    ({"spin": 10}, "spin 10 outside"), ({"spin": -1}, "spin -1 outside"),
    ({"dataset": 4}, "dataset 4 outside"),
])
def test_out_of_range_conditioning_raises(info, match):
    model = ESCN(ESCNConfig(**CFG))
    pot = DistPotential(model, model.init(0), device="cpu")
    with pytest.raises(ValueError, match=match):
        pot.calculate(_atoms(_structure(), info))


def test_unported_options_raise():
    # bfloat16 is ported (tests/test_torch_bf16*.py): it builds and runs,
    # energies and forces in float32
    bf16 = DistPotential(ESCN(ESCNConfig(**dict(CFG, dtype="bfloat16"))),
                         ESCN(ESCNConfig(**CFG)).init(0), device="cpu")
    res = bf16.calculate(_atoms(_structure(), INFO))
    assert np.isfinite(res["energy"]) and res["forces"].dtype == np.float32
    assert np.isfinite(res["forces"]).all() and bf16.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ESCN(ESCNConfig(**dict(CFG, dtype="float16")))
    with pytest.raises(NotImplementedError, match="l_max > 6"):
        ESCN(ESCNConfig(**dict(CFG, l_max=7)))
    model = ESCN(ESCNConfig(**CFG))
    cart, lat, spec = _structure()
    r = CFG["cutoff"]
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r)
    g, _ = build_partitioned_graph(build_plan(nl, lat, [1, 1, 1], 1, r), nl, spec, lat)
    g = g.to("cpu")
    lg = halo.local_graph_from_stacked(g)
    lg.batch_size, lg.struct_id = 1, torch.zeros(g.n_cap, dtype=torch.int32)
    # a packed graph of one structure: its per-structure MOLE gate is the
    # whole-system gate (the batched gate itself is held against the JAX
    # package in tests/test_torch_batched.py)
    params = model.init(0)
    torch.testing.assert_close(model.energy_fn(params, lg, g.positions[0]),
                               model.energy_fn(params, halo.local_graph_from_stacked(g),
                                               g.positions[0]), rtol=1e-5, atol=1e-5)
    # one expert has no gate to batch: the packed graph's fields are ignored
    one = ESCN(ESCNConfig(**dict(CFG, num_experts=1)))
    assert one.energy_fn(one.init(0), lg, g.positions[0]).shape == (g.n_cap,)


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_calls_per_calculate(monkeypatch, remat):
    """The counts chip_smoke.py checks against the kernels' launch
    counters: per calculate, each layer's SO(2) convolution and each of the
    1 + num_layers segment sums once per edge chunk, on sorted ids (the
    route that launches a kernel on the card), and once more per chunk in
    the backward's recompute of the checkpointed chunk body with remat."""
    calls = {"so2": 0, "segment_sum": 0}
    real_so2, real_seg = escn_module.fused_so2_conv, escn_module.fused_segment_sum

    def so2(h, weights, m_idx, channels, kernels=True, packed=None):
        calls["so2"] += 1
        assert h.shape[1:] == (9, 16) and len(weights) == 5
        assert packed is None  # the weights are packed for the kernel only on the card
        return real_so2(h, weights, m_idx, channels, kernels=kernels, packed=packed)

    def seg(data, ids, n, mask=None, indices_are_sorted=False, kernels=True):
        calls["segment_sum"] += 1
        assert indices_are_sorted and mask is not None
        return real_seg(data, ids, n, mask, indices_are_sorted=True, kernels=kernels)

    monkeypatch.setattr(escn_module, "fused_so2_conv", so2)
    monkeypatch.setattr(escn_module, "fused_segment_sum", seg)
    cfg = ESCNConfig(**dict(CFG, edge_chunk=256, remat=remat))
    pot = DistPotential(ESCN(cfg), ESCN(cfg).init(1), device="cpu", skin=SKIN)
    pot.calculate(_atoms(_structure(seed=3)))
    k = chunk_layout(pot.last_stats["e_cap"], 256)[2]
    per = 2 * k if remat else k
    assert calls == {"so2": cfg.num_layers * per, "segment_sum": (1 + cfg.num_layers) * per}


def test_escn_workload():
    """The single-chip eSCN/UMA configuration of examples/05_scale_ladder.py
    (channels 128, l_max 4, 2 layers, 8 experts, cutoff 5, 40 neighbours)
    with the config's defaults for species, Bessel and edge channels, in
    float32, and the example's conditioning."""
    assert ESCN_KW == dict(num_species=95, channels=128, l_max=4, num_layers=2,
                           num_experts=8, cutoff=5.0, avg_num_neighbors=40.0, num_bessel=8,
                           edge_channels=32, edge_chunk=32768, remat=True)
    assert ESCN_INFO == {"charge": 1, "spin": 1, "dataset": 2}
    cfg = ESCNConfig(**ESCN_KW)
    assert cfg.dtype == "float32" and cfg.sphere_dim == 25
