"""The slice end to end: CHGNet through ``DistPotential`` at P=1, JAX vs port.

A small CHGNet (units 16, 6 RBF, max_f 4, 3 blocks, cutoff 3.2 Å, bond
cutoff 2.6 Å, 4 species) on a 32-atom fcc crystal at a = 3.5 Å (nearest
neighbours 2.47 Å) rattled by 0.1 Å, with a 0.5 Å skin: the graph holds
skin-shell edges (3.2-3.7 Å) AND skin-shell bonds (2.6-3.1 Å), so the
``in_r``, ``b_real`` and ``line_ok`` masks all bite. The readout's
``species_ref`` (S, 1) and 0-d ``data_std`` are set to distinct
non-default values, so a dropped readout term shows.

JAX side: ``distmlip_tpu.calculators.DistPotential(num_partitions=1,
compute_magmom=True)`` with its own initialised parameters, once with
``kernels=False`` (plain XLA) and once with ``kernels="interpret"`` (the
Pallas edge-aggregate kernel in interpret mode at both CHGNet call
sites). Port side: ``DistPotential(device="cpu", compute_magmom=True)``
with those parameters carried across by ``params_from_numpy`` and, once
more, through ``save_params`` -> ``load_params``.

Tolerances: both sides compute in float32 with the same arithmetic but sum
in different orders, so rel dE < 1e-5 and max |dF|, |dS|, |dm| < 1e-4. The
float64 lane runs both packages' runtimes on float64 graphs and
parameters, where only summation order differs: rel dE < 1e-10 and
max |dF|, |dS|, |dm| < 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import CHGNet as JCHGNet
from distmlip_tpu.models import CHGNetConfig as JCHGNetConfig
from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.parallel import make_potential_fn as jax_make_potential_fn
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu.utils.checkpoint import save_params
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.kernels import dispatch
from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, TensorNet, TensorNetConfig
from distmlip_tpu_torch.models import chgnet as chgnet_module
from distmlip_tpu_torch.neighbors import neighbor_list_numpy
from distmlip_tpu_torch.parallel import halo, make_potential_fn
from distmlip_tpu_torch.partition import CapacityPolicy, build_partitioned_graph, build_plan
from distmlip_tpu_torch.tools.workload import CHGNET_KW
from distmlip_tpu_torch.utils import load_params, params_from_numpy
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(num_species=4, units=16, num_rbf=6, num_angle=4, num_blocks=3, cutoff=3.2,
           bond_cutoff=2.6)
SKIN = 0.5


def _structure(seed=1):
    return make_crystal(np.random.default_rng(seed), reps=(2, 2, 2), a=3.5, noise=0.1,
                        n_species=4)


def _jax_params():
    params = jax.tree.map(np.array, JCHGNet(JCHGNetConfig(**CFG)).init(
        jax.random.PRNGKey(0)))
    params["species_ref"]["w"][:, 0] = np.array([0.3, -1.2, 0.7, 2.0], np.float32)
    params["data_std"] = np.array(1.7, np.float32)
    return params


def _jax_calculate(params, structure, kernels):
    cart, lat, spec = structure
    pot = JDistPotential(JCHGNet(JCHGNetConfig(**CFG)), params, num_partitions=1,
                         compute_magmom=True, skin=SKIN, kernels=kernels)
    return pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat))


@pytest.fixture(scope="module")
def jax_case():
    structure = _structure()
    params = _jax_params()
    return structure, params, _jax_calculate(params, structure, False)


def _atoms(structure):
    cart, lat, spec = structure
    return Atoms(numbers=spec, positions=cart.copy(), cell=lat)


def _port(params, **kw):
    return DistPotential(CHGNet(CHGNetConfig(**CFG)), params, device="cpu", skin=SKIN,
                         compute_magmom=True, **kw)


def _assert_close(res, ref, rel_e=1e-5, atol=1e-4):
    assert abs(res["energy"] - ref["energy"]) < rel_e * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 1e-2  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=atol)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=atol)
    assert res["magmoms"].shape == ref["magmoms"].shape == (len(res["forces"]),)
    assert np.abs(ref["magmoms"]).max() > 1e-2
    np.testing.assert_allclose(res["magmoms"], ref["magmoms"], rtol=0, atol=atol)


def test_chgnet_matches_jax_params_from_numpy(jax_case):
    structure, params, ref = jax_case
    pot = _port(params_from_numpy(params))
    res = pot.calculate(_atoms(structure))
    _assert_close(res, ref)
    stats = pot.last_stats
    assert stats["n_bonds"] > 0 and stats["n_lines"] > 0 and stats["b_cap"] >= stats["n_bonds"]


def test_chgnet_matches_jax_interpret_kernels(jax_case):
    """Against the JAX package with its Pallas edge-aggregate kernel (in
    interpret mode) at both CHGNet call sites."""
    structure, params, _ = jax_case
    ref = _jax_calculate(params, structure, "interpret")
    _assert_close(_port(params).calculate(_atoms(structure)), ref)


def test_chgnet_matches_jax_through_checkpoint(jax_case, tmp_path):
    structure, params, ref = jax_case
    path = str(tmp_path / "chgnet.npz")
    save_params(path, params)
    loaded = load_params(path)
    assert loaded["species_ref"]["w"].shape == (4, 1) and loaded["data_std"].ndim == 0
    _assert_close(_port(loaded, kernels=False).calculate(_atoms(structure)), ref)


def test_chgnet_matches_jax_float64():
    """Both runtimes on float64 graphs and float64 parameters: only the
    summation order differs."""
    cart, lat, spec = _structure()
    r, br = CFG["cutoff"] + SKIN, CFG["bond_cutoff"] + SKIN
    params64 = jax.tree.map(lambda x: np.asarray(x, np.float64), _jax_params())
    jax.config.update("jax_enable_x64", True)
    try:
        nl = jax_nl(cart, lat, [1, 1, 1], r, bond_r=br)
        jg, jh = jax_build_graph(jax_build_plan(nl, lat, [1, 1, 1], 1, r, br, True), nl,
                                 spec, lat, caps=JCaps(), dtype=np.float64)
        jmodel = JCHGNet(JCHGNetConfig(**CFG))
        jout = jax_make_potential_fn(jmodel.energy_and_aux_fn, None, aux=True)(
            jax.tree.map(jax.numpy.asarray, params64), jg, jg.positions)
        ref = {"energy": float(jout["energy"]),
               "forces": jh.gather_owned(np.asarray(jout["forces"]), len(cart)),
               "stress": np.asarray(jout["stress"]),
               "magmoms": jh.gather_owned(np.asarray(jout["aux"]["magmoms"]), len(cart))}
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref["forces"].dtype == np.float64
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r, bond_r=br)
    g, h = build_partitioned_graph(build_plan(nl, lat, [1, 1, 1], 1, r, br, True), nl,
                                   spec, lat, caps=CapacityPolicy(), dtype=np.float64)
    g = g.to("cpu")
    out = make_potential_fn(CHGNet(CHGNetConfig(**CFG)).energy_and_aux_fn, aux=True)(
        params_from_numpy(params64), g, g.positions)
    res = {"energy": float(out["energy"]),
           "forces": h.gather_owned(out["forces"].numpy(), len(cart)),
           "stress": out["stress"].numpy(),
           "magmoms": h.gather_owned(out["aux"]["magmoms"].numpy(), len(cart))}
    assert res["forces"].dtype == np.float64
    _assert_close(res, ref, rel_e=1e-10, atol=1e-9)


@pytest.mark.parametrize("extra", [
    dict(shared_bond_weights="bond", bond_update_hidden=(16,)),
    dict(shared_bond_weights=None),
], ids=["edge_update_no_threebody_weights", "no_shared_weights"])
def test_chgnet_optional_paths_match_jax(extra):
    """The configuration's optional paths: the atom-graph edge update
    (plain torch), and the messages without per-edge weights (the atom
    conv's plain message and kernel take no abw)."""
    cfg = dict(CFG, **extra)
    cart, lat, spec = _structure(seed=2)
    params = jax.tree.map(np.array, JCHGNet(JCHGNetConfig(**cfg)).init(
        jax.random.PRNGKey(3)))
    ref = JDistPotential(JCHGNet(JCHGNetConfig(**cfg)), params, num_partitions=1,
                         compute_magmom=True, skin=SKIN, kernels=False).calculate(
        JAtoms(numbers=spec, positions=cart, cell=lat))
    res = DistPotential(CHGNet(CHGNetConfig(**cfg)), params, device="cpu", skin=SKIN,
                        compute_magmom=True).calculate(_atoms((cart, lat, spec)))
    _assert_close(res, ref)


def test_params_carry_the_chgnet_tree_unchanged(jax_case):
    """The ``atom_blocks``/``bond_blocks`` lists of dicts, the gated MLPs'
    core/gate lists, the ``freq_*`` vectors, ``species_ref`` (S, 1) and the
    0-d ``data_std`` keep their structure, shapes and values; the port's own
    init has the same tree."""
    _, params, _ = jax_case
    carried = params_from_numpy(params)
    own = CHGNet(CHGNetConfig(**CFG)).init(0)

    def walk(a, b, c):
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
    assert carried["data_std"].ndim == 0 and float(carried["data_std"]) == pytest.approx(1.7)
    assert tuple(carried["species_ref"]["w"].shape) == (4, 1)
    assert len(carried["atom_blocks"]) == 3 and len(carried["bond_blocks"]) == 2
    np.testing.assert_array_equal(own["freq_bond"].numpy(), params["freq_bond"])
    np.testing.assert_array_equal(own["freq_angle"].numpy(), params["freq_angle"])


def test_skin_shell_masking_is_exact_and_the_cache_holds(jax_case):
    """The skin graph carries extra edges and bonds, and the masks make them
    contribute nothing: skin 0.5 equals skin 0 (a graph without them). Three
    small moves reuse the graph and match fresh builds; a large one
    rebuilds."""
    structure, params, _ = jax_case
    model = CHGNet(CHGNetConfig(**CFG))
    cached = DistPotential(model, params, device="cpu", skin=SKIN, compute_magmom=True)
    fresh = DistPotential(model, params, device="cpu", skin=0.0, compute_magmom=True)
    atoms = _atoms(structure)
    a, b = cached.calculate(atoms), fresh.calculate(atoms)
    assert cached.last_stats["n_edges"] > fresh.last_stats["n_edges"]
    assert cached.last_stats["n_bonds"] > fresh.last_stats["n_bonds"]
    assert cached.last_stats["n_lines"] > fresh.last_stats["n_lines"]
    _assert_close(a, b)
    rng = np.random.default_rng(7)
    for _ in range(3):
        atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        _assert_close(cached.calculate(atoms), fresh.calculate(atoms))
    assert cached.rebuild_count == 1
    atoms.positions[0] += 0.4  # past skin/2
    cached.calculate(atoms)
    assert cached.rebuild_count == 2


@pytest.mark.parametrize("num_blocks", [2, 3])
def test_edge_aggregate_calls_per_calculate(monkeypatch, num_blocks):
    """The count chip_smoke.py checks against the kernels' launch counters:
    per calculate, one atom-conv aggregation per block and one line-graph
    aggregation per bond block (num_blocks - 1), all on sorted ids with
    edges (the route that launches a kernel on the card), each with the
    gated MLP's 8 weights. The backward recomputes messages in plain torch
    and aggregates nothing."""
    calls = []

    def counted(real):
        def wrapper(message, inputs, segment_ids, num_segments, mask=None, **kw):
            assert kw["indices_are_sorted"] and segment_ids.shape[0] > 0
            assert len(kw["weights"]) == 8
            calls.append(message.name)
            return real(message, inputs, segment_ids, num_segments, mask, **kw)
        return wrapper

    monkeypatch.setattr(halo, "fused_edge_aggregate", counted(dispatch.fused_edge_aggregate))
    monkeypatch.setattr(chgnet_module, "fused_edge_aggregate",
                        counted(dispatch.fused_edge_aggregate))
    cfg = CHGNetConfig(**dict(CFG, num_blocks=num_blocks))
    pot = DistPotential(CHGNet(cfg), CHGNet(cfg).init(1), device="cpu", skin=0.3,
                        compute_magmom=True)
    atoms = _atoms(_structure(seed=3))
    pot.calculate(atoms)
    want = (["chgnet_atom_conv_aggregate", "chgnet_line_aggregate"] * (num_blocks - 1)
            + ["chgnet_atom_conv_aggregate"])
    assert calls == want
    atoms.positions += 0.01
    pot.calculate(atoms)
    assert len(calls) == 2 * (2 * num_blocks - 1)


def test_magmoms_ride_the_energy_forward(jax_case):
    """compute_magmom adds magmoms without changing E, F or S, and equals
    the standalone magmom_fn readout."""
    structure, params, ref = jax_case
    model = CHGNet(CHGNetConfig(**CFG))
    with_m = _port(params).calculate(_atoms(structure))
    bare = DistPotential(model, params, device="cpu", skin=SKIN).calculate(_atoms(structure))
    assert "magmoms" not in bare and bare["energy"] == with_m["energy"]
    np.testing.assert_array_equal(bare["forces"], with_m["forces"])
    pot = _port(params)
    graph, host, positions = pot._prepare(_atoms(structure))
    lg = halo.local_graph_from_stacked(graph)
    m = model.magmom_fn(pot.params, lg, positions[0])
    np.testing.assert_allclose(host.gather_owned(m[None].numpy(), 32), with_m["magmoms"],
                               rtol=0, atol=1e-6)


def test_unported_options_and_workload():
    # bfloat16 is ported (tests/test_torch_bf16_chgnet.py); other dtypes raise
    assert CHGNet(CHGNetConfig(**CFG, dtype="bfloat16")).cfg.dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        CHGNet(CHGNetConfig(**CFG, dtype="float16"))
    model = CHGNet(CHGNetConfig(**CFG))
    with pytest.raises(NotImplementedError, match="fused_site_readout"):
        DistPotential(model, model.init(0), device="cpu", compute_magmom=True,
                      fused_site_readout=False)
    tn = TensorNet(TensorNetConfig(num_species=4, units=8, num_rbf=4))
    with pytest.raises(ValueError, match="compute_magmom"):
        DistPotential(tn, tn.init(0), device="cpu", compute_magmom=True)
    # the MPtrj layout tests/test_convert_chgnet.py:328-342 converts
    assert CHGNET_KW == dict(num_species=89, units=64, num_rbf=31, num_angle=4,
                             num_blocks=4, cutoff=6.0, bond_cutoff=3.0)
