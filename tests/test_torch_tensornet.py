"""The slice end to end: TensorNet through ``DistPotential`` at P=1, JAX vs port.

A small TensorNet (units 16, 8 RBF, 2 layers, cutoff 4.0, 4 species) on a
32-atom perturbed crystal. JAX side: ``distmlip_tpu.calculators.
DistPotential(num_partitions=1)`` with its own initialised parameters, once
with ``kernels=False`` (plain XLA) and once with ``kernels="interpret"``
(the Pallas edge-aggregate kernel in interpret mode). The readout's
``species_ref`` and ``data_std`` are set to distinct non-default values, so
a dropped readout term shows. Port side: ``DistPotential(device="cpu")``
with those parameters carried across by ``params_from_numpy`` and, once
more, through ``save_params`` -> ``load_params``.

Tolerances: both sides compute in float32 with the same arithmetic but sum
in different orders, so rel dE < 1e-5, and max |dF|, max |dS| < 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import TensorNet as JTensorNet
from distmlip_tpu.models import TensorNetConfig as JTensorNetConfig
from distmlip_tpu.models.tensornet import decompose as jax_decompose
from distmlip_tpu.utils.checkpoint import save_params
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
from distmlip_tpu_torch.models.tensornet import decompose, decompose_compact, expand_compact
from distmlip_tpu_torch.parallel import halo
from distmlip_tpu_torch.tools.workload import TENSORNET_BF16_KW, TENSORNET_KW
from distmlip_tpu_torch.utils import load_params, params_from_numpy
from tests.utils import make_crystal
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(num_species=4, units=16, num_rbf=8, num_layers=2, cutoff=4.0)


def _structure(seed=1):
    return make_crystal(np.random.default_rng(seed), reps=(2, 2, 2), a=4.0, n_species=3)


def _jax_params():
    params = jax.tree.map(np.array, JTensorNet(JTensorNetConfig(**CFG)).init(
        jax.random.PRNGKey(0)))
    params["species_ref"]["w"][:, 0] = np.array([0.3, -1.2, 0.7, 2.0], np.float32)
    params["data_std"] = np.array(1.7, np.float32)
    return params


def _jax_calculate(params, structure, kernels):
    cart, lat, spec = structure
    pot = JDistPotential(JTensorNet(JTensorNetConfig(**CFG)), params, num_partitions=1,
                         kernels=kernels)
    return pot.calculate(JAtoms(numbers=spec, positions=cart, cell=lat))


@pytest.fixture(scope="module")
def jax_case():
    structure = _structure()
    params = _jax_params()
    return structure, params, _jax_calculate(params, structure, False)


def _atoms(structure):
    cart, lat, spec = structure
    return Atoms(numbers=spec, positions=cart.copy(), cell=lat)


def _assert_close(res, ref):
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 1e-2  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], atol=1e-4)


def test_tensornet_matches_jax_params_from_numpy(jax_case):
    structure, params, ref = jax_case
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params_from_numpy(params),
                        device="cpu")
    res = pot.calculate(_atoms(structure))
    _assert_close(res, ref)
    assert res["forces"].shape == (len(structure[0]), 3)


def test_tensornet_matches_jax_interpret_kernels(jax_case):
    """Against the JAX package with its Pallas edge-aggregate kernel (in
    interpret mode) on both TensorNet call sites."""
    structure, params, _ = jax_case
    ref = _jax_calculate(params, structure, "interpret")
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), params, device="cpu")
    _assert_close(pot.calculate(_atoms(structure)), ref)


def test_tensornet_matches_jax_through_checkpoint(jax_case, tmp_path):
    structure, params, ref = jax_case
    path = str(tmp_path / "tensornet.npz")
    save_params(path, params)
    loaded = load_params(path)
    pot = DistPotential(TensorNet(TensorNetConfig(**CFG)), loaded, device="cpu",
                        kernels=False)
    _assert_close(pot.calculate(_atoms(structure)), ref)


def test_params_carry_the_tensornet_tree_unchanged(jax_case):
    """Lists of linears, the ``layers`` list of dicts, the ``final`` MLP
    list and the 0-d ``data_std`` keep their structure, shapes and values;
    the port's own init has the same tree."""
    _, params, _ = jax_case
    carried = params_from_numpy(params)
    own = TensorNet(TensorNetConfig(**CFG)).init(0)

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
    assert len(carried["layers"]) == CFG["num_layers"]
    assert len(carried["final"]) == 3


def test_skin_cache_reuses_graph_and_stays_exact(jax_case):
    """3 small moves after the first call reuse the graph (no rebuild) and
    give the same numbers as a fresh build at each step; a large move
    rebuilds."""
    structure, params, _ = jax_case
    model = TensorNet(TensorNetConfig(**CFG))
    cached = DistPotential(model, params, device="cpu", skin=0.5)
    fresh = DistPotential(model, params, device="cpu", skin=0.0)
    rng = np.random.default_rng(7)
    atoms = _atoms(structure)
    cached.calculate(atoms)
    assert cached.rebuild_count == 1
    for _ in range(3):
        atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        a, b = cached.calculate(atoms), fresh.calculate(atoms)
        assert abs(a["energy"] - b["energy"]) < 1e-5 * abs(b["energy"])
        np.testing.assert_allclose(a["forces"], b["forces"], atol=1e-4)
        np.testing.assert_allclose(a["stress"], b["stress"], atol=1e-4)
    assert cached.rebuild_count == 1
    atoms.positions[0] += 0.4  # past skin/2
    cached.calculate(atoms)
    assert cached.rebuild_count == 2


@pytest.mark.parametrize("num_layers", [1, 2])
def test_edge_aggregate_calls_per_calculate(monkeypatch, num_layers):
    """The count chip_smoke.py checks against the kernels' launch counters:
    per calculate, one embed aggregation and one per interaction layer, all
    on sorted ids with edges (the route that launches a kernel on the card).
    The backward aggregates nothing: on the card it launches the
    interaction's backward kernel once per layer, on the CPU it recomputes
    messages in plain torch."""
    calls = []
    real = halo.fused_edge_aggregate

    def counted(message, inputs, segment_ids, num_segments, mask=None, **kw):
        assert kw["indices_are_sorted"] and segment_ids.shape[0] > 0
        calls.append(message.name)
        return real(message, inputs, segment_ids, num_segments, mask, **kw)

    monkeypatch.setattr(halo, "fused_edge_aggregate", counted)
    cfg = TensorNetConfig(**dict(CFG, num_layers=num_layers))
    pot = DistPotential(TensorNet(cfg), TensorNet(cfg).init(1), device="cpu", skin=0.3)
    atoms = _atoms(_structure(seed=3))
    pot.calculate(atoms)
    assert calls == ["tensornet_embed_aggregate"] + ["tensornet_interaction_aggregate"] * num_layers
    atoms.positions += 0.01
    pot.calculate(atoms)
    assert len(calls) == 2 * (1 + num_layers)


def test_compact_rows_expand_to_decompose_bit_for_bit():
    """The interaction's compact I, A, S rows (the trace / 3; A's (0,1),
    (0,2), (1,2); S's diagonal and (0,1), (0,2), (1,2)) expand to the port's
    full ``decompose`` bit for bit, and agree with the JAX package's to
    float32 roundoff."""
    X = np.random.default_rng(2).normal(size=(40, 3, 3, 7)).astype(np.float32)
    i, a, s = decompose_compact(torch.from_numpy(X))
    assert i.shape == (40, 7) and a.shape == (40, 3, 7) and s.shape == (40, 6, 7)
    expanded = expand_compact(i, a, s)
    for got, want, jwant in zip(expanded, decompose(torch.from_numpy(X)),
                                jax_decompose(jax.numpy.asarray(X))):
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a.numpy(), expanded[1][:, (0, 0, 1), (1, 2, 2)].numpy())
    np.testing.assert_array_equal(s[:, 3:].numpy(), expanded[2][:, (1, 2, 2), (0, 0, 1)].numpy())


def test_unported_options_and_workload():
    """The compute dtypes the model takes (bfloat16:
    ``tests/test_torch_bf16_tensornet.py`` holds it against the JAX
    package), and the workloads' MatPES layout at both."""
    assert TensorNet(TensorNetConfig(**CFG, dtype="bfloat16")).cfg.dtype == "bfloat16"
    with pytest.raises(ValueError, match="float16"):
        TensorNet(TensorNetConfig(**CFG, dtype="float16"))
    # the MatPES layout tests/test_convert_tensornet.py:228-240 converts
    assert TENSORNET_KW == dict(num_species=89, units=64, num_rbf=32, num_layers=2,
                                cutoff=5.0)
    assert TENSORNET_BF16_KW == dict(TENSORNET_KW, dtype="bfloat16")
