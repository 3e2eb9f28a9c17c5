"""ESCNMD (the UMA/fairchem-parameterized eSCN) and ``UMAPredictor`` on the
port, against the JAX package.

The small ESCNMD of ``tests/test_escn_md.py`` (10 elements, C 16, lmax 2,
2 layers, hidden 16, edge channels 8, 12 gaussians, cutoff 3.5 Å) in two
cases: "full" (one expert, mmax 2) and "experts3_mmax1" (3 MOLE experts,
mmax 1, so the narrowed edge frame), on a 64-atom crystal (a = 4.0 Å,
0.1 Å noise, 3 species; 16 Å along x, so P = 2 slabs are wider than twice
the cutoff). Parameters: one numpy tree for both packages (the port's
``init``, whose layout is the JAX model's), carried across by
``params_from_numpy``, ``species_ref`` off its zero default. Reference:
the JAX package's ``UMAPredictor(task_name="oc20")`` at P = 1 with charge 1
and spin 2 in ``atoms.info``; the port's ``UMAPredictor`` runs the same at
P = 1, at P = 2, with edge chunks of 64 (K > 1) and with them without
remat.

Tolerances: float32 on both sides, summed in other orders: rel dE < 1e-5,
max |dF|, |dS| < 1e-4 (``tests/test_torch_escn.py``'s). Gauge invariance
(per-edge gamma injected into the Wigner blocks), the JAX test's bars:
|dE|/atom < 1e-6, max |dF| < 2e-4, max |dS| < 1e-5. bf16 (PERF.md §2):
against the JAX package's bf16, |dE|/atom <= 1e-3 eV and max |dF|, |dS|
<= 0.05 of the largest; against the port's float32, 5e-3 eV/atom and
dF_rel < 0.1.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import BatchedPotential as JBatchedPotential
from distmlip_tpu.calculators import UMAPredictor as JUMAPredictor
from distmlip_tpu.models import ESCNMD as JESCNMD
from distmlip_tpu.models import ESCNMDConfig as JESCNMDConfig
from distmlip_tpu_torch.calculators import (UMA_TASK_DATASETS, Atoms, BatchedPotential,
                                            DistPotential, UMAPredictor)
from distmlip_tpu_torch.models import ESCNMD, ESCNMDConfig
from distmlip_tpu_torch.models import escn_md as escn_md_module
from distmlip_tpu_torch.ops.chunk import chunk_layout
from distmlip_tpu_torch.tools.workload import UMA_INFO, UMA_KW
from distmlip_tpu_torch.utils import params_from_numpy
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.utils import make_crystal

CFG = dict(max_num_elements=10, sphere_channels=16, lmax=2, mmax=2, num_layers=2,
           hidden_channels=16, edge_channels=8, num_distance_basis=12, cutoff=3.5,
           avg_degree=12.0, edge_chunk=0)
CASES = {"full": CFG, "experts3_mmax1": dict(CFG, num_experts=3, mmax=1)}
INFO = {"charge": 1, "spin": 2}
TASK = "oc20"
ROUTES = {"P1": dict(num_partitions=1), "P2": dict(num_partitions=2),
          "chunk64": dict(edge_chunk=64), "chunk64_no_remat": dict(edge_chunk=64, remat=False)}


def _structure(seed=0):
    return make_crystal(np.random.default_rng(seed), reps=(4, 2, 2), a=4.0, noise=0.1,
                        n_species=3)


def _atoms(info=INFO, cls=Atoms):
    cart, lat, spec = _structure()
    return cls(numbers=spec, positions=cart.copy(), cell=lat, info=dict(info))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _params(cfg, seed=0):
    """The model's parameters as the numpy tree both packages take (the
    port's ``init``, which has the JAX tree's layout:
    ``test_params_carry_the_escn_md_tree_unchanged``)."""
    params = _numpy(ESCNMD(ESCNMDConfig(**cfg)).init(seed))
    params["species_ref"]["w"] = np.linspace(-1.0, 1.5, cfg["max_num_elements"],
                                             dtype=np.float32)
    return params


def _port(cfg, params, task=TASK, **kw):
    return UMAPredictor(ESCNMD(ESCNMDConfig(**cfg)), params_from_numpy(params), task_name=task,
                        device="cpu", **kw)


def _assert_close(res, ref, rel_e=1e-5, atol=1e-4):
    assert abs(res["energy"] - ref["energy"]) < rel_e * abs(ref["energy"])
    assert np.abs(ref["forces"]).max() > 5e-3  # non-degeneracy guard
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=atol)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def refs():
    """Per case: the parameters and the JAX UMAPredictor's result."""
    out = {}
    for name, cfg in CASES.items():
        params = _params(cfg)
        pred = JUMAPredictor(JESCNMD(JESCNMDConfig(**cfg)), params, task_name=TASK,
                             num_partitions=1)
        out[name] = (params, pred.calculate(_atoms(cls=JAtoms)))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_escn_md_matches_jax(refs, case, route):
    params, ref = refs[case]
    kw = dict(ROUTES[route])
    cfg = dict(CASES[case], **{k: kw.pop(k) for k in ("edge_chunk", "remat") if k in kw})
    pred = _port(cfg, params, **kw)
    res = pred.calculate(_atoms())
    _assert_close(res, ref)
    K = chunk_layout(pred.potential.last_stats["e_cap"], cfg["edge_chunk"])[2]
    assert (K > 1) == route.startswith("chunk")


def _with_gamma(monkeypatch, gamma_of_rhat):
    real = escn_md_module.wigner_blocks_from_edges

    def patched(l_max, rhat, gamma=None):
        assert gamma is None  # the model itself always passes the default
        return real(l_max, rhat, gamma=gamma_of_rhat(rhat))

    monkeypatch.setattr(escn_md_module, "wigner_blocks_from_edges", patched)


def _random_gamma(rhat):
    g = np.random.default_rng(123).uniform(0, 2 * np.pi, rhat.shape[0])
    return torch.as_tensor(g, dtype=torch.float32)


def _fairchem_gamma(rhat):
    """The gauge angle of fairchem's edge frame: a rotation R with R y-hat
    = rhat built from a deterministic perpendicular helper, and its YXY
    Euler gamma = atan2(R[1, 0], -R[1, 2]) (``tests/test_escn_md.py:233``)."""
    v = rhat.float()
    helper = v[:, [1, 2, 0]] * torch.tensor([1.0, -1.0, 1.0]) + 0.3
    x_ax = torch.linalg.cross(helper, v)
    x_ax = x_ax / torch.clamp(torch.linalg.norm(x_ax, dim=1, keepdim=True), min=1e-12)
    z_ax = torch.linalg.cross(x_ax, v)
    z_ax = z_ax / torch.clamp(torch.linalg.norm(z_ax, dim=1, keepdim=True), min=1e-12)
    return torch.atan2(x_ax[:, 1], -z_ax[:, 1])


@pytest.mark.parametrize("gauge", ["random", "fairchem_frame"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gauge_invariance(refs, monkeypatch, case, gauge):
    """Energies, forces and stress do not move under per-edge gauge
    angles: random ones, and those of a fairchem-style edge frame; the
    gauged run still matches the JAX package."""
    params, ref = refs[case]
    plain = _port(CASES[case], params).calculate(_atoms())
    _with_gamma(monkeypatch, {"random": _random_gamma, "fairchem_frame": _fairchem_gamma}[gauge])
    gauged = _port(CASES[case], params).calculate(_atoms())
    n = len(_structure()[0])
    assert abs(gauged["energy"] - plain["energy"]) / n < 1e-6
    np.testing.assert_allclose(gauged["forces"], plain["forces"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(gauged["stress"], plain["stress"], rtol=0, atol=1e-5)
    _assert_close(gauged, ref, atol=2e-4)


def test_gamma_rotates_the_wigner_blocks():
    """D(alpha, beta, gamma) = D(alpha, beta, 0) X(gamma): at gamma = 0 the
    blocks are the gamma-free ones, and each block stays orthogonal."""
    from distmlip_tpu_torch.ops.so3_e3nn import wigner_blocks_from_edges

    rhat = torch.nn.functional.normalize(torch.randn(7, 3, dtype=torch.float64), dim=1)
    base = wigner_blocks_from_edges(3, rhat)
    zero = wigner_blocks_from_edges(3, rhat, gamma=torch.zeros(7, dtype=torch.float64))
    turned = wigner_blocks_from_edges(3, rhat, gamma=torch.linspace(0, 5, 7, dtype=torch.float64))
    for b, z, t in zip(base, zero, turned):
        torch.testing.assert_close(z, b, rtol=0, atol=1e-14)
        eye = torch.eye(b.shape[-1], dtype=torch.float64).expand_as(t)
        torch.testing.assert_close(t @ t.transpose(1, 2), eye, rtol=0, atol=1e-12)
        # the edge axis (the m = 0 column) is what gamma leaves alone
        l = (b.shape[-1] - 1) // 2
        torch.testing.assert_close(t[:, :, l], b[:, :, l], rtol=0, atol=1e-12)


def test_csd_conditioning_moves_the_energy(refs):
    params, _ = refs["full"]
    energies = {}
    for info in ({"charge": 0}, {"charge": 2}, {"charge": 0, "spin": 3},
                 {"charge": 0, "dataset": 3}):
        pot = DistPotential(ESCNMD(ESCNMDConfig(**CFG)), params, device="cpu")
        energies[tuple(sorted(info.items()))] = pot.calculate(_atoms(info))["energy"]
    assert len({round(e, 6) for e in energies.values()}) == 4


def _deltas(a, b, n):
    return (abs(a["energy"] - b["energy"]) / n,
            float(np.abs(a["forces"] - b["forces"]).max() / np.abs(b["forces"]).max()),
            float(np.abs(a["stress"] - b["stress"]).max() / np.abs(b["stress"]).max()))


def test_bf16_matches_jax_and_its_own_float32(refs):
    cfg = dict(CASES["experts3_mmax1"], dtype="bfloat16")
    params, f32_ref = refs["experts3_mmax1"]
    ref = JUMAPredictor(JESCNMD(JESCNMDConfig(**cfg)), params, task_name=TASK,
                        num_partitions=1).calculate(_atoms(cls=JAtoms))
    pred = _port(cfg, params)
    assert pred.potential.compute_dtype == "bfloat16"
    res = pred.calculate(_atoms())
    assert res["forces"].dtype == np.float32 and np.isfinite(res["forces"]).all()
    n = len(_structure()[0])
    got = _deltas(res, ref, n)
    assert got[0] <= 1e-3 and got[1] <= 0.05 and got[2] <= 0.05, got
    de, df, _ = _deltas(res, _port(CASES["experts3_mmax1"], params).calculate(_atoms()), n)
    assert 0.0 < de < 5e-3 and df < 0.1, (de, df)
    # the JAX float32 reference is as far: the two float32 results agree
    _assert_close(_port(CASES["experts3_mmax1"], params).calculate(_atoms()), f32_ref)


def test_uma_predictor_routes_tasks_as_the_jax_one(refs):
    """The task name sets the dataset index where ``atoms.info`` has none;
    an explicit dataset wins; an unknown task raises; other keywords reach
    ``DistPotential``."""
    params, ref = refs["full"]
    assert UMA_TASK_DATASETS == {"omol": 0, "omat": 1, "oc20": 2, "odac": 3}
    by_task = {t: _port(CFG, params, task=t).calculate(_atoms())["energy"]
               for t in ("omat", "oc20")}
    assert abs(by_task["omat"] - by_task["oc20"]) > 1e-4
    assert by_task["oc20"] == _port(CFG, params, task="omat").calculate(
        _atoms(dict(INFO, dataset=2)))["energy"]
    atoms = _atoms()
    pred = _port(CFG, params, task="odac", skin=0.5, kernels=False)
    pred.calculate(atoms)
    assert "dataset" not in atoms.info  # the caller's atoms are left as they were
    assert pred.dataset_id == 3 and pred.potential.skin == 0.5
    assert pred.potential.device.type == "cpu" and pred.potential.kernels is False
    with pytest.raises(ValueError, match="unknown task 'omc'"):
        UMAPredictor(ESCNMD(ESCNMDConfig(**CFG)), params, task_name="omc", device="cpu")
    with pytest.raises(ValueError, match="unknown task 'omc'"):
        JUMAPredictor(JESCNMD(JESCNMDConfig(**CFG)), params, task_name="omc")


@pytest.mark.parametrize("info,match", [
    ({"charge": 13}, "charge 13 outside"), ({"charge": -13}, "charge -13 outside"),
    ({"spin": 10}, "spin 10 outside"), ({"dataset": 4}, "dataset 4 outside"),
])
def test_out_of_range_scalars_raise_as_in_jax(refs, info, match):
    params, _ = refs["full"]
    with pytest.raises(ValueError, match=match):
        _port(CFG, params).calculate(_atoms(info))
    with pytest.raises(ValueError, match=match):
        JUMAPredictor(JESCNMD(JESCNMDConfig(**CFG)), params,
                      num_partitions=1).calculate(_atoms(info, cls=JAtoms))


@pytest.mark.parametrize("remat", [True, False])
def test_segment_sum_calls_per_calculate(refs, monkeypatch, remat):
    """The count chip_smoke.py checks against B1's launch counter: per
    calculate, the edge-degree pass and each layer's messages, once per
    edge chunk, on sorted ids with a mask (the route that launches the
    kernel on the card), and once more per chunk in the backward's
    recompute of the checkpointed chunk body with remat."""
    calls = []
    real = escn_md_module.fused_segment_sum

    def seg(data, ids, n, mask=None, indices_are_sorted=False, kernels=True):
        calls.append(tuple(data.shape[1:]))
        assert indices_are_sorted and mask is not None and mask.dtype == torch.bool
        return real(data, ids, n, mask, indices_are_sorted=True, kernels=kernels)

    monkeypatch.setattr(escn_md_module, "fused_segment_sum", seg)
    cfg = dict(CASES["experts3_mmax1"], edge_chunk=64, remat=remat)
    pred = _port(cfg, refs["experts3_mmax1"][0])
    pred.calculate(_atoms())
    K = chunk_layout(pred.potential.last_stats["e_cap"], 64)[2]
    assert K > 1
    assert len(calls) == (1 + cfg["num_layers"]) * K * (2 if remat else 1)
    assert set(calls) == {(9, 16)}  # ((lmax+1)^2, C) rows: the full lab layout


def test_batched_potential_refuses_moe_escn_md_as_jax_does(refs):
    params, _ = refs["experts3_mmax1"]
    cart, lat, spec = _structure()
    structures = [Atoms(numbers=spec, positions=cart, cell=lat) for _ in range(2)]
    with pytest.raises(NotImplementedError) as port_err:
        BatchedPotential(ESCNMD(ESCNMDConfig(**CASES["experts3_mmax1"])), params,
                         device="cpu").calculate(structures)
    with pytest.raises(NotImplementedError) as jax_err:
        JBatchedPotential(JESCNMD(JESCNMDConfig(**CASES["experts3_mmax1"])), params).calculate(
            [JAtoms(numbers=spec, positions=cart, cell=lat) for _ in range(2)])
    assert str(port_err.value) == str(jax_err.value)
    assert "MOLE gate pools composition per system" in str(port_err.value)


def _walk(a, b, c):
    """Trees ``a`` (numpy), ``b`` (``a`` carried across) and ``c`` (torch)
    alike in keys, list positions, shapes and float32 values of ``a`` and
    ``b``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            _walk(a[k], b[k], c[k])
    elif isinstance(a, list):
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            _walk(x, y, z)
    else:
        assert tuple(b.shape) == np.shape(a) == tuple(c.shape)
        assert b.dtype == c.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)


def test_params_carry_the_escn_md_tree_unchanged():
    """The JAX model's ``init`` tree survives ``params_from_numpy``, and the
    port's own init has the same tree (3 experts: ``mole_gate`` present);
    with one expert there is no gate."""
    cfg = CASES["experts3_mmax1"]
    model = JESCNMD(JESCNMDConfig(**cfg))
    params = jax.tree.map(np.array, jax.jit(model.init)(jax.random.PRNGKey(0)))
    own = ESCNMD(ESCNMDConfig(**cfg)).init(0)
    _walk(params, params_from_numpy(params), own)
    assert "mole_gate" in own and "mole_gate" not in ESCNMD(ESCNMDConfig(**CFG)).init(0)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ESCNMD(ESCNMDConfig(**dict(CFG, dtype="float16")))
    with pytest.raises(NotImplementedError, match="lmax > 6"):
        ESCNMD(ESCNMDConfig(**dict(CFG, lmax=7)))


def test_uma_workload():
    """``chip_smoke.py``'s UMA-S backbone: fairchem's published ``uma_sm``
    widths (sphere channels 128, lmax = mmax = 2, 4 layers, hidden and edge
    channels 128, 64 gaussians, 32 experts, cutoff 6 Å, 100 elements, 4
    datasets as ``UMA_TASK_DATASETS`` routes), float32, and charge 1, spin
    1 on the ``omat`` task."""
    assert UMA_KW == dict(max_num_elements=100, sphere_channels=128, lmax=2, mmax=2,
                          num_layers=4, hidden_channels=128, edge_channels=128,
                          num_distance_basis=64, num_experts=32, cutoff=6.0, num_datasets=4,
                          edge_chunk=32768, remat=True)
    assert UMA_INFO == {"charge": 1, "spin": 1} and len(UMA_TASK_DATASETS) == 4
    cfg = ESCNMDConfig(**UMA_KW)
    assert cfg.dtype == "float32" and cfg.sphere_dim == 9
