"""``EnsemblePotential``, JAX vs port.

Members: one parameter tree (the port's ``init`` as numpy, whose layout
is the JAX model's; the JAX ``init`` of MACE costs ~10 s here) and copies with every float
leaf scaled by (1 + 0.05 n), n drawn per element from a numpy seed, so the
members differ everywhere. The same trees go to the JAX
``EnsemblePotential`` (its stacked route: one vmapped program) and to the
port's, through ``params_from_numpy``:

- 3 small MACE members (2 interactions, 8 channels, cutoff 3.0 Å) at P = 1
  and P = 2;
- 2 small CHGNet members with magmoms (``compute_magmom=True``) at P = 2,
  as ``tests/test_chgnet.py:173``;

on a 64-atom rattled fcc cell, a = 3.5 Å, 1 x 2 x 8 cells (28 Å along the
slab axis, so P = 2 slabs are wider than twice the cutoff).

Bars: every member's energy within rel 1e-5 and its forces, stress and
magmoms within 1e-4 of JAX's (float32 on both sides, summed in other
orders), the means likewise; the variances within the error those member
errors can make of them, 2 max|d| max|x - mean| + max|d|^2. The port's
stacked route equals its sequential route exactly: the members see the
same graph and run the same program.
"""

import numpy as np
import pytest

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import EnsemblePotential as JEnsemblePotential
from distmlip_tpu.models import CHGNet as JCHGNet
from distmlip_tpu.models import CHGNetConfig as JCHGNetConfig
from distmlip_tpu.models import MACE as JMACE
from distmlip_tpu.models import MACEConfig as JMACEConfig
from distmlip_tpu_torch.calculators import Atoms, DistPotential, EnsemblePotential
from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, MACE, MACEConfig
from distmlip_tpu_torch.partition import CapacityPolicy
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.utils import make_crystal

MACE_CFG = dict(num_species=4, channels=8, l_max=1, a_lmax=1, hidden_lmax=1, correlation=2,
                num_interactions=2, num_bessel=4, radial_mlp=8, cutoff=3.0,
                avg_num_neighbors=12.0, edge_chunk=0)
CHGNET_CFG = dict(num_species=4, units=16, num_rbf=6, num_angle=4, num_blocks=3, cutoff=3.0,
                  bond_cutoff=2.6)
FAMILIES = {"mace": (JMACE, JMACEConfig, MACE, MACEConfig, MACE_CFG, 3, {}),
            "chgnet": (JCHGNet, JCHGNetConfig, CHGNet, CHGNetConfig, CHGNET_CFG, 2,
                       {"compute_magmom": True})}
CASES = {"mace_P1": ("mace", 1), "mace_P2": ("mace", 2), "chgnet_P2": ("chgnet", 2)}


def _structure():
    return make_crystal(np.random.default_rng(1), reps=(1, 2, 8), a=3.5, noise=0.1,
                        n_species=4)


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [leaf(v) for v in x]
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        return (x * (1 + 0.05 * rng.standard_normal(x.shape))).astype(x.dtype)

    return leaf(tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _members(family):
    *_, model_cls, cfg_cls, cfg, count, _kw = FAMILIES[family]
    base = _numpy(model_cls(cfg_cls(**cfg)).init(0))
    return [base] + [_jitter(base, seed) for seed in range(1, count)]


@pytest.fixture(scope="module")
def cases():
    """Each case's members and the JAX ensemble's result (one JAX
    evaluation per case)."""
    cart, lat, spec = _structure()
    out = {}
    for name, (family, P) in CASES.items():
        jmodel_cls, jcfg_cls, *_, cfg, _count, kw = FAMILIES[family]
        members = _members(family)
        ens = JEnsemblePotential(jmodel_cls(jcfg_cls(**cfg)), members, num_partitions=P,
                                 kernels=False, **kw)
        out[name] = members, ens.calculate(JAtoms(numbers=spec, positions=cart, cell=lat))
    return out


def _port(family, members, P, **kw):
    *_, model_cls, cfg_cls, cfg, _count, fam_kw = FAMILIES[family]
    return EnsemblePotential(model_cls(cfg_cls(**cfg)), members, num_partitions=P,
                             device="cpu", **fam_kw, **kw)


def _atoms():
    cart, lat, spec = _structure()
    return Atoms(numbers=spec, positions=cart, cell=lat)


def _var_bar(d, x):
    """The error member errors up to ``d`` can make of the variance of
    members ``x`` (per element over axis 0)."""
    spread = np.abs(x - x.mean(axis=0)).max()
    return 2 * d * spread + d * d + 1e-12


@pytest.mark.parametrize("name", sorted(CASES))
def test_ensemble_matches_jax(cases, name):
    members, ref = cases[name]
    family, P = CASES[name]
    ens = _port(family, members, P)
    got = ens.calculate(_atoms())
    e_ref = np.asarray(ref["energies"])
    assert got["energies"].shape == (len(members),) and got["energies"].dtype == np.float64
    np.testing.assert_allclose(got["energies"], e_ref, rtol=1e-5)
    assert np.abs(ref["forces_all"]).max() > 1e-3  # non-degeneracy guard
    np.testing.assert_allclose(got["forces_all"], ref["forces_all"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["stress"], ref["stress"], rtol=0, atol=1e-4)
    assert abs(got["energy"] - ref["energy"]) <= 1e-5 * abs(ref["energy"])
    assert got["free_energy"] == got["energy"]
    d_e = np.abs(got["energies"] - e_ref).max()
    assert abs(got["energy_var"] - ref["energy_var"]) <= _var_bar(d_e, e_ref)
    assert ref["energy_var"] > 10 * _var_bar(d_e, e_ref)  # the members differ
    d_f = np.abs(got["forces_all"] - ref["forces_all"]).max()
    np.testing.assert_allclose(got["forces_var"], ref["forces_var"], rtol=0,
                               atol=_var_bar(d_f, np.asarray(ref["forces_all"])))
    if family == "chgnet":
        assert got["magmoms_all"].shape == (len(members), len(_atoms()))
        np.testing.assert_allclose(got["magmoms_all"], ref["magmoms_all"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["magmoms"], ref["magmoms"], rtol=0, atol=1e-4)
    else:
        assert "magmoms" not in got
    assert ens.last_stats["member_count"] == len(members)
    assert ens.last_stats["num_partitions"] == P
    assert "device_s" in ens.last_timings


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_equals_sequential_and_lone_members(cases, name):
    members, _ = cases[name]
    family, P = CASES[name]
    atoms = _atoms()
    stacked = _port(family, members, P)
    got = stacked.calculate(atoms)
    seq = _port(family, members, P, stacked=False)
    want = seq.calculate(atoms)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # one graph for the stacked members, one per sequential member
    assert stacked.members[0].rebuild_count == 1 and len(stacked.members) == 1
    assert [m.rebuild_count for m in seq.members] == [1] * len(members)
    assert stacked.last_stats == seq.last_stats
    # each member against a lone DistPotential on its parameters
    *_, model_cls, cfg_cls, cfg, _count, kw = FAMILIES[family]
    lone = DistPotential(model_cls(cfg_cls(**cfg)), members[-1], num_partitions=P,
                         device="cpu", **kw).calculate(atoms)
    assert got["energies"][-1] == lone["energy"]
    np.testing.assert_array_equal(got["forces_all"][-1], lone["forces"])


def test_refusals_and_shared_caps(cases):
    members, _ = cases["mace_P1"]
    with pytest.raises(ValueError, match="non-empty"):
        _port("mace", [], 1)
    bad = [members[0], {k: v for k, v in members[1].items() if k != "shift"}]
    with pytest.raises(ValueError, match="shift"):
        _port("mace", bad, 1)
    wrong = [members[0], dict(members[1], scale=np.ones(2, np.float32))]
    with pytest.raises(ValueError, match="scale"):
        _port("mace", wrong, 1)
    caps = CapacityPolicy()
    seq = _port("mace", members, 1, stacked=False, caps=caps)
    assert all(m.caps is caps for m in seq.members)
    assert _port("mace", members, 1).members[0].caps is not caps
