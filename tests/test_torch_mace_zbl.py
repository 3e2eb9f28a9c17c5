"""MACE with ``zbl=True`` (the ZBL pair term of MACE-MP-0b), JAX vs port.

The configuration is ``tests/test_mace.py``'s ZBL case (channels 8,
l_max 1, correlation 2, one interaction, cutoff 3.2 Å, species 0-3 as Si,
Si, O, O). The structure is a compressed fcc cell (a = 3.0 Å, nearest
neighbours ~2.1 Å, rattled by 0.1 Å), so Si-Si pairs sit inside the sum of
their covalent radii (2.22 Å) and the pair term is well above float32
resolution (asserted).

- float32 through both ``DistPotential``s (JAX ``kernels=False``, the port
  on the CPU): the repo's float32 bar, rel dE < 1e-5 and max |dF|, |dS| <
  1e-4 (two summation orders);
- float64 through both runtimes on float64 graphs (``jax_enable_x64`` on
  the JAX side): rel dE < 1e-10, |dF|, |dS| < 1e-9, so a fault in the
  algorithm cannot hide under float32 roundoff;
- the pair term's edge sum goes through the segment-sum dispatcher once
  per calculate (per edge segment at P = 2), at width 1.
"""

import jax
import numpy as np
import pytest
import torch

from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.models import MACE as JMACE
from distmlip_tpu.models import MACEConfig as JMACEConfig
from distmlip_tpu.neighbors import neighbor_list_numpy as jax_nl
from distmlip_tpu.parallel import make_potential_fn as jax_make_potential_fn
from distmlip_tpu.partition import CapacityPolicy as JCaps
from distmlip_tpu.partition import build_partitioned_graph as jax_build_graph
from distmlip_tpu.partition import build_plan as jax_build_plan
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import MACE, MACEConfig
from distmlip_tpu_torch.models import mace as mace_module
from distmlip_tpu_torch.neighbors import neighbor_list_numpy
from distmlip_tpu_torch.parallel import make_potential_fn
from distmlip_tpu_torch.partition import CapacityPolicy, build_partitioned_graph, build_plan
from distmlip_tpu_torch.utils import params_from_numpy
from tests.utils import make_crystal

CFG = dict(num_species=4, channels=8, l_max=1, a_lmax=1, hidden_lmax=1, correlation=2,
           num_interactions=1, num_bessel=4, radial_mlp=8, cutoff=3.2,
           avg_num_neighbors=6.0, zbl=True, atomic_numbers=(14, 14, 8, 8))


def _structure(reps=(2, 2, 2)):
    return make_crystal(np.random.default_rng(7), reps=reps, a=3.0, noise=0.1, n_species=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The port's ``init(0)`` as numpy: the two packages share the tree
    layout, so the JAX side takes the same weights without a JAX init."""
    return jax.tree.map(lambda x: x.numpy(), MACE(MACEConfig(**CFG)).init(0))


def _assert_close(res, ref, rel_e=1e-5, atol=1e-4):
    assert abs(res["energy"] - ref["energy"]) < rel_e * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=atol)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=atol)


def test_mace_zbl_matches_jax(params):
    cart, lat, spec = _structure()
    ref = JDistPotential(JMACE(JMACEConfig(**CFG)), params, num_partitions=1,
                         kernels=False).calculate(JAtoms(numbers=spec, positions=cart, cell=lat))
    pot = DistPotential(MACE(MACEConfig(**CFG)), params_from_numpy(params), device="cpu")
    res = pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat))
    _assert_close(res, ref)
    # the pair term is well above the comparison's bar, so it is compared
    plain = DistPotential(MACE(MACEConfig(**dict(CFG, zbl=False))), params_from_numpy(params),
                          device="cpu")
    e_zbl = res["energy"] - plain.calculate(Atoms(numbers=spec, positions=cart,
                                                  cell=lat))["energy"]
    assert e_zbl > 10 * 1e-5 * abs(res["energy"])


def test_mace_zbl_matches_jax_float64(params):
    """Both runtimes on float64 graphs and float64 parameters."""
    cart, lat, spec = _structure()
    r = CFG["cutoff"]
    params64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    jax.config.update("jax_enable_x64", True)
    try:
        jg, jh = jax_build_graph(jax_build_plan(jax_nl(cart, lat, [1, 1, 1], r), lat,
                                                [1, 1, 1], 1, r, impl="numpy"),
                                 jax_nl(cart, lat, [1, 1, 1], r), spec, lat, caps=JCaps(),
                                 dtype=np.float64)
        jout = jax_make_potential_fn(JMACE(JMACEConfig(**CFG)).energy_fn, None)(
            jax.tree.map(jax.numpy.asarray, params64), jg, jg.positions)
        ref = {"energy": float(jout["energy"]),
               "forces": jh.gather_owned(np.asarray(jout["forces"]), len(cart)),
               "stress": np.asarray(jout["stress"])}
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref["forces"].dtype == np.float64
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], r)
    g, h = build_partitioned_graph(build_plan(nl, lat, [1, 1, 1], 1, r), nl, spec, lat,
                                   caps=CapacityPolicy(), dtype=np.float64)
    g = g.to("cpu")
    out = make_potential_fn(MACE(MACEConfig(**CFG)).energy_fn)(
        params_from_numpy(params64), g, g.positions)
    res = {"energy": float(out["energy"]),
           "forces": h.gather_owned(out["forces"].numpy(), len(cart)),
           "stress": out["stress"].numpy()}
    assert res["forces"].dtype == np.float64
    _assert_close(res, ref, rel_e=1e-10, atol=1e-9)


@pytest.mark.parametrize("P", [1, 2])
def test_zbl_edge_sum_is_one_width_one_segment_sum_per_segment(params, P, monkeypatch):
    """The pair term adds one segment sum of width 1 per calculate at P = 1,
    one per edge segment (interior, frontier) at P = 2, on top of the
    density projection's n_interactions x 2K."""
    calls = []
    real = mace_module.fused_segment_sum

    def counted(data, *args, **kw):
        calls.append(tuple(data.shape[1:]))
        return real(data, *args, **kw)

    from distmlip_tpu_torch.parallel import halo

    monkeypatch.setattr(mace_module, "fused_segment_sum", counted)
    monkeypatch.setattr(halo, "fused_segment_sum", counted)
    cart, lat, spec = _structure((2, 2, 6) if P > 1 else (2, 2, 2))
    pot = DistPotential(MACE(MACEConfig(**CFG)), params_from_numpy(params), device="cpu",
                        num_partitions=P)
    pot.calculate(Atoms(numbers=spec, positions=cart, cell=lat))
    assert calls.count((1,)) == P
    # MACE's own edge chunks carry (Q, C) rows
    assert all(c == (1,) or len(c) == 2 for c in calls)
