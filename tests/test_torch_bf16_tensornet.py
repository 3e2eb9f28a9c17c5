"""bfloat16 compute for TensorNet, port against the JAX package on the CPU.

The numerical contract is the JAX package's (``distmlip_tpu/models/
tensornet.py:132-202``, ``distmlip_tpu/kernels/dispatch.py:288-303,
:528-584``): features, messages and GEMMs in bf16, geometry and the
readout stack in float32, every scatter accumulating in fp32 and rounding
once, half-precision gathers through an fp32 view whose transposes (the
node-row cotangents) accumulate in fp32 and round once.

- (a) The plain bf16 embed and interaction (``fused_edge_aggregate`` on the
  CPU) against the JAX ``pallas_edge_aggregate(..., interpret=True)`` on
  the same bf16 inputs, on ``tests/test_torch_edge_aggregate.py``'s cases.
  Both build the message in bf16 ops (up to r = 5 roundings an entry for
  the embed, 3 for the interaction; XLA may keep some in fp32), sum it in
  fp32 and round once: |d| <= e + 2^-7 (|ref| + e), e = 2 r 2^-8 T + 1e-6,
  T the sum of |terms| (float64), one bf16 ulp over both sides' message
  roundings.
- (b) The chunked backward's node cotangents (and the plain version of the
  backward kernel, ``tensornet_interaction_backward_reference``) against
  the JAX dispatcher's custom VJP (``kernels="interpret"``) in bf16, within
  the same form with r = 8 (the port rounds a term twice, the JAX package
  once per dense entry plus the three dense partials it rounds). A case
  with 2000 same-sign edges on one src row, where a bf16 accumulator would
  stall, shows the fp32 carry: the port within 4 2^-8 of the float64 sum,
  a bf16 scatter-add visibly off it.
- (c) ``DistPotential(compute_dtype="bfloat16")``, port against JAX, at
  ``tests/test_calculators.py:563-565``'s TensorNet widths on a 64-atom
  ``make_crystal`` at P = 1 and P = 2, with ``tests/test_torch_bf16.py``'s
  bars (|dE|/atom <= 1e-3 eV, max |dF|, |dS| <= 0.05 of the largest, or
  twice JAX's own P = 1 vs P = 2 gap) and its shared results fixture.
- (d) The port's bf16 against its own float32 within the JAX test's bar:
  1e-2 eV/atom and dF_rel < 0.15 (``tests/test_calculators.py:580-582``).
- (e) A double backward (``create_graph``) through the bf16 interaction:
  finite, and within the bf16 bar of the float32 double backward on the
  same (bf16-representable) inputs.
- MD with the device refresh (``device_rebuild="auto"``) at bf16: 5
  ``nvt_langevin`` steps that follow the float32 trajectory's energies.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distmlip_tpu.kernels import Gather as JGather
from distmlip_tpu.kernels import fused_edge_aggregate as jax_fused_edge_aggregate
from distmlip_tpu.kernels import pallas_edge_aggregate
from distmlip_tpu_torch import models
from distmlip_tpu_torch.kernels import edge_aggregate
from distmlip_tpu_torch.kernels import (TENSORNET_EMBED, TENSORNET_INTERACTION, Gather,
                                        fused_edge_aggregate,
                                        tensornet_embed_aggregate_reference,
                                        tensornet_interaction_aggregate_reference,
                                        tensornet_interaction_backward_reference)
from tests.test_torch_bf16 import (FAMILIES, SPECIES_MAP, _small_structures,  # noqa: F401
                                   check_against_float32, check_matches_jax, results)
from tests.test_torch_cuda import EDGE_AGG_CASES, embed_inputs, interaction_inputs, sorted_case
from tests.test_torch_edge_aggregate import (N_NODE, _compact_cotangents, _expand,
                                             _jax_embed_msg, _jax_interaction_msg)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

U = 2.0 ** -8  # one bf16 rounding


def _bf16(x):
    """float32 numpy values rounded to bf16 once: the inputs of both sides."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _bar(y, t, r):
    """e + 2^-7 (|y| + e), e = r 2^-8 t + 1e-6: ``r`` bf16 roundings of the
    |terms| ``t`` between the two sides, then one rounding of each."""
    e = r * U * np.asarray(t, np.float64) + 1e-6
    return e + 2 * U * (np.abs(np.asarray(y, np.float64)) + e)


def _case(name, which):
    seed, e, n, pad, im, hi, c = EDGE_AGG_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    if which == "embed":
        arrays = [_bf16(x) for x in embed_inputs(seed, len(ids), c)]
    else:
        *rows, src = interaction_inputs(seed, len(ids), N_NODE, c)
        arrays = [_bf16(x) for x in rows] + [torch.from_numpy(src)]
    return arrays, torch.from_numpy(ids), torch.from_numpy(mask), n, c


# ---- (a) the plain bf16 aggregations against the interpret-mode kernel ------

@pytest.mark.parametrize("which", ["embed", "interaction"])
@pytest.mark.parametrize("name", ["repeated_tail_padding", "empty_rows",
                                  "e_not_multiple_of_block", "channels_not_multiple_of_4"])
def test_plain_bf16_matches_jax_pallas(name, which):
    arrays, ti, tm, n, c = _case(name, which)
    if which == "embed":
        eye = jnp.eye(3, dtype=jnp.bfloat16)[:, :, None]
        fn, items, consts = _jax_embed_msg, [_jnp(x) for x in arrays], (eye,)
        inputs, reference, r = list(arrays), tensornet_embed_aggregate_reference, 5
        message = TENSORNET_EMBED
    else:
        f, node_i, node_a, node_s, src = arrays
        js = jnp.asarray(src.numpy())
        full = _expand(*(x.float().numpy() for x in (node_i, node_a, node_s)))
        fn, consts = _jax_interaction_msg, ()
        items = [_jnp(f)] + [("gather", jnp.asarray(x, jnp.bfloat16), js) for x in full]
        inputs = [f, Gather(node_i, src), Gather(node_a, src), Gather(node_s, src)]
        reference, r, message = tensornet_interaction_aggregate_reference, 3, TENSORNET_INTERACTION
    want = pallas_edge_aggregate(fn, items, jnp.asarray(ti.numpy()), n,
                                 jnp.asarray(tm.numpy()), out_shape=(3, 3, c),
                                 out_dtype=jnp.bfloat16, consts=consts, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = fused_edge_aggregate(message, inputs, ti, n, tm)
    assert got.dtype == torch.bfloat16 and got.shape == (n, 3, 3, c)
    assert torch.equal(got, reference(*arrays, ti, n, tm))
    t = reference(*[x.double().abs() if x.is_floating_point() else x for x in arrays],
                  ti, n, tm).numpy()
    if which == "interaction":  # the lower triangle's terms, summed as the upper's
        t = np.maximum(t, t.transpose(0, 2, 1, 3))
    want = np.asarray(want, np.float32)
    d = np.abs(got.float().numpy() - want)
    assert (d <= _bar(want, t, 2 * r)).all(), float(d.max())


# ---- (b) the chunked backward's node cotangents against the JAX VJP ---------

def _one_row_case():
    """2000 valid edges, all but 48 from src row 0, every term of row 0's
    cotangent the same sign (f and g positive), 8 channels."""
    rng = np.random.default_rng(11)
    e, n, c = 2048, 40, 8
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    mask = np.ones(e, bool)
    mask[-48:] = False
    ids[-48:] = ids[-49]
    src = np.zeros(e, np.int32)
    src[rng.choice(e, 48, replace=False)] = rng.integers(1, N_NODE, 48)
    f = np.abs(rng.normal(size=(e, c, 3))).astype(np.float32) + 0.5
    nodes = [rng.normal(size=(N_NODE,) + k + (c,)).astype(np.float32)
             for k in ((), (3,), (6,))]
    g = np.abs(rng.normal(size=(n, 3, 3, c))).astype(np.float32) + 0.5
    return ([_bf16(f)] + [_bf16(x) for x in nodes] + [torch.from_numpy(src)],
            torch.from_numpy(ids), torch.from_numpy(mask), n, _bf16(g))


def _jax_node_cotangents(arrays, ti, tm, n, g):
    """The JAX dispatcher's bf16 VJP (custom VJP of the interpret-mode
    kernel, 64-edge chunks) on the expanded rows, the dense cotangents
    brought to compact ones in float32 (``_compact_cotangents``)."""
    f, node_i, node_a, node_s, src = arrays
    js = jnp.asarray(src.numpy())
    full = _expand(*(x.float().numpy() for x in (node_i, node_a, node_s)))

    def agg(f_, i_, a_, s_):
        return jax_fused_edge_aggregate(
            _jax_interaction_msg, [f_, JGather(i_, js), JGather(a_, js), JGather(s_, js)],
            jnp.asarray(ti.numpy()), n, jnp.asarray(tm.numpy()), kernels="interpret",
            bwd_chunk=64)

    _, vjp = jax.vjp(agg, _jnp(f), *(jnp.asarray(x, jnp.bfloat16) for x in full))
    d_f, *dense = vjp(_jnp(g))
    assert d_f.dtype == jnp.bfloat16
    return [np.asarray(d_f, np.float32)] + list(
        _compact_cotangents(*(np.asarray(x, np.float32) for x in dense)))


def _abs_terms(g, x64, ti, tm):
    """The backward's sums of |terms| in float64: every difference of g's
    projections a sum (``tensornet_interaction_backward_error_bound``'s T)."""
    f, node_i, node_a, node_s, src = [x.abs() if x.is_floating_point() else x for x in x64]
    t, u, v = edge_aggregate._projections(edge_aggregate._g_rows(g.double().abs(), ti, tm), 1.0)
    d_f, ci, ca, cs = edge_aggregate._backward_terms(
        f, node_i.index_select(0, src), node_a.index_select(0, src),
        node_s.index_select(0, src), t, u, v)
    return [d_f] + [edge_aggregate._src_sum(x, src, ct)
                    for x, ct in ((node_i, ci), (node_a, ca), (node_s, cs))]


@pytest.mark.parametrize("name", ["repeated_tail_padding", "one_src_row"])
def test_chunked_backward_node_cotangents_match_jax(name):
    if name == "one_src_row":
        arrays, ti, tm, n, g = _one_row_case()
    else:
        arrays, ti, tm, n, c = _case(name, "interaction")
        g = _bf16(np.random.default_rng(6).normal(size=(n, 3, 3, c)).astype(np.float32))
    src = arrays[4]
    leaves = [x.clone().requires_grad_(True) for x in arrays[:4]]
    out = fused_edge_aggregate(TENSORNET_INTERACTION, [leaves[0]] + [
        Gather(x, src) for x in leaves[1:]], ti, n, tm, bwd_chunk=64)
    got = torch.autograd.grad(out, leaves, g)
    assert all(x.dtype == torch.bfloat16 for x in got)
    plain = tensornet_interaction_backward_reference(g, *arrays, ti, tm)
    jref = _jax_node_cotangents(arrays, ti, tm, n, g)
    x64 = [x.double() if x.is_floating_point() else x for x in arrays]
    exact = tensornet_interaction_backward_reference(g.double(), *x64, ti, tm)
    terms = _abs_terms(g, x64, ti, tm)
    for k, (a, p, j, y, t) in enumerate(zip(got, plain, jref, exact, terms)):
        a, p = a.float().numpy(), p.float().numpy()
        for other in (j, p):
            d = np.abs(a - other)
            assert (d <= _bar(y.numpy(), t.numpy(), 8)).all(), (k, float(d.max()))
    if name == "one_src_row":
        # row 0's d i sums ~1950 same-sign terms: the fp32 carry keeps it
        # within a few bf16 roundings of the float64 sum; a bf16 scatter-add
        # of the same bf16 terms (each add rounded) stalls far from it
        y, a = exact[1][0].numpy(), got[1][0].float().numpy()
        assert (np.abs(a - y) <= 4 * U * np.abs(y)).all()
        t_edge = (arrays[0][:, :, 0] * (g[ti.long(), 0, 0] + g[ti.long(), 1, 1]
                                        + g[ti.long(), 2, 2]))[tm & (src == 0)]
        acc = torch.zeros_like(t_edge[0])
        for row in t_edge:  # bf16 accumulation, one rounding an edge
            acc = acc + row
        assert (np.abs(acc.float().numpy() - y) > 0.1 * np.abs(y)).all()


# ---- (c), (d): the model through DistPotential -------------------------------

@pytest.mark.parametrize("P", [1, 2])
def test_bf16_matches_jax(results, P):  # noqa: F811
    check_matches_jax(results, "tensornet", P)


def test_bf16_against_the_ports_float32(results):  # noqa: F811
    check_against_float32(results, "tensornet", de_bar=1e-2, df_bar=0.15)


# ---- (e) the double backward ----------------------------------------------------

def test_bf16_double_backward_through_the_interaction():
    """create_graph through the bf16 interaction (the chunked recompute with
    the fp32-view gathers, in differentiable ops), then the gradient of the
    gradients' squares: finite, bf16, and within 5% of the largest entry of
    the float32 double backward on the same bf16-representable inputs."""
    arrays, ti, tm, n, c = _case("repeated_tail_padding", "interaction")
    src = arrays[4]

    def second_order(dtype):
        leaves = [x.to(dtype).clone().requires_grad_(True) for x in arrays[:4]]
        out = fused_edge_aggregate(TENSORNET_INTERACTION, [leaves[0]] + [
            Gather(x, src) for x in leaves[1:]], ti, n, tm, bwd_chunk=64)
        grads = torch.autograd.grad(out.float().square().sum(), leaves, create_graph=True)
        assert all(x.dtype == dtype for x in grads)
        return torch.autograd.grad(sum(x.float().square().sum() for x in grads), leaves)

    got, want = second_order(torch.bfloat16), second_order(torch.float32)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        assert scale > 0 and float((a.float() - b).abs().max()) <= 0.05 * scale


# ---- MD with the device refresh --------------------------------------------------

def test_bf16_molecular_dynamics_with_device_refresh():
    """5 ``nvt_langevin`` steps of a bf16 TensorNet with the device refresh
    (``device_rebuild="auto"``) from the float32 run's start and seed:
    finite, the refresh taken, and the energies within 1e-2 eV/atom of the
    float32 trajectory's (the JAX test's bar)."""
    from distmlip_tpu_torch.calculators import DistPotential, MolecularDynamics

    model = models.TensorNet(models.TensorNetConfig(**FAMILIES["tensornet"][1]))
    params = model.init(0)
    energies = {}
    for dtype in ("float32", "bfloat16"):
        atoms = _small_structures("tensornet")[0]
        atoms.set_maxwell_boltzmann_velocities(1500.0, rng=np.random.default_rng(4))
        pot = DistPotential(model, params, device="cpu", species_map=SPECIES_MAP, skin=0.3,
                            device_rebuild="auto", compute_dtype=dtype)
        out = []

        class Record:
            def record(self, results):
                out.append(results["energy"])

        MolecularDynamics(atoms, pot, trajectory=Record(), ensemble="nvt_langevin",
                          timestep=2.0, temperature=1500.0, seed=0).run(5)
        assert np.isfinite(atoms.positions).all() and len(out) >= 5
        assert pot.rebuild_on_device_count >= 1
        energies[dtype] = np.array(out)
    assert (np.abs(energies["bfloat16"] - energies["float32"]) <= 1e-2 * 32).all()
