"""bfloat16 compute for CHGNet, port against the JAX package on the CPU.

The numerical contract is the JAX package's (``distmlip_tpu/models/
chgnet.py:190-310``, ``distmlip_tpu/kernels/segment.py:300-317``,
``distmlip_tpu/kernels/dispatch.py:528-584``): features, messages and
GEMMs in bf16; geometry, the basis frequencies, the readout heads and the
magmoms in float32; every dst sum accumulating in fp32 and rounding once;
the chunked backward's node cotangents through fp32 views.

- (a) The plain bf16 atom conv and line conv (``fused_edge_aggregate`` on
  the CPU) against the JAX ``pallas_edge_aggregate(..., interpret=True)``
  with CHGNet's ``edge_fn`` on the same bf16 inputs and weights, on
  ``tests/test_torch_cuda.py``'s ``chgnet_inputs`` cases. Both build the
  message in bf16 ops (r roundings an entry: the layer-1 dot, its bias,
  silu, the layer-2 dot, its bias, silu or sigmoid, the gate product, and
  the atom conv's abw product: r = 8, 7 for the line conv), sum it in fp32
  and round once: |d| <= e + 2^-7 (|ref| + e), e = 2 r 2^-8 T + 1e-6, T
  the float64 sum of |terms| (``kernels.chgnet_message_terms``, the
  sensitivity-weighted sum each rounding moves the entry by at most 2^-8
  of). Beside it, the kernels' arithmetic stood in by the float32 plain
  version on the same bf16 values, rounded once, within the kernels' own
  tolerance (``chgnet_aggregate_error_bound`` at bf16 data) on every case.
- (b) The chunked backward's cotangents (node rows, per-edge rows) against
  the JAX dispatcher's custom VJP (``kernels="interpret"``, 64-edge chunks)
  in bf16, and against the float64 VJP on the same values: the same form,
  T the float64 VJP of the message's majorant network (|x| and |W|, silu
  and sigmoid by their slope bounds 1.1 and 0.25, sigmoid's value by 1;
  every entry of the VJP is at most it), r = 16 a side: 13 bf16 roundings
  on a term's chain (the recomputed forward's six of a branch, the
  backward's seven: the abw and gate products, the activation slope, the
  layer-2 transpose, silu's slope, the layer-1 transpose, the branches'
  sum) and 3 for the slopes taken at rounded arguments.
- (c) ``DistPotential(compute_dtype="bfloat16")``, port against JAX, at
  ``tests/test_calculators.py:567-569``'s CHGNet widths on a 64-atom
  ``make_crystal`` at P = 1 and P = 2, with ``compute_magmom=True``:
  ``tests/test_torch_bf16.py``'s bars (|dE|/atom <= 1e-3 eV, max |dF|,
  |dS| <= 0.05 of the largest, max |dm| <= 0.05 max |m|, each or twice
  JAX's own P = 1 vs P = 2 gap) and its shared results fixture.
- (d) The port's bf16 against its own float32 within the JAX test's bar:
  1e-2 eV/atom and dF_rel < 0.15 (``tests/test_calculators.py:579-582``).
- (e) 5 FIRE steps with the cell relaxed (``examples/02_relax_chgnet.py``'s
  ``Relaxer``) from the same start: bf16 energies within 1e-2 eV/atom of
  float32's at every step.
- (f) The row projection's plain version on bf16 rows (bf16 packed blocks,
  a float32 table) against the float64 product, within one side's float32
  bound (K + 2) 2^-24 T; the weight packing keeps the blocks bf16 and
  upcasts the rest exactly; the bar of the tensor-core kernel's bf16 form.

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
from distmlip_tpu.ops.nn import gated_mlp as jax_gated_mlp
from distmlip_tpu_torch import models
from distmlip_tpu_torch.kernels import (CHGNET_ATOM_CONV, CHGNET_LINE_CONV, Gather,
                                        chgnet_aggregate_error_bound,
                                        chgnet_atom_conv_aggregate_reference,
                                        chgnet_line_aggregate_reference, chgnet_message_terms,
                                        chgnet_pack_weights, chgnet_projection_error_bound,
                                        chgnet_row_projection_reference, fused_edge_aggregate)
from distmlip_tpu_torch.ops.segment import masked_segment_sum
from distmlip_tpu_torch.tools.workload import CHGNET_BF16_KW, CHGNET_KW
from tests.test_torch_bf16 import (FAMILIES, SPECIES_MAP, _crystal,  # noqa: F401
                                   _jax_params, check_against_float32, check_matches_jax,
                                   results)
from tests.test_torch_cuda import CHGNET_CASES, chgnet_inputs, chgnet_rows, sorted_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401

U = 2.0 ** -8  # one bf16 rounding
R_MESSAGE = {"atom": 8, "line": 7}  # bf16 roundings of a message entry, counted in (a)


def _bf16(x):
    """float32 numpy values rounded to bf16 once: the inputs of both sides."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _bar(y, t, r):
    """e + 2^-7 (|y| + e), e = r 2^-8 t + 1e-6: ``r`` bf16 roundings of the
    sensitivity-weighted |terms| ``t`` between the two sides, then one
    rounding of each."""
    e = r * U * np.asarray(t, np.float64) + 1e-6
    return e + 2 * U * (np.abs(np.asarray(y, np.float64)) + e)


def _case(name, which):
    """A ``chgnet_inputs`` case at bf16: the node (bond) tensor one at both
    gathered ends, as the model passes it; the weights bf16."""
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    t = [_bf16(x) if x.dtype == np.float32 else torch.from_numpy(x) for x in arrays]
    t[2] = t[0]
    return t, [_bf16(w) for w in weights], torch.from_numpy(ids), torch.from_numpy(mask), n


def _inputs(which, t):
    """The dispatcher's inputs in the model's order."""
    if which == "atom":
        node, src, _, dst, edge, abw = t
        return [Gather(node, src), Gather(node, dst), edge, abw]
    bond, ls, _, ld, angle, node, ctr = t
    return [Gather(bond, ls), Gather(bond, ld), angle, Gather(node, ctr)]


def _reference(which):
    return (chgnet_atom_conv_aggregate_reference if which == "atom"
            else chgnet_line_aggregate_reference)


def _gated(ws):
    return {"core": [{"w": ws[0], "b": ws[1]}, {"w": ws[2], "b": ws[3]}],
            "gate": [{"w": ws[4], "b": ws[5]}, {"w": ws[6], "b": ws[7]}]}


def _terms(which, t, tw, ti, n, tm):
    """T per output row (float64): ``chgnet_message_terms`` summed over the
    row's valid edges."""
    x, abw = chgnet_rows(which, [x.double() if x.is_floating_point() else x for x in t])
    return masked_segment_sum(chgnet_message_terms(x, abw, [w.double() for w in tw]),
                              ti, n, tm).numpy()


# ---- (a) the plain bf16 aggregations against the interpret-mode kernel ------

@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", ["repeated_tail_padding", "empty_rows", "channels_7",
                                  "matgl_widths"])
def test_plain_bf16_matches_jax_pallas(name, which):
    t, tw, ti, tm, n = _case(name, which)
    c = t[4].shape[1]
    n_in = 4

    def fn(*blocks):  # the model's edge_fn (chgnet.py:333-339, :356-365), weights hoisted
        rows, ws = blocks[:n_in], blocks[n_in:]
        m = jax_gated_mlp(_gated(ws), jnp.concatenate(
            rows[:3] if which == "atom" else rows, axis=-1))
        return m * rows[3] if which == "atom" else m

    if which == "atom":
        node, src, _, dst, edge, abw = t
        items = [("gather", _jnp(node), jnp.asarray(src.numpy())),
                 ("gather", _jnp(node), jnp.asarray(dst.numpy())), _jnp(edge), _jnp(abw)]
    else:
        bond, ls, _, ld, angle, node, ctr = t
        items = [("gather", _jnp(bond), jnp.asarray(ls.numpy())),
                 ("gather", _jnp(bond), jnp.asarray(ld.numpy())), _jnp(angle),
                 ("gather", _jnp(node), jnp.asarray(ctr.numpy()))]
    want = pallas_edge_aggregate(fn, items, jnp.asarray(ti.numpy()), n,
                                 jnp.asarray(tm.numpy()), out_shape=(c,),
                                 out_dtype=jnp.bfloat16, consts=tuple(_jnp(w) for w in tw),
                                 interpret=True)
    assert want.dtype == jnp.bfloat16
    message = CHGNET_ATOM_CONV if which == "atom" else CHGNET_LINE_CONV
    got = fused_edge_aggregate(message, _inputs(which, t), ti, n, tm, weights=tw)
    assert got.dtype == torch.bfloat16 and got.shape == (n, c)
    assert torch.equal(got, _reference(which)(*t, tw, ti, n, tm))
    want = np.asarray(want, np.float32)
    d = np.abs(got.float().numpy() - want)
    bar = _bar(want, _terms(which, t, tw, ti, n, tm), 2 * R_MESSAGE[which])
    assert (d <= bar).all(), float((d / bar).max())


@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_CASES))
def test_kernel_arithmetic_within_the_bf16_bound(name, which):
    """The bf16 kernels compute in float32 on the same bf16 values and round
    each output once: that stand-in (the float32 plain version, rounded)
    lies within ``chgnet_aggregate_error_bound``'s bf16 form of the plain
    bf16 version, with and without abw, and an all-masked input is zeros
    on both."""
    t, tw, ti, tm, n = _case(name, which)
    ref = _reference(which)
    variants = [t] + ([t[:5] + [None]] if which == "atom" else [])
    for tv in variants:
        want = ref(*tv, tw, ti, n, tm)
        f32 = [x.float() if x is not None and x.is_floating_point() else x for x in tv]
        stand_in = ref(*f32, [w.float() for w in tw], ti, n, tm).bfloat16()
        x, abw = chgnet_rows(which, tv)
        bound = chgnet_aggregate_error_bound(x, abw, tw, ti, n, tm)
        assert bound.dtype == torch.float32 and want.dtype == torch.bfloat16
        err = (stand_in.float() - want.float()).abs()
        assert bool((err <= bound).all()), float((err / bound).max())
        assert float(err.max()) > 0.0  # the two routes do round differently
    none = torch.zeros_like(tm)
    assert not ref(*t, tw, ti, n, none).any()
    assert not chgnet_aggregate_error_bound(*chgnet_rows(which, t), tw, ti, n, none).any()


# ---- (b) the chunked backward against the JAX VJP and float64 ----------------

def _majorant_vjp(which, t, tw, ti, n, tm, g):
    """T of (b): the float64 VJP, at |g|, of the message's majorant network
    on |inputs| and |weights| (layer sums with silu and sigmoid as their
    slope bounds 1.1 and 0.25, sigmoid's value as 1), with respect to the
    differentiable inputs (node or bond rows, per-edge rows, node rows)."""
    a = [x.double().abs().requires_grad_(True) if x.is_floating_point() else x for x in t]
    a[2] = a[0]
    w1c, b1c, w2c, b2c, w1g, b1g, w2g, b2g = (w.double().abs() for w in tw)
    x, abw = chgnet_rows(which, a)

    def t2(w1, b1, w2, b2):
        return (1.1 * (x @ w1 + b1)) @ w2 + b2

    m = 1.1 * t2(w1c, b1c, w2c, b2c) * (0.25 * t2(w1g, b1g, w2g, b2g) + 1.0)
    if abw is not None:
        m = m * abw
    out = masked_segment_sum(m, ti, n, tm)
    leaves = _leaves(a)
    return torch.autograd.grad((out * g.double().abs()).sum(), leaves)


def _leaves(t):
    """The differentiable inputs: atom conv (node, edge, abw); line conv
    (bond, angle, node)."""
    return [t[0], t[4], t[5]]


def _jax_vjp(which, t, tw, ti, n, tm, g):
    p = _gated([_jnp(w) for w in tw])
    xs = [_jnp(x) for x in _leaves(t)]
    if which == "atom":
        src, dst = (jnp.asarray(t[i].numpy()) for i in (1, 3))

        def agg(node, edge, abw):
            def fn(vs, vd, e_, w_):
                return jax_gated_mlp(p, jnp.concatenate([vs, vd, e_], axis=-1)) * w_

            return jax_fused_edge_aggregate(fn, [JGather(node, src), JGather(node, dst), edge,
                                                 abw], jnp.asarray(ti.numpy()), n,
                                            jnp.asarray(tm.numpy()), kernels="interpret",
                                            bwd_chunk=64)
    else:
        ls, ld, ctr = (jnp.asarray(t[i].numpy()) for i in (1, 3, 6))

        def agg(bond, angle, node):
            def fn(bs, bd, a_, vc):
                return jax_gated_mlp(p, jnp.concatenate([bs, bd, a_, vc], axis=-1))

            return jax_fused_edge_aggregate(fn, [JGather(bond, ls), JGather(bond, ld), angle,
                                                 JGather(node, ctr)],
                                            jnp.asarray(ti.numpy()), n,
                                            jnp.asarray(tm.numpy()), kernels="interpret",
                                            bwd_chunk=64)

    _, vjp = jax.vjp(agg, *xs)
    cts = vjp(_jnp(g))
    assert all(x.dtype == jnp.bfloat16 for x in cts)
    return [np.asarray(x, np.float32) for x in cts]


def _port_vjp(which, t, tw, ti, n, tm, g):
    a = list(t)
    leaves = [x.clone().requires_grad_(True) for x in _leaves(t)]
    a[0], a[4], a[5] = leaves
    a[2] = a[0]
    message = CHGNET_ATOM_CONV if which == "atom" else CHGNET_LINE_CONV
    out = fused_edge_aggregate(message, _inputs(which, a), ti, n, tm, weights=tuple(tw),
                               bwd_chunk=64)
    return torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("which", ["atom", "line"])
def test_chunked_backward_matches_jax_and_float64(which):
    t, tw, ti, tm, n = _case("repeated_tail_padding", which)
    c = t[4].shape[1]
    g = _bf16(np.random.default_rng(6).normal(size=(n, c)).astype(np.float32))
    got = _port_vjp(which, t, tw, ti, n, tm, g)
    assert all(x.dtype == torch.bfloat16 for x in got)
    jref = _jax_vjp(which, t, tw, ti, n, tm, g)
    t64 = [x.double() if x.is_floating_point() else x for x in t]
    exact = _port_vjp(which, t64, [w.double() for w in tw], ti, n, tm, g.double())
    terms = _majorant_vjp(which, t, tw, ti, n, tm, g)
    for k, (a, j, y, tt) in enumerate(zip(got, jref, exact, terms)):
        a, y, tt = a.float().numpy(), y.numpy(), tt.numpy()
        assert (np.abs(y) <= tt * (1 + 1e-9) + 1e-12).all(), k  # T majorises the VJP
        for other, r in ((j, 2 * 16), (y, 16)):
            d = np.abs(a - other)
            bar = _bar(y, tt, r)
            assert (d <= bar).all(), (k, float((d / bar).max()))


# ---- (c), (d): the model through DistPotential -------------------------------

@pytest.mark.parametrize("P", [1, 2])
def test_bf16_matches_jax(results, P):  # noqa: F811
    check_matches_jax(results, "chgnet", P)


def test_bf16_against_the_ports_float32(results):  # noqa: F811
    check_against_float32(results, "chgnet", de_bar=1e-2, df_bar=0.15)
    m16 = results("chgnet", "port", "bfloat16", 1)["magmoms"]
    m32 = results("chgnet", "port", "float32", 1)["magmoms"]
    assert m16.dtype == np.float32 and 0 < np.abs(m16 - m32).max() < 0.15 * np.abs(m32).max()


# ---- (e) a cell relaxation --------------------------------------------------------

def test_bf16_fire_with_the_cell_follows_float32():
    """5 FIRE steps with the cell relaxed (tolerances no step meets), bf16
    and float32 from the same start (the cell stretched 2%, the shared
    parameters): finite, the cell moved, and the bf16 energy within 1e-2
    eV/atom of float32's at every step."""
    from distmlip_tpu_torch.calculators import Atoms, DistPotential, Relaxer

    model = models.CHGNet(models.CHGNetConfig(**FAMILIES["chgnet"][1]))
    params = _jax_params("chgnet")
    cart, lat, numbers = _crystal("chgnet")
    energies = {}
    for dtype in ("float32", "bfloat16"):
        pot = DistPotential(model, params, device="cpu", species_map=SPECIES_MAP, skin=0.5,
                            compute_dtype=dtype, compute_magmom=True)
        atoms = Atoms(numbers=numbers, positions=cart.copy(), cell=lat * 1.02)
        out = Relaxer(pot, optimizer="fire", relax_cell=True, fmax=1e-4,
                      smax=1e-5).relax(atoms, steps=5, record=True)
        assert np.isfinite(out.atoms.positions).all() and len(out.trajectory) == 5
        assert not np.array_equal(out.atoms.cell, atoms.cell)
        energies[dtype] = np.array([s["energy"] for s in out.trajectory])
    assert (np.abs(energies["bfloat16"] - energies["float32"]) <= 1e-2 * len(cart)).all()


# ---- (f) the row projection on bf16 rows -------------------------------------------

def test_row_projection_plain_bf16_against_float64():
    rng = np.random.default_rng(12)
    c, h, rows = 16, 12, 300
    _, weights = chgnet_inputs(12, "atom", 4, c, h)
    wb = [_bf16(w) for w in weights]
    packed = chgnet_pack_weights(wb, 3, 2, c)
    for got, want, dtype in ((packed.blocks[0][:, :h], wb[0][:c], torch.bfloat16),
                             (packed.w2[:c, :h].t(), wb[2], torch.bfloat16),
                             (packed.b1[:h], wb[1], torch.float32)):
        assert got.dtype == dtype and torch.equal(got.float(), want.float())
    x = _bf16(rng.normal(size=(rows, c)).astype(np.float32))
    w = torch.cat(packed.blocks, -1)
    for bias in (None, torch.nn.functional.pad(packed.b1, (0, packed.b1.shape[0]))):
        y = chgnet_row_projection_reference(x, w, bias)
        assert y.dtype == torch.float32 and y.shape == (rows, w.shape[1])
        exact = x.double() @ w.double() + (0.0 if bias is None else bias.double())
        t = x.double().abs() @ w.double().abs() + (0.0 if bias is None else bias.double().abs())
        assert bool(((y.double() - exact).abs() <= (c + 2) * 2.0 ** -24 * t).all())
        # the kernel's side takes its products on the tensor cores: its own bar
        torch.testing.assert_close(chgnet_projection_error_bound(x, w, bias),
                                   chgnet_projection_error_bound(x.float(), w.float(), bias)
                                   * (36 + c + 2) / (2 * (c + 2)), rtol=1e-6, atol=0)


def test_workload_chgnet_bf16_configuration():
    """The MPtrj layout at the reference's own compute-dtype switch."""
    assert CHGNET_BF16_KW == dict(CHGNET_KW, dtype="bfloat16")
    assert models.CHGNet(models.CHGNetConfig(**CHGNET_BF16_KW)).cfg.dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        models.CHGNet(models.CHGNetConfig(dtype="float16"))
