"""The SO(2) convolution (B3) of the port against the JAX package's.

The port's ``fused_so2_conv`` on the CPU runs ``so2_conv_reference`` (the
plain version of ``csrc/so2_conv.cu``) through its autograd Function; the
JAX package's ``fused_so2_conv`` runs its plain XLA version
(``kernels=False``) or the Pallas kernel in interpret mode
(``kernels="interpret"``, as ``tests/test_kernels.py`` runs it). Inputs
are made with numpy from a seed (``tests/test_torch_cuda.so2_inputs``,
shared with the card-only cases) and fed to both.

Tolerances: float32 on both sides, the same products summed in different
orders: values and gradients within 1e-5 relative to their scale
(``rtol=1e-5, atol=1e-5``, unit-scale inputs and 1/sqrt(d) weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distmlip_tpu.kernels import dispatch as jax_dispatch
from distmlip_tpu.kernels.so3 import packed_m_layout as jax_packed_m_layout
from distmlip_tpu_torch import kernels as K
from distmlip_tpu_torch.kernels import dispatch
from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout
from tests.test_torch_cuda import so2_inputs
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("l_max", range(7))
def test_packed_m_layout_equals_the_jax_package(l_max):
    lay = CoeffLayout(l_max)
    m_idx = {m: (lay.plus_idx[m], lay.minus_idx[m]) for m in range(l_max + 1)}
    perm, inv, segments = K.packed_m_layout(m_idx)
    jperm, jinv, jsegments = jax_packed_m_layout(m_idx)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    assert segments == jsegments
    assert perm.dtype == inv.dtype == np.int32


def _jax_value_and_grads(h, weights, m_idx, c, kernels):
    def loss(h_, ws_):
        out = jax_dispatch.fused_so2_conv(h_, list(ws_), m_idx, c, kernels=kernels)
        return jnp.sum(out ** 2), out

    (_, out), (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), tuple(jnp.asarray(w) for w in weights))
    return np.asarray(out), np.asarray(gh), [np.asarray(g) for g in gw]


@pytest.mark.parametrize("kernels", [False, "interpret"], ids=["xla", "interpret"])
@pytest.mark.parametrize("seed,e,l_max,c", [(0, 37, 2, 16), (1, 300, 4, 8),
                                            (2, 5, 4, 16)])
def test_fused_so2_conv_matches_jax(seed, e, l_max, c, kernels):
    """Values and the h and weight gradients of sum(out^2)."""
    h, weights, m_idx = so2_inputs(seed, e, l_max, c)
    want, want_gh, want_gw = _jax_value_and_grads(h, weights, m_idx, c, kernels)
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    out = K.fused_so2_conv(ht, wt, m_idx, c)
    gh, *gw = torch.autograd.grad((out ** 2).sum(), [ht] + wt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), want_gh, rtol=1e-5, atol=1e-5)
    assert len(gw) == len(want_gw) == 2 * l_max + 1
    for g, w in zip(gw, want_gw):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4)


def test_fused_so2_conv_gradcheck_float64():
    """The autograd Function's backward (the plain VJP) and its double
    backward, in float64."""
    h, weights, m_idx = so2_inputs(3, 6, 2, 3)
    ht = torch.from_numpy(h).double().requires_grad_(True)
    wt = [torch.from_numpy(w).double().requires_grad_(True) for w in weights]

    def f(h_, *ws):
        return K.fused_so2_conv(h_, list(ws), m_idx, 3)

    assert torch.autograd.gradcheck(f, (ht, *wt))
    assert torch.autograd.gradgradcheck(f, (ht, *wt))


def test_force_backward_asks_for_no_weight_cotangent(monkeypatch):
    """The force program's weights need no gradient: the backward is told
    so (``ctx.needs_input_grad``) and computes none, nor gathers the input
    rows it would need for one. Weights that need one get theirs."""
    seen = []
    real = dispatch._so2_vjp

    def spy(h, weights, g, perm, inv, segments, channels, need_h, need_w):
        seen.append((need_h, tuple(need_w)))
        return real(h, weights, g, perm, inv, segments, channels, need_h, need_w)

    monkeypatch.setattr(dispatch, "_so2_vjp", spy)
    h, weights, m_idx = so2_inputs(4, 21, 2, 8)
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = [torch.from_numpy(w) for w in weights]
    (gh,) = torch.autograd.grad(K.fused_so2_conv(ht, wt, m_idx, 8).sum(), ht)
    assert seen == [(True, (False,) * 5)]
    gh2, gws = real(ht.detach(), wt, torch.ones_like(ht), *_layout(m_idx), 8, True,
                    [False] * 5)
    assert gws == [None] * 5
    torch.testing.assert_close(gh, gh2)
    wt[2].requires_grad_(True)
    torch.autograd.grad(K.fused_so2_conv(ht, wt, m_idx, 8).sum(), [ht, wt[2]])
    assert seen[-1] == (True, (False, False, True, False, False))


def _layout(m_idx):
    perm, inv, segments = K.packed_m_layout(m_idx)
    return (torch.as_tensor(perm, dtype=torch.long), torch.as_tensor(inv, dtype=torch.long),
            segments)


def test_plain_version_is_within_the_kernel_tolerance_of_exact():
    """The derived tolerance ``so2_conv_error_bound`` (2 k u sum|terms|)
    covers the float32 plain version against the exact (float64) result
    with room: each side alone is within half of it."""
    h, weights, m_idx = so2_inputs(5, 400, 4, 16)
    perm, _, segments = K.packed_m_layout(m_idx)
    hp = torch.from_numpy(h)[:, torch.as_tensor(perm, dtype=torch.long)].contiguous()
    ws = [torch.from_numpy(w) for w in weights]
    got = K.so2_conv_reference(hp, ws, segments, 16)
    exact = K.so2_conv_reference(hp.double(), [w.double() for w in ws], segments, 16)
    bound = K.so2_conv_error_bound(hp, ws, segments, 16)
    assert bool(((got.double() - exact).abs() <= bound.double() / 2).all())
    assert float(bound.max()) < 1e-3


def test_cpu_routing_and_the_wrapper_refusing_cpu_tensors():
    """On the CPU the dispatcher runs the plain version whatever
    ``kernels`` says, launching nothing; the kernel's wrapper refuses CPU
    tensors (it never falls back)."""
    h, weights, m_idx = so2_inputs(6, 9, 1, 4)
    ht, wt = torch.from_numpy(h), [torch.from_numpy(w) for w in weights]
    before = K.launch_counts["so2_conv"]
    a = K.fused_so2_conv(ht, wt, m_idx, 4)
    b = K.fused_so2_conv(ht, wt, m_idx, 4, kernels=False)
    assert K.launch_counts["so2_conv"] == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert K.fused_so2_conv(ht[:0], wt, m_idx, 4).shape == (0,) + ht.shape[1:]
    _, _, segments = K.packed_m_layout(m_idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.so2_conv_cuda(ht, wt, segments, 4, np.arange(4))


# ---------------------------------------------------------------------------
# the kernel's route: weight packing, the 3xTF32 split, the backward through
# the same Function on the transposed weight set
# ---------------------------------------------------------------------------

def _jax_input_cotangent(h, weights, m_idx, c, g):
    _, vjp = jax.vjp(lambda h_: jax_dispatch.fused_so2_conv(h_, list(weights), m_idx, c,
                                                            kernels=False), jnp.asarray(h))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("seed,e,l_max,c", [(10, 37, 2, 16), (11, 200, 4, 8),
                                            (12, 9, 3, 7)])
def test_transposed_weight_set_gives_the_jax_input_cotangent(seed, e, l_max, c):
    """The backward's kernel route computes gh as the forward convolution of
    g with (W0^T; Wr^T, -Wi^T per m): held against ``jax.vjp`` of the JAX
    package's ``fused_so2_conv`` on its reference path."""
    h, weights, m_idx = so2_inputs(seed, e, l_max, c)
    g = np.random.default_rng(seed).normal(size=h.shape).astype(np.float32)
    want = _jax_input_cotangent(h, weights, m_idx, c, g)
    _, _, segments = K.packed_m_layout(m_idx)
    wt = dispatch._so2_transposed_weights([torch.from_numpy(w) for w in weights], segments)
    got = K.fused_so2_conv(torch.from_numpy(g), wt, m_idx, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class _KernelStandIn:
    """Stands in for ``so2_conv_cuda`` on the CPU so the kernel route of the
    autograd Function runs here: it checks that the packed operand it is
    handed is the K-major TF32 split of the weights it is handed (so the
    backward's swap of the packed buffers matches its transposed weight
    set), then computes the plain convolution in the inputs' precision."""

    def __init__(self):
        self.calls = 0

    def __call__(self, h, weights, segments, channels, rows, packed=None):
        self.calls += 1
        for (off, w, npad, kpad), b in zip(packed.layout,
                                           K.so2_block_matrices(weights, segments)):
            parts = packed.fwd[:, off:off + npad * kpad].view(2, npad, kpad).double()
            bt = b.detach().t().double()
            assert bool(((parts[0, :w, :w] + parts[1, :w, :w] - bt).abs()
                         <= 2.0 ** -21 * bt.abs() + 1e-30).all())
            assert not bool(parts[:, w:].any()) and not bool(parts[:, :, w:].any())
        rows_t = torch.as_tensor(rows, dtype=torch.long)
        return K.so2_conv_reference(h[:, rows_t], weights, segments,
                                    channels)[:, torch.argsort(rows_t)]


def _kernel_route(h, ws, m_idx, c):
    perm_np, inv_np, segments = K.packed_m_layout(m_idx)
    perm = torch.as_tensor(perm_np, dtype=torch.long)
    inv = torch.as_tensor(inv_np, dtype=torch.long)
    packed = K.pack_so2_weights(ws, segments, c)
    return dispatch._SO2Conv.apply(True, perm_np, perm, inv, segments, c, packed, h, *ws)


def test_kernel_route_backward_gradcheck_float64(monkeypatch):
    """gradcheck and gradgradcheck through the kernel route's backward (the
    Function again, on the transposed set and the swapped packed buffers),
    with the kernel stood in by its plain version in float64."""
    stand_in = _KernelStandIn()
    monkeypatch.setattr(dispatch, "so2_conv_cuda", stand_in)
    h, weights, m_idx = so2_inputs(13, 6, 2, 3)
    ht = torch.from_numpy(h).double().requires_grad_(True)
    wt = [torch.from_numpy(w).double().requires_grad_(True) for w in weights]

    def f(h_, *ws):
        return _kernel_route(h_, list(ws), m_idx, 3)

    assert torch.autograd.gradcheck(f, (ht, *wt))
    assert torch.autograd.gradgradcheck(f, (ht, *wt))
    calls = stand_in.calls
    (gh,) = torch.autograd.grad(f(ht, *wt).sum(), ht)
    assert stand_in.calls == calls + 2  # forward, then the input cotangent


def test_kernel_route_weight_cotangents_match_the_plain_route(monkeypatch):
    """Weights that require grad get the plain VJP's products on the kernel
    route too; h's cotangent comes from the Function on the transposed set
    and the plain VJP computes none."""
    stand_in = _KernelStandIn()
    monkeypatch.setattr(dispatch, "so2_conv_cuda", stand_in)
    seen = []
    real = dispatch._so2_vjp

    def spy(h, weights, g, perm, inv, segments, channels, need_h, need_w):
        seen.append((need_h, tuple(need_w)))
        return real(h, weights, g, perm, inv, segments, channels, need_h, need_w)

    monkeypatch.setattr(dispatch, "_so2_vjp", spy)
    h, weights, m_idx = so2_inputs(14, 50, 3, 8)
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    got = torch.autograd.grad((_kernel_route(ht, wt, m_idx, 8) ** 2).sum(), [ht] + wt)
    assert seen == [(False, (True,) * 7)]
    want = torch.autograd.grad((K.fused_so2_conv(ht, wt, m_idx, 8) ** 2).sum(), [ht] + wt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the force program's backward: no weight cotangent, no plain VJP at all
    seen.clear()
    wn = [w.detach() for w in wt]
    torch.autograd.grad(_kernel_route(ht, wn, m_idx, 8).sum(), ht)
    assert seen == []


def test_tf32_round_is_round_to_nearest_ties_away_at_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -11 - 2 ** -23, -0.0, 65504.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -9,
                         1.0, -0.0, 65504.0])
    torch.testing.assert_close(K.tf32_round(x), want, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32))
    hi = K.tf32_round(r)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((r - hi).abs() <= 2.0 ** -11 * r.abs()).all())


def test_pack_so2_weights_layout():
    """fwd holds each segment's block B^T and bwd holds B, both split into
    TF32 hi + lo within 2^-22 |B| (the hi parts, then the lo parts),
    zero-padded to 128-row, 32-column tiles; ``transposed`` swaps them."""
    h, weights, m_idx = so2_inputs(15, 3, 3, 7)
    _, _, segments = K.packed_m_layout(m_idx)
    ws = [torch.from_numpy(w) for w in weights]
    packed = K.pack_so2_weights(ws, segments, 7)
    blocks = K.so2_block_matrices(ws, segments)
    assert len(packed.layout) == len(segments) == len(blocks)
    for (off, w, npad, kpad), b in zip(packed.layout, blocks):
        assert b.shape == (w, w) and npad % 128 == 0 and kpad % 32 == 0
        assert npad >= w and kpad >= w and off % 4096 == 0
        for buf, want in ((packed.fwd, b.t()), (packed.bwd, b)):
            parts = buf[:, off:off + npad * kpad].view(2, npad, kpad)
            hi, lo = parts[0, :w, :w], parts[1, :w, :w]
            torch.testing.assert_close(hi, K.tf32_round(want), rtol=0, atol=0)
            torch.testing.assert_close(lo, K.tf32_round(want - hi), rtol=0, atol=0)
            err = (hi.double() + lo.double() - want.double()).abs()
            assert bool((err <= 2.0 ** -22 * want.double().abs()).all())
            assert not bool(parts[:, w:].any()) and not bool(parts[:, :, w:].any())
    swapped = packed.transposed()
    assert swapped.fwd is packed.bwd and swapped.bwd is packed.fwd
    assert K.pack_so2_weights(ws, segments, 7, backward=False).bwd is None
    assert K.so2_packed_weights(ws, m_idx, 7) is None  # CPU weights: the plain path


def _emulate_3xtf32(hp, packed, segments, c, dtype, split=True):
    """The kernel's arithmetic on the CPU from the packed buffer: the edge
    rows split into TF32 hi and lo, a_hi b_hi + a_hi b_lo + a_lo b_hi per
    segment, summed in ``dtype`` (``split=False``: a_hi b_hi alone, plain
    TF32)."""
    e = hp.shape[0]
    a_hi = K.tf32_round(hp)
    a_lo = K.tf32_round(hp - a_hi)
    out = []
    for (off, w, npad, kpad), (m, start, nl) in zip(packed.layout, segments):
        rows = nl * (1 if m == 0 else 2)
        parts = packed.fwd[:, off:off + npad * kpad].view(2, npad, kpad)
        b_hi, b_lo = parts[0, :w, :w].t().to(dtype), parts[1, :w, :w].t().to(dtype)
        ah = a_hi[:, start:start + rows].reshape(e, w).to(dtype)
        al = a_lo[:, start:start + rows].reshape(e, w).to(dtype)
        y = ah @ b_hi + ah @ b_lo + al @ b_hi if split else ah @ b_hi
        out.append(y.reshape(e, rows, c))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("seed,e,l_max,c", [(16, 300, 4, 16), (17, 64, 6, 8),
                                            (18, 100, 2, 7)])
def test_3xtf32_emulation_is_within_the_derived_bound(seed, e, l_max, c):
    """The CPU's proof of the split term: the kernel's 3xTF32 arithmetic,
    emulated from the packed buffer, against the float64 product. With the
    three products summed exactly (float64) it stays within the split term
    13 u T; summed in float32 it stays within ``so2_conv_error_bound``."""
    h, weights, m_idx = so2_inputs(seed, e, l_max, c)
    perm, _, segments = K.packed_m_layout(m_idx)
    hp = torch.from_numpy(h)[:, torch.as_tensor(perm, dtype=torch.long)].contiguous()
    ws = [torch.from_numpy(w) for w in weights]
    packed = K.pack_so2_weights(ws, segments, c, backward=False)
    exact = K.so2_conv_reference(hp.double(), [w.double() for w in ws], segments, c)
    # T, the sum of |terms| of each output: |rows| @ |block| per segment
    t_abs = torch.cat([
        (hp[:, start:start + w // c].abs().reshape(e, w).double() @ b.abs().double()
         ).reshape(e, w // c, c)
        for (_, w, _, _), (_, start, _), b in zip(packed.layout, segments,
                                                  K.so2_block_matrices(ws, segments))], 1)
    split = _emulate_3xtf32(hp, packed, segments, c, torch.float64)
    assert bool(((split - exact).abs() <= 13 * 2.0 ** -24 * t_abs).all())
    # plain TF32 (one product) would break the term: the check can fail
    one = _emulate_3xtf32(hp, packed, segments, c, torch.float64, split=False)
    assert not bool(((one - exact).abs() <= 13 * 2.0 ** -24 * t_abs).all())
    got = _emulate_3xtf32(hp, packed, segments, c, torch.float32)
    bound = K.so2_conv_error_bound(hp, ws, segments, c)
    assert bool(((got.double() - exact).abs() <= bound.double()).all())
    plain = K.so2_conv_reference(hp, ws, segments, c)
    assert bool(((got - plain).abs() <= bound).all())
