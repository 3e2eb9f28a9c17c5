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
