"""The port's segment sum against the JAX package's.

Same inputs (numpy, fixed seed) go through the JAX Pallas kernel in
interpret mode (``pallas_segment_sum(..., interpret=True)``), the JAX plain
``masked_segment_sum``, and the port's ``fused_segment_sum`` /
``segment_sum_reference`` on the CPU (where the dispatcher takes the plain
version because the tensors lie on the CPU). The CUDA kernel itself runs
only on a card: ``tests/test_torch_cuda.py`` holds it against the plain
version there (and skips elsewhere) on the same cases.

Tolerance: float32 sums of a few dozen O(1) terms, accumulated in another
order on each side — 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distmlip_tpu.kernels import fused_segment_sum as jax_fused_segment_sum
from distmlip_tpu.kernels import pallas_segment_sum
from distmlip_tpu.ops.segment import masked_segment_sum as jax_masked_segment_sum
from distmlip_tpu_torch.kernels import (fused_segment_sum, launch_counts,
                                        segment_sum_cuda, segment_sum_reference)
from tests.test_torch_cuda import CASES, case_data, sorted_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_pallas_and_plain(name):
    seed, e, n, pad, im, hi, trailing = CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    data = case_data(seed, len(ids), trailing)
    jax_kernel = np.asarray(pallas_segment_sum(
        jnp.asarray(data), jnp.asarray(ids), n, jnp.asarray(mask),
        interpret=True))
    jax_plain = np.asarray(jax_masked_segment_sum(
        jnp.asarray(data), jnp.asarray(ids), n, jnp.asarray(mask),
        indices_are_sorted=True))
    td, ti, tm = map(torch.from_numpy, (data, ids, mask))
    port = fused_segment_sum(td, ti, n, tm, indices_are_sorted=True).numpy()
    plain = segment_sum_reference(td, ti, n, tm).numpy()
    assert port.shape == jax_kernel.shape == (n,) + trailing
    np.testing.assert_allclose(port, jax_kernel, atol=ATOL)
    np.testing.assert_allclose(port, jax_plain, atol=ATOL)
    np.testing.assert_array_equal(port, plain)


def test_all_masked_and_empty_inputs():
    ids, mask, n = sorted_case(7, 50, 9, 5)
    data = case_data(7, len(ids), (3,))
    none = np.zeros_like(mask)
    jax_out = np.asarray(pallas_segment_sum(
        jnp.asarray(data), jnp.asarray(ids), n, jnp.asarray(none),
        interpret=True))
    port = fused_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n,
                             torch.from_numpy(none), indices_are_sorted=True)
    np.testing.assert_array_equal(port.numpy(), jax_out)
    assert not port.any()
    # E = 0 and N = 0 give zeros of the right shape (segment.py:155)
    empty = fused_segment_sum(torch.zeros((0, 4, 2)), torch.zeros(0, dtype=torch.int32),
                              6, torch.zeros(0, dtype=torch.bool), indices_are_sorted=True)
    assert empty.shape == (6, 4, 2) and not empty.any()
    assert fused_segment_sum(torch.ones((3, 2)), torch.zeros(3, dtype=torch.int32), 0,
                             None, indices_are_sorted=True).shape == (0, 2)


def test_nonfinite_masked_rows_do_not_leak():
    ids, mask, n = sorted_case(8, 40, 7, 6)
    data = case_data(8, len(ids), (3,))
    data[~mask] = np.nan
    out = fused_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n,
                            torch.from_numpy(mask), indices_are_sorted=True)
    assert torch.isfinite(out).all()


def test_half_precision_accumulates_in_fp32():
    """bf16 rows sum in fp32 and round once (ops/segment.py:20): many small
    terms onto one row do not lose bits edge by edge."""
    ids = torch.zeros(4096, dtype=torch.int32)
    data = torch.full((4096, 2), 1e-3, dtype=torch.bfloat16)
    out = fused_segment_sum(data, ids, 1, None, indices_are_sorted=True)
    want = data.float().sum(0, keepdim=True).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    jax_out = jax_masked_segment_sum(jnp.asarray(data.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(ids.numpy()), 1)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jax_out.astype(jnp.float32)))


def test_unsorted_ids_take_the_plain_path():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 11, 80).astype(np.int32)
    mask = rng.random(80) > 0.2
    data = case_data(9, 80, (4,))
    want = np.asarray(jax_masked_segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                             11, jnp.asarray(mask)))
    got = fused_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 11,
                            torch.from_numpy(mask), indices_are_sorted=False)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_backward_matches_jax_custom_vjp():
    """d/d(data) of sum(w * out**2): the port's Function backward vs the
    JAX custom VJP of the interpret-mode Pallas path (dispatch.py:220)."""
    ids, mask, n = sorted_case(10, 200, 23, 30, 7)
    data = case_data(10, len(ids), (3, 4))
    w = np.random.default_rng(11).normal(size=(n, 3, 4)).astype(np.float32)

    def jloss(d):
        out = jax_fused_segment_sum(d, jnp.asarray(ids), n, jnp.asarray(mask),
                                    indices_are_sorted=True, kernels="interpret")
        return jnp.sum(jnp.asarray(w) * out ** 2)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_(True)
    out = fused_segment_sum(td, torch.from_numpy(ids), n, torch.from_numpy(mask),
                            indices_are_sorted=True)
    loss = (torch.from_numpy(w) * out ** 2).sum()
    (tg,) = torch.autograd.grad(loss, td)
    assert abs(float(loss.detach()) - float(jv)) < 1e-5 * abs(float(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4)
    assert not tg[torch.from_numpy(~mask)].any()


def test_gradcheck_float64():
    ids, mask, n = sorted_case(12, 30, 8, 5, 3)
    data = torch.from_numpy(case_data(12, len(ids), (2,)).astype(np.float64))
    data.requires_grad_(True)
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    fn = lambda d: fused_segment_sum(d, ti, n, tm, indices_are_sorted=True)
    assert torch.autograd.gradcheck(fn, (data,))
    assert torch.autograd.gradgradcheck(fn, (data,))


def test_cuda_wrapper_rejects_cpu_tensors():
    ids, mask, n = sorted_case(13, 20, 5, 2)
    before = launch_counts["segment_sum"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_sum_cuda(torch.zeros((len(ids), 4)), torch.from_numpy(ids), n,
                         torch.from_numpy(mask))
    assert launch_counts["segment_sum"] == before
