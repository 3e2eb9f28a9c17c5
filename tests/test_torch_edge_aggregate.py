"""The port's TensorNet edge aggregations against the JAX package's.

Same inputs (numpy, fixed seed) go through the JAX Pallas kernel in
interpret mode (``pallas_edge_aggregate(..., interpret=True)``) and the
JAX dispatcher's custom VJP (``fused_edge_aggregate(kernels="interpret",
bwd_chunk=...)``), and through the port's ``fused_edge_aggregate`` on the
CPU, where the autograd Function takes the plain version because the
tensors lie on the CPU. The ids are dst-sorted with a repeat-last padded
tail and masked interior rows (``tests/test_kernels.py:39``). The CUDA
kernels themselves run only on a card: ``tests/test_torch_cuda.py`` holds
them against the plain versions there on the same cases.

Tolerance (float32): sums of a few dozen O(1) terms in another order on
each side, so atol = 1e-5 * max(1, the largest magnitude of the compared
array).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distmlip_tpu.kernels import Gather as JGather
from distmlip_tpu.kernels import fused_edge_aggregate as jax_fused_edge_aggregate
from distmlip_tpu.kernels import pallas_edge_aggregate
from distmlip_tpu_torch.kernels import (TENSORNET_EMBED, TENSORNET_INTERACTION,
                                        EdgeMessage, Gather, csr_row_offsets,
                                        fused_edge_aggregate, launch_counts,
                                        tensornet_embed_aggregate_cuda,
                                        tensornet_embed_aggregate_reference,
                                        tensornet_interaction_aggregate_cuda,
                                        tensornet_interaction_aggregate_reference)
from tests.test_torch_cuda import (EDGE_AGG_CASES, embed_inputs, interaction_inputs,
                                   sorted_case)

N_NODE = 23


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * scale)


def _jax_embed_msg(zij, w1, w2, w3, ae, se, eye):
    return zij[:, None, None, :] * (w1[:, None, None, :] * eye
                                    + w2[:, None, None, :] * ae
                                    + w3[:, None, None, :] * se)


def _jax_interaction_msg(f, i_s, a_s, s_s):
    return (f[:, None, None, :, 0] * i_s + f[:, None, None, :, 1] * a_s
            + f[:, None, None, :, 2] * s_s)


def _case(name, which):
    seed, e, n, pad, im, hi, c = EDGE_AGG_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays = (embed_inputs(seed, len(ids), c) if which == "embed"
              else interaction_inputs(seed, len(ids), N_NODE, c))
    return arrays, ids, mask, n, c


def _port_inputs(which, tensors, src=None):
    if which == "embed":
        return TENSORNET_EMBED, list(tensors)
    f, node_i, node_a, node_s = tensors
    return TENSORNET_INTERACTION, [f, Gather(node_i, src), Gather(node_a, src),
                                   Gather(node_s, src)]


def _jax_pallas(which, arrays, ids, mask, n, c):
    j = [jnp.asarray(x) for x in arrays]
    if which == "embed":
        fn, items, consts = _jax_embed_msg, j, (jnp.eye(3)[:, :, None],)
    else:
        f, node_i, node_a, node_s, src = j
        fn, consts = _jax_interaction_msg, ()
        items = [f, ("gather", node_i, src), ("gather", node_a, src),
                 ("gather", node_s, src)]
    return np.asarray(pallas_edge_aggregate(
        fn, items, jnp.asarray(ids), n, jnp.asarray(mask), out_shape=(3, 3, c),
        out_dtype=jnp.float32, consts=consts, interpret=True))


@pytest.mark.parametrize("which", ["embed", "interaction"])
@pytest.mark.parametrize("name", ["repeated_tail_padding", "empty_rows",
                                  "e_not_multiple_of_block", "channels_not_multiple_of_4"])
def test_forward_matches_jax_pallas(name, which):
    arrays, ids, mask, n, c = _case(name, which)
    want = _jax_pallas(which, arrays, ids, mask, n, c)
    t = [torch.from_numpy(x) for x in arrays]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    if which == "embed":
        message, inputs = _port_inputs(which, t)
        plain = tensornet_embed_aggregate_reference(*t, ti, n, tm)
    else:
        message, inputs = _port_inputs(which, t[:4], t[4])
        plain = tensornet_interaction_aggregate_reference(*t, ti, n, tm)
    got = fused_edge_aggregate(message, inputs, ti, n, tm)
    assert got.shape == want.shape == (n, 3, 3, c)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_gradients_match_jax_chunked_vjp(which):
    """d/d(every per-edge input and every gathered node array) of
    sum(w * out**2): the port's chunked backward vs the JAX custom VJP of
    the interpret-mode kernel, both with a 64-edge backward chunk so
    several chunks run (340 edges)."""
    arrays, ids, mask, n, c = _case("repeated_tail_padding", which)
    w = np.random.default_rng(5).normal(size=(n, 3, 3, c)).astype(np.float32)
    jids, jmask, jw = jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(w)
    n_diff = 6 if which == "embed" else 4
    src = None if which == "embed" else arrays[4]

    def jloss(*xs):
        if which == "embed":
            eye = jnp.eye(3)[:, :, None]
            fn, items = (lambda *r: _jax_embed_msg(*r, eye)), list(xs)
        else:
            js = jnp.asarray(src)
            fn = _jax_interaction_msg
            items = [xs[0], JGather(xs[1], js), JGather(xs[2], js), JGather(xs[3], js)]
        out = jax_fused_edge_aggregate(fn, items, jids, n, jmask, kernels="interpret",
                                       bwd_chunk=64)
        return jnp.sum(jw * out ** 2)

    jx = [jnp.asarray(x) for x in arrays[:n_diff]]
    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(n_diff)))(*jx)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in arrays[:n_diff]]
    message, inputs = _port_inputs(
        which, leaves, None if src is None else torch.from_numpy(src))
    out = fused_edge_aggregate(message, inputs, torch.from_numpy(ids), n,
                               torch.from_numpy(mask), bwd_chunk=64)
    loss = (torch.from_numpy(w) * out ** 2).sum()
    tg = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jv)) < 1e-5 * max(1.0, abs(float(jv)))
    for a, b in zip(tg, jg):
        _close(a.numpy(), b)
    if which == "embed":  # masked rows get no cotangent
        assert not tg[0][torch.from_numpy(~mask)].any()


@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_gradcheck_and_gradgradcheck_float64(which):
    ids, mask, n = sorted_case(12, 12, 5, 3, 2)
    c = 2
    if which == "embed":
        arrays = embed_inputs(12, len(ids), c)
        src = None
    else:
        arrays = interaction_inputs(12, len(ids), 4, c)
        src = torch.from_numpy(arrays.pop())
    xs = tuple(torch.from_numpy(x.astype(np.float64)).requires_grad_(True) for x in arrays)
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)

    def fn(*ts):
        message, inputs = _port_inputs(which, ts, src)
        return fused_edge_aggregate(message, inputs, ti, n, tm, bwd_chunk=4)

    assert torch.autograd.gradcheck(fn, xs)
    assert torch.autograd.gradgradcheck(fn, xs)


def test_kernelless_message_unsorted_and_empty_take_the_plain_path():
    """A message without a kernel runs its plain version on the CPU;
    unsorted ids and E = 0 give masked_segment_sum's answer; a bare
    callable is refused."""
    arrays, ids, mask, n, c = _case("empty_rows", "interaction")
    f, node_i, node_a, node_s, src = [torch.from_numpy(x) for x in arrays]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    inputs = [f, Gather(node_i, src), Gather(node_a, src), Gather(node_s, src)]
    want = fused_edge_aggregate(TENSORNET_INTERACTION, inputs, ti, n, tm)
    no_kernel = EdgeMessage("no_kernel", TENSORNET_INTERACTION.fn)
    got = fused_edge_aggregate(no_kernel, inputs, ti, n, tm)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(TypeError, match="EdgeMessage"):
        fused_edge_aggregate(TENSORNET_INTERACTION.fn, inputs, ti, n, tm)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(ids)))
    shuffled = [f[perm], Gather(node_i, src[perm]), Gather(node_a, src[perm]),
                Gather(node_s, src[perm])]
    unsorted = fused_edge_aggregate(TENSORNET_INTERACTION, shuffled, ti[perm], n, tm[perm],
                                    indices_are_sorted=False)
    _close(unsorted.numpy(), want.numpy())
    empty = fused_edge_aggregate(TENSORNET_INTERACTION, [x[:0] if not isinstance(x, Gather)
                                                         else Gather(x.node, x.idx[:0])
                                                         for x in inputs],
                                 ti[:0], n, tm[:0])
    assert empty.shape == (n, 3, 3, c) and not empty.any()
    with pytest.raises(TypeError, match="bool"):
        fused_edge_aggregate(TENSORNET_INTERACTION, inputs, ti, n, tm.float())
    assert isinstance(TENSORNET_EMBED, EdgeMessage) and TENSORNET_EMBED.cuda is not None


def test_nonfinite_masked_rows_do_not_leak():
    arrays, ids, mask, n, c = _case("repeated_tail_padding", "embed")
    for x in arrays:
        x[~mask] = np.nan
    t = [torch.from_numpy(x) for x in arrays]
    out = fused_edge_aggregate(TENSORNET_EMBED, t, torch.from_numpy(ids), n,
                               torch.from_numpy(mask))
    assert torch.isfinite(out).all()


def test_csr_row_offsets_clamp_the_masked_tail():
    ids, mask, n = sorted_case(4, 50, 9, 30, 4)
    ti = torch.from_numpy(ids)
    plain = csr_row_offsets(ti, n).numpy()
    np.testing.assert_array_equal(plain, np.searchsorted(ids, np.arange(n + 1)))
    clamped = csr_row_offsets(ti, n, torch.from_numpy(mask)).numpy()
    last = int(np.nonzero(mask)[0].max()) + 1
    np.testing.assert_array_equal(clamped, np.minimum(plain, last))
    assert clamped[-1] == last < len(ids)
    none = csr_row_offsets(ti, n, torch.zeros(len(ids), dtype=torch.bool)).numpy()
    assert not none.any()


def test_cuda_wrappers_reject_cpu_tensors():
    embed, ids, mask, n, _ = _case("empty_rows", "embed")
    inter, *_ = _case("empty_rows", "interaction")
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tensornet_embed_aggregate_cuda(*[torch.from_numpy(x) for x in embed], ti, n, tm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tensornet_interaction_aggregate_cuda(*[torch.from_numpy(x) for x in inter], ti, n, tm)
    assert launch_counts == before
