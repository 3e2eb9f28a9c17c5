"""The port's TensorNet and CHGNet edge aggregations against the JAX package's.

Same inputs (numpy, fixed seed) go through the JAX Pallas kernel in
interpret mode (``pallas_edge_aggregate(..., interpret=True)``) and the
JAX dispatcher's custom VJP (``fused_edge_aggregate(kernels="interpret",
bwd_chunk=...)``), and through the port's ``fused_edge_aggregate`` on the
CPU, where the autograd Function takes the plain version because the
tensors lie on the CPU. The ids are dst-sorted with a repeat-last padded
tail and masked interior rows (``tests/test_kernels.py:39``). The CUDA
kernels themselves run only on a card: ``tests/test_torch_cuda.py`` holds
them against the plain versions there on the same cases.

TensorNet's interaction takes I, A and S as compact rows on the port's
side (``interaction_inputs``: the trace / 3, A's upper triangle, S's
diagonal and upper triangle); the JAX side gets them expanded to full 3x3
arrays (``_expand``), and its dense cotangents come back to compact ones
by the chain rule (``_compact_cotangents``).

CHGNet's messages carry the gated MLP's weights: on the JAX side the
``edge_fn`` closes over them and the dispatcher hoists them as kernel
consts (``diff_params=True`` gives their cotangents); on the port's they
are the explicit ``weights`` of ``fused_edge_aggregate``.

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
from distmlip_tpu.ops.nn import gated_mlp as jax_gated_mlp
from distmlip_tpu_torch.kernels import dispatch, edge_aggregate
from distmlip_tpu_torch.kernels import (CHGNET_ATOM_CONV, CHGNET_LINE_CONV,
                                        TENSORNET_EMBED, TENSORNET_INTERACTION,
                                        EdgeMessage, Gather,
                                        chgnet_atom_conv_aggregate_cuda,
                                        chgnet_atom_conv_aggregate_reference,
                                        chgnet_line_aggregate_cuda,
                                        chgnet_line_aggregate_reference, csr_row_offsets,
                                        fused_edge_aggregate, launch_counts,
                                        tensornet_embed_aggregate_cuda,
                                        tensornet_embed_aggregate_reference,
                                        tensornet_interaction_aggregate_cuda,
                                        tensornet_interaction_aggregate_reference,
                                        tensornet_interaction_backward_cuda,
                                        tensornet_interaction_backward_error_bound,
                                        tensornet_interaction_backward_reference,
                                        tensornet_interaction_error_bound)
from tests.test_torch_cuda import (CHGNET_CASES, EDGE_AGG_CASES, chgnet_inputs,
                                   embed_inputs, interaction_inputs, sorted_case)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

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


def _expand(node_i, node_a, node_s):
    """Compact rows (numpy) -> the full (N, 3, 3, C) I, A, S."""
    n, c = node_i.shape
    eye = np.eye(3, dtype=node_i.dtype)[:, :, None]
    full_i = node_i[:, None, None, :] * eye
    full_a = np.zeros((n, 3, 3, c), node_a.dtype)
    full_s = np.zeros((n, 3, 3, c), node_s.dtype)
    for k, (p, q) in enumerate(((0, 1), (0, 2), (1, 2))):
        full_a[:, p, q], full_a[:, q, p] = node_a[:, k], -node_a[:, k]
        full_s[:, p, q] = full_s[:, q, p] = node_s[:, 3 + k]
        full_s[:, k, k] = node_s[:, k]
    return full_i, full_a, full_s


def _compact_cotangents(d_i, d_a, d_s):
    """Dense cotangents of the full I, A, S -> those of the compact rows,
    by the chain rule of ``_expand``: d i = dI00 + dI11 + dI22, d a_pq =
    dA_pq - dA_qp, d s_pp = dS_pp, d s_pq = dS_pq + dS_qp."""
    d_i, d_a, d_s = (np.asarray(x) for x in (d_i, d_a, d_s))
    pairs = ((0, 1), (0, 2), (1, 2))
    ci = d_i[:, 0, 0] + d_i[:, 1, 1] + d_i[:, 2, 2]
    ca = np.stack([d_a[:, p, q] - d_a[:, q, p] for p, q in pairs], 1)
    cs = np.stack([d_s[:, k, k] for k in range(3)]
                  + [d_s[:, p, q] + d_s[:, q, p] for p, q in pairs], 1)
    return ci, ca, cs


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
        f, src = j[0], j[4]
        node_i, node_a, node_s = (jnp.asarray(x) for x in _expand(*arrays[1:4]))
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

    jx = list(arrays[:n_diff])
    if which == "interaction":  # JAX differentiates the full I, A, S
        jx[1:4] = _expand(*jx[1:4])
    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(n_diff)))(
        *[jnp.asarray(x) for x in jx])
    if which == "interaction":
        jg = [jg[0], *_compact_cotangents(*jg[1:4])]

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


def _jax_interaction_vjp(arrays, ids, mask, n, g, kernels):
    """The JAX dispatcher's VJP at cotangent ``g`` on the expanded rows,
    brought back to compact cotangents: (d f, d i, d a, d s). With
    ``kernels="interpret"`` the custom VJP of the interpret-mode kernel
    (64-edge backward chunks); with False the XLA path's autodiff."""
    f, node_i, node_a, node_s, src = arrays
    js = jnp.asarray(src)

    def agg(f_, i_, a_, s_):
        return jax_fused_edge_aggregate(
            _jax_interaction_msg, [f_, JGather(i_, js), JGather(a_, js), JGather(s_, js)],
            jnp.asarray(ids), n, jnp.asarray(mask), kernels=kernels, bwd_chunk=64)

    _, vjp = jax.vjp(agg, *[jnp.asarray(x) for x in [f, *_expand(node_i, node_a, node_s)]])
    d_f, *dense = vjp(jnp.asarray(g))
    return [np.asarray(d_f), *_compact_cotangents(*dense)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_interaction_backward_reference_matches_autograd_and_jax(dtype):
    """``tensornet_interaction_backward_reference`` (the plain version of
    the backward kernel) vs torch autograd of the plain forward and vs the
    JAX package's VJP with the chain rule to compact rows; float32 within
    ``_close`` against the chunked custom VJP of the interpret-mode kernel,
    float64 within 1e-12 of each array's scale against the XLA path's VJP
    (the interpret-mode kernel does not trace with 64-bit types on). Masked
    edges get zero d f rows."""
    arrays, ids, mask, n, c = _case("repeated_tail_padding", "interaction")
    np_dtype = np.dtype(dtype)
    arrays = [x.astype(np_dtype) if x.dtype.kind == "f" else x for x in arrays]
    g = np.random.default_rng(6).normal(size=(n, 3, 3, c)).astype(np_dtype)
    t = [torch.from_numpy(x) for x in arrays]
    ti, tm, tg = torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(g)
    got = tensornet_interaction_backward_reference(tg, *t, ti, tm)
    leaves = [x.clone().requires_grad_(True) for x in t[:4]]
    out = tensornet_interaction_aggregate_reference(*leaves, t[4], ti, n, tm)
    auto = torch.autograd.grad(out, leaves, tg)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        jref = _jax_interaction_vjp(arrays, ids, mask, n, g,
                                    "interpret" if dtype == "float32" else False)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert jref[0].dtype == np_dtype
    for x, a, j in zip(got, auto, jref):
        assert x.dtype == getattr(torch, dtype) and x.shape == a.shape == j.shape
        if dtype == "float32":
            _close(x.numpy(), a.numpy())
            _close(x.numpy(), j)
        else:
            for want in (a.numpy(), j):
                np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                           atol=1e-12 * max(1.0, np.abs(want).max()))
    assert not got[0][~tm].any()


def test_interaction_backward_takes_the_kernel_route_outside_grad_mode():
    """The dispatcher's backward after a kernel forward: outside grad mode
    (the force program) it launches the message's kernel backward and runs
    no plain recompute; under create_graph (a double backward) it takes the
    chunked recompute, which keeps its graph. The kernels are stood in by
    their plain versions here (CPU tensors), counted; the gradients equal
    kernels=False ones, first and second order."""
    arrays, ids, mask, n, c = _case("e_not_multiple_of_block", "interaction")
    t = [torch.from_numpy(x.astype(np.float64) if x.dtype.kind == "f" else x)
         for x in arrays]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    calls = []

    def fwd(items, weights, segment_ids, num_segments, mask_):
        f, *gathered = items
        return tensornet_interaction_aggregate_reference(
            f, *(x for x, _ in gathered), gathered[0][1], segment_ids, num_segments, mask_)

    def bwd(items, weights, g, segment_ids, mask_, needs):
        calls.append(needs)
        f, *gathered = items
        grads = tensornet_interaction_backward_reference(
            g, f, *(x for x, _ in gathered), gathered[0][1], segment_ids, mask_)
        return [x if need else None for x, need in zip(grads, needs)]

    stand_in = EdgeMessage(TENSORNET_INTERACTION.name, TENSORNET_INTERACTION.fn, fwd, bwd)

    def run(use_kernel, create_graph):
        leaves = [x.clone().requires_grad_(True) for x in t[:4]]
        out = dispatch._EdgeAggregate.apply(stand_in, (None, 0, 0, 0), 0, use_kernel, 64, n,
                                            ti, tm, *leaves, t[4])
        grads = torch.autograd.grad((out ** 2).sum(), leaves, create_graph=create_graph)
        if not create_graph:
            return grads
        return torch.autograd.grad(sum((x ** 2).sum() for x in grads), leaves)

    name = TENSORNET_INTERACTION.name
    chunks = dispatch.recompute_chunks.get(name, 0)
    got = run(True, False)
    assert calls == [(True,) * 4] and dispatch.recompute_chunks.get(name, 0) == chunks
    for a, b in zip(got, run(False, False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    # the double backward: the first pass (create_graph) recomputes in 9
    # chunks of 64 edges; the second reaches the forward's Function once
    # more, first order, outside grad mode: the kernel route
    chunks = dispatch.recompute_chunks[name]
    got = run(True, True)
    assert len(calls) == 2 and dispatch.recompute_chunks[name] == chunks + 9
    for a, b in zip(got, run(False, True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_interaction_kernel_arithmetic_within_bounds(which):
    """The kernels' float32 arithmetic, emulated on the CPU, and the plain
    float32 version each sit within half of the stated tolerance
    (``tensornet_interaction_error_bound`` and its backward's) of the
    float64 value: the forward sums the compact components f0 i, f1 a,
    f2 s per dst row in edge order and assembles the 3x3 once; the backward
    walks the valid edges in ``src_order``, projects g[dst] to t, u, v and
    sums f0 t, f1 u, f2 v per src row."""
    arrays, ids, mask, n, c = _case("repeated_tail_padding", "interaction")
    t = [torch.from_numpy(x) for x in arrays]
    f, node_i, node_a, node_s, src = t
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    t64 = [x.double() if x.is_floating_point() else x for x in t]
    valid = torch.nonzero(tm)[:, 0]
    if which == "forward":
        exact = tensornet_interaction_aggregate_reference(*t64, ti, n, tm)
        plain = tensornet_interaction_aggregate_reference(*t, ti, n, tm)
        sv = src[valid].long()
        comps = torch.cat([(f[valid, :, 0] * node_i[sv])[:, None],
                           f[valid, None, :, 1] * node_a[sv],
                           f[valid, None, :, 2] * node_s[sv]], 1)
        acc = torch.zeros((n, 10, c)).index_add_(0, ti[valid].long(), comps)
        off = acc[:, 4 + 3:]
        emulated = edge_aggregate.tensornet_full(acc[:, :1] + acc[:, 4:7], acc[:, 1:4] + off,
                                                 off - acc[:, 1:4])
        bounds = [tensornet_interaction_error_bound(*t, ti, n, tm)]
        checks = [(plain, exact, bounds[0]), (emulated, exact, bounds[0])]
    else:
        g = torch.from_numpy(np.random.default_rng(4).normal(size=(n, 3, 3, c)).astype(
            np.float32))
        exact = tensornet_interaction_backward_reference(g.double(), *t64, ti, tm)
        plain = tensornet_interaction_backward_reference(g, *t, ti, tm)
        perm, row_ptr = edge_aggregate.src_order(src, node_i.shape[0], tm)
        order = perm[:int(row_ptr[-1])]
        gm = g[ti[order].long()]
        tt = gm[:, 0, 0] + gm[:, 1, 1] + gm[:, 2, 2]
        pairs_ = ((0, 1), (0, 2), (1, 2))
        u = torch.stack([gm[:, p, q] - gm[:, q, p] for p, q in pairs_], 1)
        v = torch.cat([torch.stack([gm[:, k, k] for k in range(3)], 1),
                       torch.stack([gm[:, p, q] + gm[:, q, p] for p, q in pairs_], 1)], 1)
        so, fo = src[order].long(), f[order]
        d_f = torch.zeros_like(f)
        d_f[order] = torch.stack([tt * node_i[so], (u * node_a[so]).sum(1),
                                  (v * node_s[so]).sum(1)], -1)
        emulated = (d_f,
                    torch.zeros_like(node_i).index_add_(0, so, fo[:, :, 0] * tt),
                    torch.zeros_like(node_a).index_add_(0, so, fo[:, None, :, 1] * u),
                    torch.zeros_like(node_s).index_add_(0, so, fo[:, None, :, 2] * v))
        bounds = tensornet_interaction_backward_error_bound(g, *t, ti, tm)
        checks = [(x, y, b) for got in (plain, emulated) for x, y, b in zip(got, exact, bounds)]
    for got, want, bound in checks:
        err = (got.double() - want).abs()
        assert bool((err <= bound.double() / 2 + 1e-30).all())
        assert float(err.max()) > 0  # float32 roundoff is there to bound


def test_src_order_is_stable_with_masked_edges_last():
    src = torch.tensor([3, 1, 3, 0, 1, 2, 3, 0], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True, True, True, False])
    perm, row_ptr = edge_aggregate.src_order(src, 5, mask)
    assert perm.tolist() == [3, 1, 4, 5, 0, 6, 2, 7]
    assert row_ptr.tolist() == [0, 1, 3, 4, 6, 6]
    perm, row_ptr = edge_aggregate.src_order(src, 4)
    assert perm.tolist() == [3, 7, 1, 4, 5, 0, 2, 6] and row_ptr.tolist() == [0, 2, 4, 5, 8]


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
    g = torch.zeros((n, 3, 3, inter[0].shape[1]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tensornet_interaction_backward_cuda(g, *[torch.from_numpy(x) for x in inter], ti, tm)
    assert launch_counts == before


# ---------------------------------------------------------------------------
# CHGNet: gated-MLP messages with weights
# ---------------------------------------------------------------------------

def _chgnet_case(name, which):
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    return arrays, weights, ids, mask, n


def _jax_gated(weights):
    w = [jnp.asarray(x) for x in weights]
    return {"core": [{"w": w[0], "b": w[1]}, {"w": w[2], "b": w[3]}],
            "gate": [{"w": w[4], "b": w[5]}, {"w": w[6], "b": w[7]}]}


def _jax_chgnet(which, arrays, p, ids, mask, n, kernels, bwd_chunk=None):
    """JAX fused_edge_aggregate of the model's own edge_fn, closing over
    the gated MLP ``p`` (chgnet.py:333-339, :356-365)."""
    if which == "atom":
        node_src, src, node_dst, dst, edge, abw = arrays

        def fn(vs, vd, e_, w_):
            return jax_gated_mlp(p, jnp.concatenate([vs, vd, e_], axis=-1)) * w_

        items = [JGather(node_src, src), JGather(node_dst, dst), edge, abw]
    else:
        bond_src, ls, bond_dst, ld, angle, node, ctr = arrays

        def fn(bs, bd, a_, vc):
            return jax_gated_mlp(p, jnp.concatenate([bs, bd, a_, vc], axis=-1))

        items = [JGather(bond_src, ls), JGather(bond_dst, ld), angle, JGather(node, ctr)]
    return jax_fused_edge_aggregate(fn, items, jnp.asarray(ids), n, jnp.asarray(mask),
                                    kernels=kernels, diff_params=True, bwd_chunk=bwd_chunk)


def _port_chgnet(which, t, weights, ids, n, mask, **kw):
    if which == "atom":
        node_src, src, node_dst, dst, edge, abw = t
        message = CHGNET_ATOM_CONV
        inputs = [Gather(node_src, src), Gather(node_dst, dst), edge, abw]
    else:
        bond_src, ls, bond_dst, ld, angle, node, ctr = t
        message = CHGNET_LINE_CONV
        inputs = [Gather(bond_src, ls), Gather(bond_dst, ld), angle, Gather(node, ctr)]
    return fused_edge_aggregate(message, inputs, ids, n, mask, weights=weights, **kw)


@pytest.mark.parametrize("mode", [False, "interpret"])
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", ["repeated_tail_padding", "empty_rows", "channels_7",
                                  "matgl_widths"])
def test_chgnet_forward_matches_jax(name, which, mode):
    """Each CHGNet message through the port's dispatcher (and its plain
    version) vs the JAX dispatcher with the same edge_fn, on the XLA path
    and through the interpret-mode Pallas kernel."""
    arrays, weights, ids, mask, n = _chgnet_case(name, which)
    want = np.asarray(_jax_chgnet(which, [jnp.asarray(x) for x in arrays],
                                  _jax_gated(weights), ids, mask, n, mode))
    t = [torch.from_numpy(x) for x in arrays]
    tw = [torch.from_numpy(w) for w in weights]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got = _port_chgnet(which, t, tw, ti, n, tm)
    ref = (chgnet_atom_conv_aggregate_reference if which == "atom"
           else chgnet_line_aggregate_reference)(*t, tw, ti, n, tm)
    assert got.shape == want.shape == (n, arrays[4].shape[1])
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("which", ["atom", "line"])
def test_chgnet_gradients_match_jax_diff_params(which):
    """d/d(node arrays, per-edge rows, every weight) of sum(w * out**2):
    the port's chunked backward vs the JAX custom VJP of the interpret-mode
    kernel with diff_params=True (the hoisted weights' cotangents), both
    with a 64-edge backward chunk so several chunks run."""
    arrays, weights, ids, mask, n = _chgnet_case("repeated_tail_padding", which)
    c = arrays[4].shape[1]
    g = np.random.default_rng(8).normal(size=(n, c)).astype(np.float32)
    # differentiable inputs: the atom conv's node array, e and abw; the line
    # conv's bond array, the angle rows and the node array. Input 2 is input
    # 0 again (the node array at src and dst, the bond array at both ends).
    diff = [0, 4, 5]

    def jloss(xs, ws):
        full = [jnp.asarray(x) for x in arrays]
        for k, x in zip(diff, xs):
            full[k] = x
        full[2] = full[0]
        out = _jax_chgnet(which, full, _jax_gated(ws), ids, mask, n, "interpret",
                          bwd_chunk=64)
        return jnp.sum(jnp.asarray(g) * out ** 2)

    jx = [jnp.asarray(arrays[k]) for k in diff]
    jw = [jnp.asarray(w) for w in weights]
    jv, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jx, jw)

    t = [torch.from_numpy(x) for x in arrays]
    leaves = [torch.from_numpy(arrays[k]).requires_grad_(True) for k in diff]
    for k, x in zip(diff, leaves):
        t[k] = x
    t[2] = t[0]
    tw = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    out = _port_chgnet(which, t, tw, torch.from_numpy(ids), n, torch.from_numpy(mask),
                       bwd_chunk=64)
    loss = (torch.from_numpy(g) * out ** 2).sum()
    got = torch.autograd.grad(loss, leaves + tw)
    assert abs(float(loss.detach()) - float(jv)) < 1e-5 * max(1.0, abs(float(jv)))
    for a, b in zip(got, list(jgx) + list(jgw)):
        _close(a.numpy(), b)


@pytest.mark.parametrize("which", ["atom", "line"])
def test_chgnet_gradcheck_and_gradgradcheck_float64(which):
    """float64 gradcheck and gradgradcheck of the dispatcher on the
    inputs AND the weights, with a 4-edge backward chunk."""
    ids, mask, n = sorted_case(12, 12, 5, 3, 2)
    arrays, weights = chgnet_inputs(12, which, len(ids), 2, 3, n_node=4)
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    idx = {k: torch.from_numpy(arrays[k]) for k in ((1, 3) if which == "atom" else (1, 3, 6))}
    floats = [k for k in range(len(arrays)) if k not in idx and k != 2]
    xs = tuple(torch.from_numpy(arrays[k].astype(np.float64)).requires_grad_(True)
               for k in floats)
    ws = tuple(torch.from_numpy(w.astype(np.float64)).requires_grad_(True) for w in weights)

    def fn(*args):
        t = [None] * len(arrays)
        for k, x in zip(floats, args[:len(floats)]):
            t[k] = x
        for k, i in idx.items():
            t[k] = i
        t[2] = t[0]
        return _port_chgnet(which, t, args[len(floats):], ti, n, tm, bwd_chunk=4)

    assert torch.autograd.gradcheck(fn, xs + ws)
    assert torch.autograd.gradgradcheck(fn, xs + ws)


def test_weights_that_need_no_gradient_get_none():
    """The force program asks for input gradients only: the backward then
    recomputes with the weights as they are (no weight-gradient graph) and
    returns no weight cotangent; asking for the weights adds them."""
    arrays, weights, ids, mask, n = _chgnet_case("empty_rows", "line")
    seen = []

    def fn(*rows, weights):
        seen.append([w.requires_grad for w in weights])
        return CHGNET_LINE_CONV.fn(*rows, weights=weights)

    spy = EdgeMessage("spy", fn)
    t = [torch.from_numpy(x) for x in arrays]
    bond = t[0].clone().requires_grad_(True)
    tw = [torch.from_numpy(w) for w in weights]
    inputs = [Gather(bond, t[1]), Gather(bond, t[3]), t[4], Gather(t[5], t[6])]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    out = fused_edge_aggregate(spy, inputs, ti, n, tm, weights=tw)
    (gb,) = torch.autograd.grad(out.sum(), [bond])
    assert gb.abs().sum() > 0 and seen and not any(any(s) for s in seen)
    seen.clear()
    tw = [w.requires_grad_(True) for w in tw]
    out = fused_edge_aggregate(spy, inputs, ti, n, tm, weights=tw)
    grads = torch.autograd.grad(out.sum(), [bond] + tw)
    assert all(g is not None for g in grads) and all(all(s) for s in seen[1:])


def test_chgnet_cuda_wrappers_reject_cpu_tensors_and_deep_mlps():
    arrays, weights, ids, mask, n = _chgnet_case("empty_rows", "atom")
    t = [torch.from_numpy(x) for x in arrays]
    tw = [torch.from_numpy(w) for w in weights]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        chgnet_atom_conv_aggregate_cuda(*t, tw, ti, n, tm)
    la, lw, *_ = _chgnet_case("empty_rows", "line")
    with pytest.raises(ValueError, match="CUDA tensors"):
        chgnet_line_aggregate_cuda(*[torch.from_numpy(x) for x in la],
                                   [torch.from_numpy(w) for w in lw], ti, n, tm)
    assert launch_counts == before
    # one hidden layer only: a deeper (or shallower) gated MLP is refused
    # before anything reaches the card
    deep = tw[:2] + tw[2:4] * 2 + tw[4:6] + tw[6:8] * 2
    for bad in (tw[:4], deep):
        with pytest.raises(ValueError, match="exactly one hidden layer"):
            edge_aggregate._check_gated_weights("atom", bad, 3 * t[4].shape[1],
                                                t[4].shape[1], t[4].device)
