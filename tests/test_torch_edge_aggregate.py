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
from distmlip_tpu_torch.kernels import edge_aggregate
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
                                        tensornet_interaction_aggregate_reference)
from tests.test_torch_cuda import (CHGNET_CASES, EDGE_AGG_CASES, chgnet_inputs,
                                   embed_inputs, interaction_inputs, sorted_case)

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
