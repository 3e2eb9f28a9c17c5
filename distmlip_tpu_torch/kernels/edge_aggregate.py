"""The fused edge aggregations of TensorNet and CHGNet: the CUDA kernels'
wrappers, their plain PyTorch versions and the named messages the
dispatcher routes.

Replaces ``distmlip_tpu/kernels/segment.py::pallas_edge_aggregate`` at
TensorNet's two call sites and CHGNet's two. The TPU kernel runs any traced
``edge_fn``; a CUDA kernel cannot take a Python function, so each message
is a small named object (:class:`EdgeMessage`): its torch function (the
plain version and the backward's recompute) plus the launcher of its
kernel, in ``csrc/edge_aggregate.cu`` (TensorNet) and
``csrc/chgnet_aggregate.cu`` (CHGNet):

- ``TENSORNET_EMBED``: ``Z * (W1 * eye + W2 * A_e + W3 * S_e)`` from
  per-edge (E, C) rows and (E, 3, 3, 1) geometric tensors
  (``distmlip_tpu/models/tensornet.py:171-179``);
- ``TENSORNET_INTERACTION``: ``f0 * I[src] + f1 * A[src] + f2 * S[src]``
  from per-edge gates (E, C, 3) and I, A, S as compact node rows gathered
  at the same src ids (``tensornet.py:227-236``): ``i`` (N, C) the trace
  / 3, ``a`` (N, 3, C) A's entries (0,1), (0,2), (1,2), ``s`` (N, 6, C) S's
  (0,0), (1,1), (2,2), (0,1), (0,2), (1,2) (``tensornet_full`` assembles a
  3x3 from such rows). Its backward has a kernel too
  (``tensornet_interaction_backward_cuda``): both cotangents, of the gates
  and of the node rows, in one pass over the edges sorted by src;
- ``CHGNET_ATOM_CONV``: ``GatedMLP([v[src] | v[dst] | e]) * abw`` per edge
  (``distmlip_tpu/models/chgnet.py:333-339``);
- ``CHGNET_LINE_CONV``: ``GatedMLP([b[line_src] | b[line_dst] | a |
  v[line_center]])`` per line-graph edge (``chgnet.py:356-365``).

All sum the message onto the dst-sorted rows under the validity mask:
``(num_segments, 3, 3, C)`` for TensorNet, ``(num_segments, C)`` for
CHGNet. Every kernel also takes bfloat16 (every float tensor of a call one
dtype; a mix raises): a bf16 kernel of its own that reads bf16, computes
and accumulates in fp32 and rounds each output element once, counted
apart (``*_bf16`` launch counts); the messages' ``bf16`` field says that
their kernels take it. TensorNet's bf16 kernels (a warp a row, a channel
pair a lane; ``tensornet_*_bf16_plan`` reports a call's route) add in the
float32 kernels' order, so their outputs are the float32 kernels' on the
upcast inputs, rounded once. CHGNet's bf16 kernels are their
own tensor-core kernels: the row projection multiplies bf16 node rows by
the bf16 packed blocks and writes its tables in float32; the per-edge
kernels take the edge segment's layer 1 and layer 2 as bf16 products with
fp32 accumulators, the hidden rounded once to bf16 between them (as the
bf16 ``linear`` of the reference does), and are held to
``chgnet_tensor_core_error_bound`` against the float32 kernels on the same
tables. CHGNet's messages take the
gated MLP's tensors as ``weights``
(``ops.nn.gated_mlp_weights``: core w1, b1, w2, b2, then the gate's), one
hidden layer for the kernels. The ``*_cuda`` wrappers take CUDA tensors
only and raise on anything else; the ``*_reference`` versions build the
message with torch ops and ``masked_segment_sum`` it. The ``*_error_bound``
functions give each kernel's tolerance against its plain version.

The CHGNet wrappers split layer 1 over the concat row: each gathered
segment's product is taken once per node or bond row by the row projection
kernel (``chgnet_row_projection_cuda``, launch count
``chgnet_row_projection``), with the weights packed by
``chgnet_pack_weights`` and the tables planned by ``chgnet_row_tables``
(plain torch, which the CPU tests run too); the per-edge kernel then
gathers those partial rows and does only the per-edge work.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.nn import gated_mlp_flat
from ..ops.segment import _HALF_DTYPES, masked_segment_sum
from .segment import count_launch, csr_row_offsets, current_stream_ptr, launch_counts

EMBED = "tensornet_embed_aggregate"
INTERACTION = "tensornet_interaction_aggregate"
INTERACTION_BWD = "tensornet_interaction_backward"
ATOM_CONV = "chgnet_atom_conv_aggregate"
LINE_CONV = "chgnet_line_aggregate"
PROJECTION = "chgnet_row_projection"
BF16 = "_bf16"  # suffix of a kernel's bf16 launch count
launch_counts.update({EMBED: 0, INTERACTION: 0, INTERACTION_BWD: 0, ATOM_CONV: 0,
                      LINE_CONV: 0, PROJECTION: 0, EMBED + BF16: 0, INTERACTION + BF16: 0,
                      INTERACTION_BWD + BF16: 0, ATOM_CONV + BF16: 0, LINE_CONV + BF16: 0,
                      PROJECTION + BF16: 0})


# ---------------------------------------------------------------------------
# the messages, in torch ops
# ---------------------------------------------------------------------------

def tensornet_embed_message(zij, w1, w2, w3, a_e, s_e, *, weights=()):
    """(E, C) x3, (E, 3, 3, 1) x2 -> (E, 3, 3, C); takes no weights."""
    eye = torch.eye(3, dtype=zij.dtype, device=zij.device)[:, :, None]
    return zij[:, None, None, :] * (
        w1[:, None, None, :] * eye
        + w2[:, None, None, :] * a_e
        + w3[:, None, None, :] * s_e)


# the compact rows' entries: (0,1), (0,2), (1,2) above the diagonal, their
# transposes below it
_UPPER = ((0, 0, 1), (1, 2, 2))
_DIAG = ((0, 1, 2), (0, 1, 2))


def tensornet_full(diag, upper, lower):
    """(..., 3, C) rows of the diagonal (0,0), (1,1), (2,2), the upper
    triangle (0,1), (0,2), (1,2) and the lower (1,0), (2,0), (2,1) ->
    (..., 3, 3, C)."""
    d0, d1, d2 = diag.unbind(-2)
    u01, u02, u12 = upper.unbind(-2)
    l10, l20, l21 = lower.unbind(-2)
    return torch.stack([torch.stack([d0, u01, u02], -2), torch.stack([l10, d1, u12], -2),
                        torch.stack([l20, l21, d2], -2)], -3)


def tensornet_interaction_message(f, i_s, a_s, s_s, *, weights=()):
    """(E, C, 3) gates and the gathered compact rows i (E, C), a (E, 3, C),
    s (E, 6, C) -> (E, 3, 3, C): ``f0 I + f1 A + f2 S`` entry for entry as
    the full arrays give it (diagonal f0 i + f2 s_pp, upper f1 a + f2 s_pq,
    lower -(f1 a) + f2 s_pq); takes no weights."""
    fa = f[:, None, :, 1] * a_s
    fs = f[:, None, :, 2] * s_s
    off = fs[:, 3:]
    return tensornet_full((f[:, :, 0] * i_s)[:, None] + fs[:, :3], fa + off, -fa + off)


def chgnet_atom_message(v_src, v_dst, e, abw=None, *, weights):
    """(E, C) rows and the gated MLP's flat weights -> (E, C):
    ``GatedMLP([v_src | v_dst | e])``, times ``abw`` when given."""
    m = gated_mlp_flat(torch.cat([v_src, v_dst, e], dim=-1), weights)
    return m if abw is None else m * abw


def chgnet_line_message(b_src, b_dst, a, v_ctr, *, weights):
    """(L, C) rows and the gated MLP's flat weights -> (L, C):
    ``GatedMLP([b_src | b_dst | a | v_ctr])``."""
    return gated_mlp_flat(torch.cat([b_src, b_dst, a, v_ctr], dim=-1), weights)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tensornet_embed_aggregate_reference(zij, w1, w2, w3, a_e, s_e, segment_ids,
                                        num_segments: int, mask=None):
    msg = tensornet_embed_message(zij, w1, w2, w3, a_e, s_e)
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


def tensornet_interaction_aggregate_reference(f, node_i, node_a, node_s, src,
                                              segment_ids, num_segments: int,
                                              mask=None):
    msg = tensornet_interaction_message(
        f, node_i.index_select(0, src), node_a.index_select(0, src),
        node_s.index_select(0, src))
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


def _g_rows(g, segment_ids, mask):
    """The message cotangent ``g[dst] * mask`` (E, 3, 3, C)."""
    gm = g.index_select(0, segment_ids)
    if mask is not None:
        gm = gm * mask.to(gm.dtype)[:, None, None, None]
    return gm


def _projections(gm, sign=-1.0):
    """t (E, C), u (E, 3, C), v (E, 6, C) of the cotangent rows: the trace,
    g_pq + sign g_qp above the diagonal, and (g_pp, g_pq + g_qp) — the
    cotangents of the compact rows per unit gate (sign -1; +1 gives the sums
    of |terms| for the error bound)."""
    diag = gm[:, _DIAG[0], _DIAG[1]]
    up, lo = gm[:, _UPPER[0], _UPPER[1]], gm[:, _UPPER[1], _UPPER[0]]
    t = diag[:, 0] + diag[:, 1] + diag[:, 2]
    return t, up + sign * lo, torch.cat([diag, up + lo], 1)


def _backward_terms(f, i_s, a_s, s_s, t, u, v):
    """Per edge: d f (E, C, 3) and the node rows' per-edge cotangents."""
    d_f = torch.stack([t * i_s, (u * a_s).sum(1), (v * s_s).sum(1)], -1)
    return d_f, f[:, :, 0] * t, f[:, None, :, 1] * u, f[:, None, :, 2] * v


def _src_sum(node, src, ct):
    """The per-edge cotangent rows ``ct`` summed onto ``node``'s rows at
    ``src``: half-precision rows accumulate in fp32 and round once (the JAX
    dispatcher's ``node_cts0`` carry), float32 rows as they are."""
    acc_dtype = torch.float32 if node.dtype in _HALF_DTYPES else node.dtype
    acc = torch.zeros(node.shape, dtype=acc_dtype, device=node.device)
    return acc.index_add(0, src, ct.to(acc_dtype)).to(node.dtype)


def tensornet_interaction_backward_reference(g, f, node_i, node_a, node_s, src,
                                             segment_ids, mask=None):
    """Plain version of the interaction's backward: from g (num_segments,
    3, 3, C), the cotangent of ``tensornet_interaction_aggregate_reference``,
    return (d f (E, C, 3), d i, d a, d s shaped as the node rows). With
    t, u, v the projections of g[dst] (``_projections``): d f = (t i,
    u . a, v . s) per edge (zero on masked edges), and d i, d a, d s the
    sums of f0 t, f1 u, f2 v onto the src rows. bfloat16 inputs take the
    JAX dispatcher's semantics: the per-edge terms in bf16 ops (the VJP of
    the bf16 message), the node-row sums in fp32, rounded once.
    Differentiable torch ops."""
    t, u, v = _projections(_g_rows(g, segment_ids, mask))
    d_f, ci, ca, cs = _backward_terms(f, node_i.index_select(0, src),
                                      node_a.index_select(0, src),
                                      node_s.index_select(0, src), t, u, v)
    return (d_f, _src_sum(node_i, src, ci), _src_sum(node_a, src, ca),
            _src_sum(node_s, src, cs))


def _full(x):
    """``x`` upcast to float32 when it is half precision, else as it is."""
    return x.float() if x is not None and x.dtype in _HALF_DTYPES else x


def _edge_counts(ids, n, mask, dtype):
    valid = ids.long() if mask is None else ids.long()[mask]
    return torch.bincount(valid, minlength=n)[:n].to(dtype)


BF16_UNIT = 2.0 ** -8  # a bf16 rounding: 8 significant bits, round to nearest


def _bf16_bound(e, y, r, t):
    """A float32 bound ``e`` on |kernel - plain| widened to bf16 data: the
    plain bf16 route rounds each term up to ``r`` times (each within
    ``BF16_UNIT`` of the |terms| ``t`` under it, first order) where the
    kernel holds it in fp32, and each side rounds its fp32 result once,
    so one bf16 ulp of the result more: ``e' + 2^-7 (|y| + e')`` with
    ``e' = e + r 2^-8 t`` and ``y`` the float32 value (two roundings of
    2^-8 each, as ``check_segment_sum`` in chip_smoke.py)."""
    e = e + r * BF16_UNIT * t
    return e + 2 * BF16_UNIT * (y.abs() + e)


def tensornet_embed_error_bound(zij, w1, w2, w3, a_e, s_e, segment_ids,
                                num_segments: int, mask=None):
    """Per output element, a bound on |kernel - plain| of the embed:
    2 (k + 3) u T in float32 (k the dst row's valid-edge count, u = 2^-24,
    T the plain version on |inputs|; each side within (k + 2) u T: a
    message entry is at most five roundings, the dst sum k - 1 more).
    bfloat16 inputs: the plain route rounds a message entry in bf16 up to
    five times (``W2 A``, the sum, ``W3 S``, the sum, the product with
    ``Z``), six with second-order slack; ``_bf16_bound``."""
    half = zij.dtype in _HALF_DTYPES
    xs = [x.float() for x in (zij, w1, w2, w3, a_e, s_e)]
    t = tensornet_embed_aggregate_reference(*(x.abs() for x in xs), segment_ids,
                                            num_segments, mask)
    k = _edge_counts(segment_ids, num_segments, mask, t.dtype)
    bound = 2 * (k + 3).reshape(-1, 1, 1, 1) * 2.0 ** -24 * t
    if not half:
        return bound
    y = tensornet_embed_aggregate_reference(*xs, segment_ids, num_segments, mask)
    return _bf16_bound(bound, y, 6, t)


def tensornet_interaction_error_bound(f, node_i, node_a, node_s, src, segment_ids,
                                      num_segments: int, mask=None):
    """Per output element, a bound on |kernel - plain| of the interaction:
    2 (k + 3) u T, with k the dst row's valid-edge count, u = 2^-24 and T
    the sum of |terms| (the plain version on |inputs|, its lower triangle
    taken from the upper, where the plain version subtracts). Each side is
    within (k + 2) u T: a message entry is two products and a sum, the dst
    sum k - 1 more roundings; the kernel sums the compact components and
    assembles the 3x3 once (one more). bfloat16 inputs: the plain route
    rounds those three in bf16, four with second-order slack;
    ``_bf16_bound``."""
    half = f.dtype in _HALF_DTYPES
    xs = [x.float() for x in (f, node_i, node_a, node_s)]
    t = tensornet_interaction_aggregate_reference(
        *(x.abs() for x in xs), src, segment_ids, num_segments, mask)
    t = torch.maximum(t, t.transpose(1, 2))
    k = _edge_counts(segment_ids, num_segments, mask, t.dtype)
    bound = 2 * (k + 3).reshape(-1, 1, 1, 1) * 2.0 ** -24 * t
    if not half:
        return bound
    y = tensornet_interaction_aggregate_reference(*xs, src, segment_ids, num_segments, mask)
    return _bf16_bound(bound, y, 4, t)


def tensornet_interaction_backward_error_bound(g, f, node_i, node_a, node_s, src,
                                               segment_ids, mask=None):
    """Per element of (d f, d i, d a, d s), a bound on |kernel - plain| of
    the interaction's backward, of the form 2 (k + 3) u T (u = 2^-24, T the
    same computation on |inputs| with every difference a sum): for d x, k
    is the src row's valid-edge count (a term is at most three roundings,
    the sum k - 1 more); for d f's three columns k = 1, 3, 6, the length of
    the dot product (at most 2, 4 and 7 roundings). bfloat16 inputs: the
    plain route rounds a term in bf16 before its fp32 sum up to three times
    (t's two sums and the product with f0 or i), four with second-order
    slack; ``_bf16_bound``."""
    half = g.dtype in _HALF_DTYPES
    g, f, node_i, node_a, node_s = (x.float() for x in (g, f, node_i, node_a, node_s))
    n_node = node_i.shape[0]
    t, u, v = _projections(_g_rows(g.abs(), segment_ids, mask), 1.0)
    d_f, ci, ca, cs = _backward_terms(f.abs(), node_i.abs().index_select(0, src),
                                      node_a.abs().index_select(0, src),
                                      node_s.abs().index_select(0, src), t, u, v)
    k = _edge_counts(src, n_node, mask, t.dtype)
    scale = 2 * 2.0 ** -24
    kf = torch.tensor([1.0, 3.0, 6.0], dtype=t.dtype, device=t.device)
    terms = (d_f, _src_sum(node_i, src, ci), _src_sum(node_a, src, ca),
             _src_sum(node_s, src, cs))
    bounds = (scale * (kf + 3) * terms[0], scale * (k + 3)[:, None] * terms[1],
              scale * (k + 3)[:, None, None] * terms[2],
              scale * (k + 3)[:, None, None] * terms[3])
    if not half:
        return bounds
    ys = tensornet_interaction_backward_reference(g, f, node_i, node_a, node_s, src,
                                                  segment_ids, mask)
    return tuple(_bf16_bound(b, y, 4, tt) for b, y, tt in zip(bounds, ys, terms))


def screen_masked_rows(mask, *rows):
    """Per-edge rows (E, ...) with the masked edges' rows zeroed, as the
    kernels never read them: no non-finite value of a masked edge enters a
    message's arithmetic (the CPU's bf16 matrix product at an odd width was
    seen to carry a NaN row into its neighbour's result). The plain
    versions here and the dispatcher's plain route take their rows through
    it; None stays None, and no mask leaves the rows as they are."""
    if mask is None:
        return rows
    return tuple(None if r is None else
                 torch.where(mask.reshape(mask.shape + (1,) * (r.ndim - 1)), r,
                             torch.zeros((), dtype=r.dtype, device=r.device))
                 for r in rows)


def chgnet_atom_conv_aggregate_reference(node_src, src, node_dst, dst, edge, abw,
                                         weights, segment_ids, num_segments: int,
                                         mask=None):
    msg = chgnet_atom_message(*screen_masked_rows(mask, node_src.index_select(0, src),
                                                  node_dst.index_select(0, dst), edge, abw),
                              weights=weights)
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


def chgnet_line_aggregate_reference(bond_src, line_src, bond_dst, line_dst, angle, node,
                                    center, weights, segment_ids, num_segments: int,
                                    mask=None):
    rows = screen_masked_rows(mask, bond_src.index_select(0, line_src),
                              bond_dst.index_select(0, line_dst), angle,
                              node.index_select(0, center))
    msg = chgnet_line_message(*rows, weights=weights)
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


def chgnet_message_terms(x, abw, weights):
    """Per message entry (E, C), the sensitivity-weighted sum of |terms| T
    of the gated MLP (one hidden layer: its 8 ``weights``) on the concat
    rows ``x`` (E, K1), times ``abw`` (E, C) when given, in ``x``'s dtype:
    a relative change of at most d at any one op of the message (a dot
    product, a bias, an activation, the gate product, the abw product)
    moves the entry by at most d T, first order.
    Layer by layer, per branch (core c, gate g): A1 = |x| |W1| + |b1|
    bounds the pre-activation's terms, TH = 1.1 A1 the hidden values and
    the effect of a layer-1 change (silu's slope is at most 1.1), T2 = TH
    |W2| + |b2| the same for layer 2; the outputs TOc = 1.1 T2c and TOg =
    0.25 T2g + |og| (sigmoid's slope is at most 0.25, its value at most
    1); the message T = |og| TOc + |oc| TOg. Along a branch a change at
    each of the three layer-1 ops moves z2 by at most d T2, at each of the
    two layer-2 ops too, so six ops move the branch's output by at most
    6 d TO; the gate product and the abw product add one each."""
    w1c, b1c, w2c, b2c, w1g, b1g, w2g, b2g = weights

    def t2(w1, b1, w2, b2):
        return (1.1 * (x.abs() @ w1.abs() + b1.abs())) @ w2.abs() + b2.abs()

    oc = F.silu(F.silu(x @ w1c + b1c) @ w2c + b2c)
    og = torch.sigmoid(F.silu(x @ w1g + b1g) @ w2g + b2g)
    t = (og.abs() * 1.1 * t2(w1c, b1c, w2c, b2c)
         + oc.abs() * (0.25 * t2(w1g, b1g, w2g, b2g) + og.abs()))
    return t if abw is None else t * abw.abs()


def chgnet_aggregate_error_bound(x, abw, weights, segment_ids, num_segments: int,
                                 mask=None):
    """Per output element, a bound on |kernel - plain| of a CHGNet
    aggregation, from the concat rows ``x`` (E, K1), ``abw`` (E, C) or
    None and the gated MLP's 8 ``weights``: the tolerance the kernels are
    held to (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

    Each of the two float32 computations is within B of the exact value;
    first order, with u = 2^-24: a dot product of length K plus its bias is
    within (K + 2) u of its sum of |terms| (any summation order); ``silu``
    and ``sigmoid`` have slopes of at most 1.1 and 0.25 and add 4 u of
    their value; a product adds 2 u; the dst sum of k messages adds
    k u sum|m|. So B = sum_e dm_e + k u sum_e |m_e|, propagated layer by
    layer below, and |kernel - plain| <= 2 B.

    bfloat16 data (``x`` in bf16; the weights in bf16 or float32): the
    kernel keeps the float32 computation on the same values; the plain
    route rounds a message entry to bf16 after each of its ops, along the
    core or the gate branch the layer-1 dot, its bias, silu, the layer-2
    dot, its bias, silu or sigmoid, then the gate product and the abw
    product: r = 8 roundings (7 without abw), one more for second-order
    slack, each within 2^-8 of T (``chgnet_message_terms``) summed over
    the row's valid edges; then one bf16 ulp of the result on each side
    (``_bf16_bound``)."""
    half_data = x.dtype in _HALF_DTYPES
    x, abw = _full(x), _full(abw)
    weights = [_full(w) for w in weights]
    u = 2.0 ** -24
    k1 = x.shape[1]
    ax = x.abs()

    def half(w1, b1, w2, b2):
        dz1 = (k1 + 2) * u * (ax @ w1.abs() + b1.abs())
        h = torch.nn.functional.silu(x @ w1 + b1)
        dh = 1.1 * dz1 + 4 * u * h.abs()
        dz2 = dh @ w2.abs() + (w2.shape[0] + 2) * u * (h.abs() @ w2.abs() + b2.abs())
        return h @ w2 + b2, dz2

    zc, dzc = half(*weights[:4])
    zg, dzg = half(*weights[4:])
    oc, og = torch.nn.functional.silu(zc), torch.sigmoid(zg)
    doc = 1.1 * dzc + 4 * u * oc.abs()
    dog = 0.25 * dzg + 4 * u * og.abs()
    m = oc * og
    dm = og.abs() * doc + oc.abs() * dog + doc * dog + 2 * u * m.abs()
    if abw is not None:
        m = m * abw
        dm = dm * abw.abs() + 2 * u * m.abs()
    valid = segment_ids if mask is None else segment_ids[mask]
    k = torch.bincount(valid.long(), minlength=num_segments)[:num_segments]
    b = (masked_segment_sum(dm, segment_ids, num_segments, mask)
         + (k[:, None] + 1).to(m.dtype) * u
         * masked_segment_sum(m.abs(), segment_ids, num_segments, mask))
    if not half_data:
        return 2 * b
    y = masked_segment_sum(m, segment_ids, num_segments, mask)
    t = masked_segment_sum(chgnet_message_terms(x, abw, weights), segment_ids,
                           num_segments, mask)
    return _bf16_bound(2 * b, y, (8 if abw is not None else 7) + 1, t)


# the absolute error of tanh.approx.f32 over its whole range, as the PTX ISA
# gives it, by which the bf16 per-edge kernels take silu and sigmoid
TANH_ERR = 2.0 ** -10.987


def _mma_unit(k: int) -> float:
    """A tensor-core layer's relative error bound on its sum of |terms|, k
    the contraction length, as ``chgnet_projection_error_bound`` counts it:
    (36 ceil(k / 16) + k + 2) u, each mma instruction's 17 addends aligned
    and truncated and its sum truncated (36 u an instruction), plus a
    float32 dot product of length k and a bias add."""
    return (36 * -(-k // 16) + k + 2) * 2.0 ** -24


def chgnet_tensor_core_error_bound(x, abw, weights, segment_ids, num_segments: int,
                                   mask=None):
    """Per output element, a bound on |bf16 tensor-core kernel - float32
    kernel| of a CHGNet aggregation at bf16 data, the float32 kernel run on
    the upcast inputs and the same float32 tables: ``x`` (E, K1) the concat
    rows, ``abw`` (E, C) or None, the gated MLP's 8 ``weights`` (bf16 or
    their float32 upcast). The sum of, propagated layer by layer as
    ``chgnet_aggregate_error_bound`` propagates its terms (silu's slope at
    most 1.1, sigmoid's 0.25):

    - the float32 kernel's own bound, 2 b (``chgnet_aggregate_error_bound``
      in float32), which covers both sides' float32 roundings;
    - each tensor-core layer's truncating k16 accumulation on its sum of
      |terms| (``_mma_unit``: layer 1 over the edge segment, k = C, on
      ``|x| |W1| + |b1|``; layer 2, k = H, on ``|h| |W2| + |b2|``);
    - the hidden's one rounding to bf16, 2^-8 |h| carried through |W2|;
    - the approximated activations: the kernel takes sigmoid(z) as 1/2 +
      tanh(z / 2) / 2 and silu(z) as h + h tanh(h), h = z / 2, with
      tanh.approx.f32 (absolute error at most ``TANH_ERR``, 2^-10.987), so
      sigmoid is off by at most TANH_ERR / 2 and silu by TANH_ERR |z| / 2,
      at both layers;
    - one bf16 ulp of each output (``_bf16_bound`` with no bf16 rounding of
      the terms: e + 2^-7 (|y| + e)).

    The hidden and activation terms are at most about 1.5 x 2^-8 of
    ``chgnet_message_terms``, so the bar stays well inside the bf16 form of
    ``chgnet_aggregate_error_bound`` (8 or 9 such roundings), which the
    kernel is also held to against the plain bf16 route."""
    x, abw = _full(x), _full(abw)
    weights = [_full(w) for w in weights]
    channels, hidden = weights[2].shape[1], weights[0].shape[1]
    ax = x.abs()

    def branch(w1, b1, w2, b2):
        dz1 = _mma_unit(channels) * (ax @ w1.abs() + b1.abs())
        z1 = x @ w1 + b1
        h = F.silu(z1)
        dh = 1.1 * dz1 + TANH_ERR / 2 * (z1.abs() + dz1)
        dh = dh + BF16_UNIT * (h.abs() + dh)
        dz2 = dh @ w2.abs() + _mma_unit(hidden) * ((h.abs() + dh) @ w2.abs() + b2.abs())
        return h @ w2 + b2, dz2

    zc, dzc = branch(*weights[:4])
    zg, dzg = branch(*weights[4:])
    oc, og = F.silu(zc), torch.sigmoid(zg)
    doc = 1.1 * dzc + TANH_ERR / 2 * (zc.abs() + dzc)
    dog = 0.25 * dzg + TANH_ERR / 2
    m = oc * og
    dm = og.abs() * doc + oc.abs() * dog + doc * dog
    if abw is not None:
        m, dm = m * abw, dm * abw.abs()
    e = (chgnet_aggregate_error_bound(x, abw, weights, segment_ids, num_segments, mask)
         + masked_segment_sum(dm, segment_ids, num_segments, mask))
    return _bf16_bound(e, masked_segment_sum(m, segment_ids, num_segments, mask), 0, 0.0)


# ---------------------------------------------------------------------------
# the layer-1 split of the CHGNet kernels (plain torch: the wrappers and the
# CPU tests run the same packing and table plan)
# ---------------------------------------------------------------------------

CHGNET_MAX_WIDTH = 64  # C and H the CHGNet kernels take


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ChgnetPacked(NamedTuple):
    """The gated MLP as the CHGNet kernels read it (see
    ``chgnet_pack_weights``)."""

    blocks: list   # per gathered segment: its (C, 2 hp) layer-1 block
    b1: torch.Tensor   # (2 hp,)
    w1e: torch.Tensor  # the edge segment's layer-1 block (cp, 2 hp); bf16: (2 h16, c16) W1e^T
    w2: torch.Tensor   # (hp, 2 cp); bf16: (2 c8, h16) W2^T
    b2: torch.Tensor   # (2 cp,)


def chgnet_pack_weights(weights, n_seg: int, edge_seg: int, channels: int) -> ChgnetPacked:
    """Pack the gated MLP's 8 tensors (one hidden layer; w1 (n_seg C, H))
    for the CHGNet kernels. Layer 1 is linear, so it splits over the concat
    row's ``n_seg`` segments of C: ``[x_0 | x_1 | ...] W1 = sum_s x_s
    W1[sC:(s+1)C]``. With hp and cp the hidden width and C rounded up to 4
    and zero padding, core and gate side by side:

    - ``blocks``: per segment but ``edge_seg``, in order, ``[W1c_s | 0 |
      W1g_s | 0]`` (C, 2 hp), the row projection's weights;
    - ``b1``: ``[b1c | 0 | b1g | 0]`` (2 hp,), folded into the first
      gathered segment's table;
    - ``w1e``: the edge segment's block (cp, 2 hp), rows past C zero;
    - ``w2``: ``[W2c | 0 | W2g | 0]`` (hp, 2 cp), rows past H zero;
    - ``b2``: ``[b2c | 0 | b2g | 0]`` (2 cp,).

    bfloat16 weights give as ``w1e`` and ``w2`` the bf16 per-edge kernels'
    tensor-core operands instead, with c16 and h16 the widths rounded up to
    whole k16 steps and c8 C rounded up to 8, zero padding:

    - ``w1e``: the edge segment's block transposed, ``[W1c_e^T ; W1g_e^T]``
      (2 h16, c16): hidden units (core, then gate) by input channels;
    - ``w2``: ``[W2c^T ; W2g^T]`` (2 c8, h16): output channels (core, then
      gate) by hidden units.

    Plain torch ops on the weights' device; every result is contiguous and
    float32, except that bfloat16 weights keep ``blocks`` in bfloat16, the
    operand of the bf16 row projection's tensor-core products, and give
    ``w1e`` and ``w2`` in bfloat16 (the same values; the biases upcast,
    which is exact); float64 weights stay float64."""
    w1c, b1c, w2c, b2c, w1g, b1g, w2g, b2g = (_full(w) for w in weights)
    c, h = channels, w1c.shape[1]
    cp, hp = _round_up(c, 4), _round_up(h, 4)

    def pad(t, cols, rows=None):  # zeros up to (rows, cols); no copy when none are needed
        extra = (0, cols - t.shape[-1]) + (() if rows is None else (0, rows - t.shape[0]))
        return F.pad(t, extra) if any(extra) else t

    def side_by_side(core, gate, width):
        return torch.cat([pad(core, width), pad(gate, width)], -1)

    blocks = [side_by_side(w1c[s * c:(s + 1) * c], w1g[s * c:(s + 1) * c], hp)
              for s in range(n_seg)]
    half = weights[0].dtype == torch.bfloat16
    rows_dtype = torch.bfloat16 if half else w1c.dtype
    if half:
        c16, h16, c8 = _round_up(c, 16), _round_up(h, 16), _round_up(c, 8)
        edge = slice(edge_seg * c, (edge_seg + 1) * c)
        w1e = torch.cat([pad(w1c[edge].t(), c16, h16), pad(w1g[edge].t(), c16, h16)])
        w2 = torch.cat([pad(w2c.t(), h16, c8), pad(w2g.t(), h16, c8)])
        w1e, w2 = w1e.to(torch.bfloat16).contiguous(), w2.to(torch.bfloat16).contiguous()
    else:
        w1e = pad(blocks[edge_seg], 2 * hp, cp)
        w2 = pad(side_by_side(w2c, w2g, cp), 2 * cp, hp)
    return ChgnetPacked(
        blocks=[b.to(rows_dtype) for s, b in enumerate(blocks) if s != edge_seg],
        b1=side_by_side(b1c, b1g, hp), w1e=w1e, w2=w2, b2=side_by_side(b2c, b2g, cp))


def chgnet_row_tables(nodes, packed: ChgnetPacked, project):
    """The gathered segments' layer-1 partial rows, taken once per node or
    bond row: per segment ``s``, ``(table, offset)`` with ``table[r, offset
    : offset + 2 hp] = nodes[s][r] @ packed.blocks[s]``, plus ``packed.b1``
    for segment 0. Segments that gather the same tensor share one pass with
    their blocks side by side (the atom conv's v at src and dst, the line
    conv's b at both ends). ``project(x, w, bias)`` is
    ``chgnet_row_projection_cuda`` or ``chgnet_row_projection_reference``."""
    w1s = packed.b1.shape[0]
    tables = [None] * len(nodes)
    for s, node in enumerate(nodes):
        if tables[s] is not None:
            continue
        segs = [t for t in range(s, len(nodes)) if nodes[t] is node]
        w = (packed.blocks[s] if len(segs) == 1
             else torch.cat([packed.blocks[t] for t in segs], -1))
        bias = F.pad(packed.b1, (0, w1s * (len(segs) - 1))) if s == 0 else None
        table = project(node, w, bias)
        for j, t in enumerate(segs):
            tables[t] = (table, j * w1s)
    return tables


def chgnet_row_projection_reference(x, w, bias=None):
    """Plain version of the row projection: ``x @ w (+ bias)``; a bfloat16
    ``x`` (and ``w``, ``bias``) is upcast to float32 first, so the product
    is the float32 one of the same values and the table keeps one float32
    rounding."""
    y = _full(x) @ _full(w)
    return y if bias is None else y + _full(bias)


def chgnet_projection_error_bound(x, w, bias=None):
    """Per element, a bound on |kernel - plain| of the row projection, with
    u = 2^-24 and T the sum of |terms| (``|x| @ |w| + |bias|``).

    float32 ``x``: each side's dot product of length K plus its bias is
    within (K + 2) u T of the exact value (any summation order), so
    ``2 (K + 2) u T``.

    bfloat16 ``x`` (and ``w``): the kernel takes the products on the tensor
    cores, one mma instruction per 16 entries; bf16 products are exact in
    fp32, and the bound does not assume round to nearest: each
    instruction's 17 addends (16 products and the accumulator) may be
    aligned to the largest and truncated, and its sum truncated, each
    losing less than one ulp (2u of a magnitude of at most T): 36 u T an
    instruction. The bias add rounds once more. The plain side's float32
    dot product is within K u T, its bias add u T. So
    ``(36 ceil(K / 16) + K + 2) u T``; both sides write float32, so no
    bf16 rounding lies between them."""
    half = x.dtype in _HALF_DTYPES
    x, w = _full(x), _full(w)
    k = x.shape[1]
    t = x.abs() @ w.abs()
    if bias is not None:
        t = t + _full(bias).abs()
    if half:
        return (36 * -(-k // 16) + k + 2) * 2.0 ** -24 * t
    return 2 * (k + 2) * 2.0 ** -24 * t


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_fns: dict = {}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_TABLE = [_P, _I64, _P]  # partial rows, row stride, gather ids
_TAIL = [_I64, _I64, _I, _I, _P]  # n_rows, n_edges, C, H, stream
_CHGNET_ARGTYPES = {
    "distmlip_chgnet_aggregate_bf16_plan": [_I, _I, _I64, _I64, _P],
    "distmlip_chgnet_row_projection_plan": [_I64, _I, _I, _P],
    "distmlip_chgnet_row_projection_bf16_plan": [_I64, _I, _I, _P],
}
for _suffix in ("_f32", "_bf16"):
    _CHGNET_ARGTYPES.update({
        "distmlip_chgnet_row_projection" + _suffix: [_P, _I64, _I, _P, _I, _P, _P, _P],
        "distmlip_chgnet_atom_conv" + _suffix: _TABLE * 2 + [_P] * 9 + _TAIL,
        "distmlip_chgnet_line_conv" + _suffix: _TABLE * 2 + [_P] + _TABLE + [_P] * 7 + _TAIL,
    })


def _fn(symbol: str, n_ptr: int):
    fn = _fns.get(symbol)
    if fn is None:
        from .build import load

        fn = getattr(load("edge_aggregate"), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        _fns[symbol] = fn
    return fn


def _require_cuda(name, x, ndim):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors; use the *_reference "
                         "version for tensors on the CPU")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got {x.ndim}-d")


def _check(name, x, shape, device, dtype=torch.float32):
    """``x`` a contiguous CUDA tensor of ``shape`` on ``device`` in
    ``dtype``, the call's one float dtype: a mix raises, nothing is cast."""
    _require_cuda(name, x, len(shape))
    if x.dtype != dtype:
        raise TypeError(f"{name}: every float input of the call must be {dtype} "
                        f"(one dtype a call), got {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} tensor on "
                         f"{device}, got {tuple(x.shape)} on {x.device}")


def _check_index(name, what, x, e, device, dtypes=(torch.int32, torch.int64)):
    if x.ndim != 1 or x.shape[0] != e or x.dtype not in dtypes or x.device != device:
        raise ValueError(f"{name}: {what} must be ({e},) "
                         f"{'/'.join(str(d) for d in dtypes)} on {device}")


# the kernels by float dtype: the C symbol's suffix and the launch count's
_DTYPES = {torch.float32: ("_f32", ""), torch.bfloat16: ("_bf16", BF16)}


def _call_dtype(name, x):
    """The call's float dtype, from its first float tensor: float32 or
    bfloat16."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _launch(name, symbol, out, tensors, row_ptr, mask, channels):
    symbol_suffix, count_suffix = _DTYPES[out.dtype]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    err = _fn(symbol + symbol_suffix, len(ptrs) + 3)(
        *ptrs, row_ptr.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), out.shape[0], channels, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    count_launch(name + count_suffix)
    return out


def _ids_and_mask(name, segment_ids, mask, e, device):
    _check_index(name, "segment_ids", segment_ids, e, device)
    if mask is not None:
        _check_index(name, "mask", mask, e, device, (torch.bool,))
        mask = mask.contiguous()
    return mask


def tensornet_embed_aggregate_cuda(zij, w1, w2, w3, a_e, s_e, segment_ids,
                                   num_segments: int, mask=None):
    """Launch the embed kernel: ``zij, w1, w2, w3`` (E, C) and ``a_e, s_e``
    (E, 3, 3, 1), contiguous, all float32 or all bfloat16; ``segment_ids``
    (E,) nondecreasing (not checked: it would cost a device sync); ``mask``
    (E,) bool or None. Returns (num_segments, 3, 3, C) in the inputs'
    dtype, accumulated in float32."""
    name = EMBED
    _require_cuda(name, zij, 2)
    e, channels = zij.shape
    dev, dtype = zij.device, _call_dtype(name, zij)
    for x in (zij, w1, w2, w3):
        _check(name, x, (e, channels), dev, dtype)
    for x in (a_e, s_e):
        _check(name, x, (e, 3, 3, 1), dev, dtype)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    num_segments = int(num_segments)
    out = torch.empty((num_segments, 3, 3, channels), dtype=dtype, device=dev)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        return _launch(name, "distmlip_tensornet_embed", out,
                       (zij, w1, w2, w3, a_e, s_e), row_ptr, mask, channels)


def _check_compact(name, node_i, node_a, node_s, channels, device, dtype):
    """The compact node rows (N, C), (N, 3, C), (N, 6, C); returns N."""
    _require_cuda(name, node_i, 2)
    n_node = node_i.shape[0]
    _check(name, node_i, (n_node, channels), device, dtype)
    _check(name, node_a, (n_node, 3, channels), device, dtype)
    _check(name, node_s, (n_node, 6, channels), device, dtype)
    if n_node >= 2 ** 31:
        raise ValueError(f"{name}: {n_node} node rows exceed int32 src ids")
    return n_node


def tensornet_interaction_aggregate_cuda(f, node_i, node_a, node_s, src,
                                         segment_ids, num_segments: int,
                                         mask=None):
    """Launch the interaction kernel: ``f`` (E, C, 3) and the compact node
    rows ``node_i`` (N_node, C), ``node_a`` (N_node, 3, C), ``node_s``
    (N_node, 6, C), contiguous, all float32 or all bfloat16; ``src`` (E,)
    int32/int64 row ids into the node rows (in range on every valid edge);
    ``segment_ids`` (E,) nondecreasing; ``mask`` (E,) bool or None. Returns
    (num_segments, 3, 3, C) in the inputs' dtype, accumulated in float32."""
    name = INTERACTION
    _require_cuda(name, f, 3)
    e, channels = f.shape[0], f.shape[1]
    dev, dtype = f.device, _call_dtype(name, f)
    _check(name, f, (e, channels, 3), dev, dtype)
    _check_compact(name, node_i, node_a, node_s, channels, dev, dtype)
    _check_index(name, "src", src, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    num_segments = int(num_segments)
    out = torch.empty((num_segments, 3, 3, channels), dtype=dtype, device=dev)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        src32 = src.to(torch.int32).contiguous()
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        return _launch(name, "distmlip_tensornet_interaction", out,
                       (f, node_i, node_a, node_s, src32), row_ptr, mask, channels)


def src_order(src, n_node: int, mask=None):
    """The valid edges in src order, on the ids' device with no host sync:
    (perm (E,) int64, row_ptr (n_node + 1,) int64). One stable sort of the
    src ids with the masked edges keyed past the last row, so edges of one
    src row keep their edge order and the masked ones come last, from
    ``row_ptr[n_node]`` on."""
    key = src if mask is None else torch.where(mask, src, n_node)
    keys, perm = torch.sort(key, stable=True)
    return perm, csr_row_offsets(keys, n_node)


def tensornet_interaction_backward_cuda(g, f, node_i, node_a, node_s, src,
                                        segment_ids, mask=None):
    """Launch the interaction's backward kernel: ``g`` (num_segments, 3, 3,
    C), the cotangent of the forward's output; the forward's ``f``, compact
    node rows, ``src``, ``segment_ids`` and ``mask`` as
    ``tensornet_interaction_aggregate_cuda`` takes them. Contiguous, all
    float32 or all bfloat16. Returns (d f (E, C, 3), d i, d a, d s shaped
    as the node rows) in the inputs' dtype, with the edges ordered by
    ``src_order``; each d f entry and each src row's sum computed in float32
    and rounded once."""
    name = INTERACTION_BWD
    _require_cuda(name, f, 3)
    e, channels = f.shape[0], f.shape[1]
    dev, dtype = f.device, _call_dtype(name, f)
    _check(name, f, (e, channels, 3), dev, dtype)
    n_node = _check_compact(name, node_i, node_a, node_s, channels, dev, dtype)
    _require_cuda(name, g, 4)
    _check(name, g, (g.shape[0], 3, 3, channels), dev, dtype)
    _check_index(name, "src", src, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    if e >= 2 ** 31:
        raise ValueError(f"{name}: {e} edges exceed the kernel's int32 dst ids")
    out = [torch.empty_like(x) for x in (f, node_i, node_a, node_s)]
    if e == 0 or n_node == 0 or channels == 0:
        return tuple(x.zero_() for x in out)
    with torch.cuda.device(dev):
        perm, row_ptr = src_order(src, n_node, mask)
        dst32 = segment_ids.to(torch.int32).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        symbol_suffix, count_suffix = _DTYPES[dtype]
        err = _interaction_bwd_fn(symbol_suffix)(
            g.data_ptr(), f.data_ptr(), node_i.data_ptr(), node_a.data_ptr(),
            node_s.data_ptr(), perm.data_ptr(), dst32.data_ptr(), row_ptr.data_ptr(),
            *(x.data_ptr() for x in out), n_node, e, channels, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    count_launch(name + count_suffix)
    return tuple(out)


def _interaction_bwd_fn(suffix):
    symbol = "distmlip_tensornet_interaction_bwd" + suffix
    fn = _fns.get(symbol)
    if fn is None:
        from .build import load

        fn = getattr(load("edge_aggregate"), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 12 + [_I64, _I64, _I, _P]
        _fns[symbol] = fn
    return fn


def tensornet_interaction_backward_bf16_plan(g, f, node_i, node_a, node_s):
    """The plan ``tensornet_interaction_backward_cuda`` takes for bf16
    inputs on the card (its outputs allocated fresh, as the wrapper does),
    from the kernel library's own routing (the launch's): channels a lane
    (2 where C is even and every array 4-byte aligned, else 1), channels a
    warp, warps a src row, edges in flight a warp, edge indices loaded a
    warp turn, warps a block and the kernel's registers a thread."""
    if not (f.is_cuda and f.dtype == torch.bfloat16):
        raise ValueError("tensornet_interaction_backward_bf16_plan takes bf16 CUDA tensors")
    from .build import load

    fn = load("edge_aggregate").distmlip_tensornet_interaction_bwd_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 9 + [_I, _P]
    plan = (ctypes.c_int64 * 7)()
    err = fn(*(x.data_ptr() for x in (g, f, node_i, node_a, node_s)), None, None, None, None,
             f.shape[1], plan)
    if err != 0:
        raise RuntimeError(f"tensornet_interaction_backward_bf16_plan failed: "
                           f"cudaError_t {err}")
    keys = ("channels_a_lane", "channels_a_warp", "warps_a_row", "edges_in_flight",
            "indices_a_turn", "warps_a_block", "registers")
    out = dict(zip(keys, plan))
    out["path"] = "channel pairs" if out["channels_a_lane"] == 2 else "single channels"
    return out


_FWD_PLAN_KEYS = ("channels_a_lane", "channels_a_warp", "warps_a_row", "edges_in_flight",
                  "indices_a_turn", "warps_a_block", "registers", "blocks", "shared_bytes")


def _forward_bf16_plan(name, symbol, arrays, num_segments):
    """The plan of a bf16 forward's launch from the kernel library's route
    for ``arrays`` (the four the lanes index by channel; the output a fresh
    allocation, aligned) and ``num_segments`` dst rows."""
    x = arrays[0]
    if not (isinstance(x, torch.Tensor) and x.is_cuda and x.dtype == torch.bfloat16):
        raise ValueError(f"{name} takes bf16 CUDA tensors")
    from .build import load

    fn = getattr(load("edge_aggregate"), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 5 + [_I64, _I, _P]
    plan = (ctypes.c_int64 * len(_FWD_PLAN_KEYS))()
    err = fn(*(a.data_ptr() for a in arrays), None, max(int(num_segments), 1), x.shape[1],
             plan)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
    out = dict(zip(_FWD_PLAN_KEYS, plan))
    out["path"] = "channel pairs" if out["channels_a_lane"] == 2 else "single channels"
    return out


def tensornet_embed_bf16_plan(zij, w1, w2, w3, num_segments: int = 1):
    """The plan ``tensornet_embed_aggregate_cuda`` takes for bf16 inputs on
    the card (its output allocated fresh, as the wrapper does), from the
    kernel library's own routing (the launch's): channels a lane (2 where C
    is even and Z, W1, W2, W3 are 4-byte aligned, else 1), channels a warp,
    warps a dst row, edges in flight a warp, edge indices loaded a warp
    turn, warps a block, the kernel's registers a thread, blocks for
    ``num_segments`` dst rows and the static shared bytes a block (the
    staged geometric scalars)."""
    return _forward_bf16_plan("tensornet_embed_bf16_plan", "distmlip_tensornet_embed_bf16_plan",
                              (zij, w1, w2, w3), num_segments)


def tensornet_interaction_bf16_plan(f, node_i, node_a, node_s, num_segments: int = 1):
    """The plan ``tensornet_interaction_aggregate_cuda`` takes for bf16
    inputs on the card, as ``tensornet_embed_bf16_plan`` reports it: channel
    pairs where C is even and f and the compact node rows are 4-byte
    aligned, else single channels; no shared memory."""
    return _forward_bf16_plan("tensornet_interaction_bf16_plan",
                              "distmlip_tensornet_interaction_bf16_plan",
                              (f, node_i, node_a, node_s), num_segments)


def _check_gated_weights(name, weights, k1, channels, device, dtype=torch.float32):
    """The gated MLP's 8 tensors with one hidden layer: w1 (K1, H), b1 (H),
    w2 (H, C), b2 (C), for the core and then the gate, in the call's
    ``dtype``. Returns H."""
    if len(weights) != 8:
        raise ValueError(f"{name}: the kernel takes a gated MLP with exactly one "
                         f"hidden layer (8 tensors), got {len(weights)} tensors")
    hidden = weights[0].shape[1] if weights[0].ndim == 2 else 0
    for half in (0, 4):
        w1, b1, w2, b2 = weights[half:half + 4]
        _check(name, w1, (k1, hidden), device, dtype)
        _check(name, b1, (hidden,), device, dtype)
        _check(name, w2, (hidden, channels), device, dtype)
        _check(name, b2, (channels,), device, dtype)
    return hidden


def _index32(name, what, idx, e, device):
    _check_index(name, what, idx, e, device)
    return idx.to(torch.int32).contiguous()


def _chgnet_fn(symbol: str):
    """A function of ``csrc/chgnet_aggregate.cu`` with its argument types."""
    fn = _fns.get(symbol)
    if fn is None:
        from .build import load

        fn = getattr(load("chgnet_aggregate"), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = _CHGNET_ARGTYPES[symbol]
        _fns[symbol] = fn
    return fn


PROJECTION_MAX_K = 64    # the row projection's W panel is resident in shared
PROJECTION_MAX_M = 256   # memory: 64 KB at 64 x 256 in float32, 36 KB in bf16


def _projection_shape_error(name, k, m):
    return ValueError(f"{name}: takes 1 <= K <= {PROJECTION_MAX_K} and M a multiple of 4 "
                      f"up to {PROJECTION_MAX_M} (W resident in shared memory), got K={k}, "
                      f"M={m}")


def chgnet_row_projection_cuda(x, w, bias=None):
    """Launch the row projection kernel: ``x`` (R, K) float32 or bfloat16,
    ``w`` (K, M) in ``x``'s dtype (the packed blocks,
    ``chgnet_pack_weights``) with 1 <= K <= 64 and M a multiple of 4 up to
    256, ``bias`` (M,) float32 or None, contiguous on one card, ``w`` and
    ``bias`` 16-byte aligned. Returns (R, M) float32 ``x @ w (+ bias)``:
    float32 FMAs for float32 ``x``; for bf16 ``x`` the bf16 products on the
    tensor cores, accumulated in fp32 (launch count ``*_bf16``, its own
    bar in ``chgnet_projection_error_bound``). The launch chooses its plan
    (``chgnet_projection_plan``). Raises ``TypeError`` for a ``w`` of
    another dtype than ``x`` or a bias that is not float32 (nothing is
    rounded quietly), ``ValueError`` for a shape past the kernel's shared
    memory."""
    name = PROJECTION
    _require_cuda(name, x, 2)
    rows, k = x.shape
    dev, dtype = x.device, _call_dtype(name, x)
    _check(name, x, (rows, k), dev, dtype)
    _require_cuda(name, w, 2)
    m = w.shape[1]
    if w.dtype != dtype:
        raise TypeError(f"{name}: w must be the packed blocks in x's dtype {dtype}, got "
                        f"{w.dtype}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"{name}: the bias is the packed float32 b1, got {bias.dtype}")
    _check(name, w, (k, m), dev, dtype)
    if bias is not None:
        _check(name, bias, (m,), dev)
    if not (1 <= k <= PROJECTION_MAX_K and 4 <= m <= PROJECTION_MAX_M and m % 4 == 0):
        raise _projection_shape_error(name, k, m)
    b_ptr = 0 if bias is None else bias.data_ptr()
    if w.data_ptr() % 16 or b_ptr % 16:
        raise ValueError(f"{name}: w and bias must be 16-byte aligned")
    y = torch.empty((rows, m), dtype=torch.float32, device=dev)
    if rows == 0:
        return y
    args = (x.data_ptr(), rows, k, w.data_ptr(), m, b_ptr or None, y.data_ptr(),
            current_stream_ptr(dev))
    symbol_suffix, count_suffix = _DTYPES[dtype]
    fn = _chgnet_fn("distmlip_chgnet_row_projection" + symbol_suffix)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    count_launch(name + count_suffix)
    return y


def chgnet_projection_plan(rows: int, k: int, m: int, device=None, dtype=torch.float32):
    """The row projection's launch plan at (rows, K, M) on ``device`` (a
    card), the persistent grid walking ``tiles`` row tiles with ``blocks``
    blocks. float32: ``{"tile_rows", "tiles", "blocks",
    "rows_per_thread"}``, the tile height (5 or 8 rows a thread) following
    from the row count. bfloat16 (the tensor-core kernel): ``{"tile_rows",
    "tiles", "blocks", "k16_steps", "block_columns"}`` and
    ``"l2_bytes"``, what the call brings from L2 (or HBM) into shared
    memory: every x row once (2 K bytes) and W (K M bf16) and the bias
    once a block."""
    if not (1 <= k <= PROJECTION_MAX_K and 4 <= m <= PROJECTION_MAX_M and m % 4 == 0):
        raise _projection_shape_error(PROJECTION, k, m)
    half = dtype == torch.bfloat16
    keys = (("tile_rows", "tiles", "blocks", "k16_steps", "block_columns") if half
            else ("tile_rows", "tiles", "blocks", "rows_per_thread"))
    out = (ctypes.c_int64 * len(keys))()
    symbol = ("distmlip_chgnet_row_projection_bf16_plan" if half
              else "distmlip_chgnet_row_projection_plan")
    with torch.cuda.device(device):
        err = _chgnet_fn(symbol)(rows, k, m, out)
    if err != 0:
        raise RuntimeError(f"{PROJECTION} plan failed: cudaError_t {err}")
    plan = dict(zip(keys, out))
    if half:
        plan["l2_bytes"] = 2 * rows * k + plan["blocks"] * (2 * k * m + 4 * m)
    return plan


def chgnet_aggregate_plan(channels: int, hidden: int, n_rows: int, n_edges: int,
                          device=None):
    """The bf16 per-edge kernels' launch plan at (C, H) over ``n_rows`` dst
    rows and ``n_edges`` edges on ``device`` (a card): ``{"warps",
    "blocks", "smem_bytes"}``, warps a block (as many as one block's shared
    memory holds, at most 8), blocks (one an SM, fewer for small inputs)
    and shared bytes a block."""
    out = (ctypes.c_int64 * 3)()
    with torch.cuda.device(device):
        err = _chgnet_fn("distmlip_chgnet_aggregate_bf16_plan")(channels, hidden, n_rows,
                                                                n_edges, out)
    if err != 0:
        raise RuntimeError(f"chgnet bf16 plan failed: cudaError_t {err}")
    return dict(zip(("warps", "blocks", "smem_bytes"), out))


def _launch_chgnet(name, symbol, edge_seg, gathered, edge, extra, weights, segment_ids,
                   num_segments, mask, channels, hidden, device):
    """Project the gathered segments' rows (``gathered``: (node rows, int32
    ids) per gathered segment, in segment order) into float32 tables with
    this module's ``chgnet_row_projection_cuda``, looked up at call time
    (the card checks put another projection in its place to give a float32
    call the bf16 call's tables), then launch the per-edge kernel
    of ``edge``'s dtype with the tables, the edge rows at ``edge_seg`` and
    ``extra`` (abw) after the segments (bf16: the tensor-core kernel, with
    the packed transposes as ``w1e`` and ``w2``); the output in that dtype."""
    e = segment_ids.shape[0]
    symbol_suffix, count_suffix = _DTYPES[edge.dtype]
    out = torch.empty((num_segments, channels), dtype=edge.dtype, device=device)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    if e >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {e} edges exceed the kernel's int32 edge ids")
    if channels > CHGNET_MAX_WIDTH or not 1 <= hidden <= CHGNET_MAX_WIDTH:
        raise ValueError(f"{name}: C={channels}, H={hidden} is too wide: the kernels take C "
                         f"and H from 1 to {CHGNET_MAX_WIDTH}, with W1's edge block and "
                         "[W2c | W2g] in one block's shared memory")
    with torch.cuda.device(device):
        packed = chgnet_pack_weights(weights, len(gathered) + 1, edge_seg, channels)
        tables = chgnet_row_tables([node for node, _ in gathered], packed,
                                   chgnet_row_projection_cuda)
        ptrs, it = [], iter(zip(tables, gathered))
        for s in range(len(gathered) + 1):
            if s == edge_seg:
                ptrs.append(edge.data_ptr())
                continue
            (table, offset), (_, idx) = next(it)
            ptrs += [table.data_ptr() + 4 * offset, table.shape[1], idx.data_ptr()]
        ids32 = segment_ids.to(torch.int32).contiguous()
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _chgnet_fn(symbol + symbol_suffix)(
            *ptrs, *extra, packed.w1e.data_ptr(), packed.w2.data_ptr(), packed.b2.data_ptr(),
            row_ptr.data_ptr(), ids32.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), num_segments, e, channels, hidden, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    count_launch(name + count_suffix)
    return out


def chgnet_atom_conv_aggregate_cuda(node_src, src, node_dst, dst, edge, abw, weights,
                                    segment_ids, num_segments: int, mask=None):
    """Launch the atom-conv kernels: ``node_src``, ``node_dst`` (N, C)
    gathered at ``src``, ``dst`` (E,) int32/int64; ``edge`` (E, C);
    ``abw`` (E, C) or None; ``weights`` the gated MLP's 8 tensors with
    w1 (3C, H); ``segment_ids`` (E,) nondecreasing (not checked: it would
    cost a device sync); ``mask`` (E,) bool or None. Contiguous, all
    float32 or all bfloat16 (a bf16 call: float32 tables, the per-edge
    products on the tensor cores with fp32 accumulators, the hidden rounded
    once to bf16, each output rounded once), C and H at most 64.
    One row projection (two when ``node_src`` and ``node_dst`` are
    different tensors), then the per-edge kernel. Returns (num_segments,
    C) in the inputs' dtype."""
    name = ATOM_CONV
    _require_cuda(name, edge, 2)
    e, channels = edge.shape
    dev, dtype = edge.device, _call_dtype(name, edge)
    for x in (edge,) + (() if abw is None else (abw,)):
        _check(name, x, (e, channels), dev, dtype)
    for x in (node_src, node_dst):
        _check(name, x, (x.shape[0], channels), dev, dtype)
    src32 = _index32(name, "src", src, e, dev)
    dst32 = src32 if dst is src else _index32(name, "dst", dst, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    hidden = _check_gated_weights(name, weights, 3 * channels, channels, dev, dtype)
    return _launch_chgnet(name, "distmlip_chgnet_atom_conv", 2,
                          [(node_src, src32), (node_dst, dst32)], edge,
                          [None if abw is None else abw.data_ptr()], weights, segment_ids,
                          int(num_segments), mask, channels, hidden, dev)


def chgnet_line_aggregate_cuda(bond_src, line_src, bond_dst, line_dst, angle, node,
                               center, weights, segment_ids, num_segments: int,
                               mask=None):
    """Launch the line-conv kernels: ``bond_src``, ``bond_dst`` (B, C)
    gathered at ``line_src``, ``line_dst`` (L,) int32/int64; ``angle``
    (L, C); ``node`` (N, C) gathered at ``center`` (L,); ``weights`` the
    gated MLP's 8 tensors with w1 (4C, H); ``segment_ids`` (L,)
    nondecreasing; ``mask`` (L,) bool or None. Contiguous, all float32 or
    all bfloat16 (as the atom conv), C and H at most 64. Two row
    projections (the bond rows, one pass when ``bond_src`` and
    ``bond_dst`` are one tensor, and the atom rows), then the per-edge
    kernel. Returns (num_segments, C) in the inputs' dtype."""
    name = LINE_CONV
    _require_cuda(name, angle, 2)
    e, channels = angle.shape
    dev, dtype = angle.device, _call_dtype(name, angle)
    _check(name, angle, (e, channels), dev, dtype)
    for x in (bond_src, bond_dst, node):
        _check(name, x, (x.shape[0], channels), dev, dtype)
    ls32 = _index32(name, "line_src", line_src, e, dev)
    ld32 = _index32(name, "line_dst", line_dst, e, dev)
    ctr32 = _index32(name, "center", center, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    hidden = _check_gated_weights(name, weights, 4 * channels, channels, dev, dtype)
    return _launch_chgnet(name, "distmlip_chgnet_line_conv", 2,
                          [(bond_src, ls32), (bond_dst, ld32), (node, ctr32)], angle, [],
                          weights, segment_ids, int(num_segments), mask, channels, hidden,
                          dev)


# ---------------------------------------------------------------------------
# named messages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgeMessage:
    """A per-edge message for ``fused_edge_aggregate``.

    ``fn(*rows, weights=weights) -> (E, ...)`` builds the messages from
    per-edge rows (a gathered input arrives as its gathered rows) and the
    message's weight tensors (``()`` for a message without weights); it is
    the plain forward and the backward's recompute. ``cuda(items, weights,
    segment_ids, num_segments, mask)`` launches the fused kernel, with each
    gathered input given as a ``(node, idx)`` pair; ``None`` means the
    message has no kernel, and the dispatcher raises for it on CUDA tensors
    with ``kernels=True``. ``backward(items, weights, g, segment_ids, mask,
    needs)``, when given, launches the kernel of the backward: the
    cotangents of the inputs, then of the weights (``None`` where ``needs``
    is False); the dispatcher takes it after a forward that launched the
    kernel, outside grad mode. ``bf16``: whether the kernels take bfloat16
    inputs; the dispatcher raises for bf16 on the kernel route otherwise.
    """

    name: str
    fn: Callable
    cuda: Callable | None = None
    backward: Callable | None = None
    bf16: bool = False


def _no_weights(name, weights):
    if weights:
        raise ValueError(f"{name}: the message takes no weights")


def _gathered(name, item, what):
    if not isinstance(item, tuple):
        raise ValueError(f"{name}: {what} must be a gathered input (a Gather)")
    return item[0].contiguous(), item[1]


def _embed_cuda(items, weights, segment_ids, num_segments, mask):
    _no_weights(EMBED, weights)
    return tensornet_embed_aggregate_cuda(*(x.contiguous() for x in items),
                                          segment_ids, num_segments, mask)


def _interaction_items(items):
    f, (node_i, src), (node_a, src_a), (node_s, src_s) = items
    if not (src is src_a and src is src_s):
        raise ValueError(f"{INTERACTION}: I, A and S must be gathered at the "
                         "same src ids (one index tensor)")
    return (f.contiguous(), node_i.contiguous(), node_a.contiguous(), node_s.contiguous(),
            src)


def _interaction_cuda(items, weights, segment_ids, num_segments, mask):
    _no_weights(INTERACTION, weights)
    return tensornet_interaction_aggregate_cuda(*_interaction_items(items), segment_ids,
                                                num_segments, mask)


def _interaction_backward_cuda(items, weights, g, segment_ids, mask, needs):
    _no_weights(INTERACTION, weights)
    grads = tensornet_interaction_backward_cuda(g.contiguous(), *_interaction_items(items),
                                                segment_ids, mask)
    return [d if need else None for d, need in zip(grads, needs)]


def _atom_conv_cuda(items, weights, segment_ids, num_segments, mask):
    if len(items) not in (3, 4):
        raise ValueError(f"{ATOM_CONV}: expected v[src], v[dst], e and optionally abw")
    node_src, src = _gathered(ATOM_CONV, items[0], "v_src")
    node_dst, dst = _gathered(ATOM_CONV, items[1], "v_dst")
    abw = items[3].contiguous() if len(items) == 4 else None
    return chgnet_atom_conv_aggregate_cuda(
        node_src, src, node_dst, dst, items[2].contiguous(), abw,
        tuple(w.contiguous() for w in weights), segment_ids, num_segments, mask)


def _line_conv_cuda(items, weights, segment_ids, num_segments, mask):
    if len(items) != 4:
        raise ValueError(f"{LINE_CONV}: expected b[line_src], b[line_dst], a, v[center]")
    bond_src, line_src = _gathered(LINE_CONV, items[0], "b_src")
    bond_dst, line_dst = _gathered(LINE_CONV, items[1], "b_dst")
    node, center = _gathered(LINE_CONV, items[3], "v_ctr")
    return chgnet_line_aggregate_cuda(
        bond_src, line_src, bond_dst, line_dst, items[2].contiguous(), node, center,
        tuple(w.contiguous() for w in weights), segment_ids, num_segments, mask)


TENSORNET_EMBED = EdgeMessage(EMBED, tensornet_embed_message, _embed_cuda, bf16=True)
TENSORNET_INTERACTION = EdgeMessage(INTERACTION, tensornet_interaction_message,
                                    _interaction_cuda, _interaction_backward_cuda, bf16=True)
CHGNET_ATOM_CONV = EdgeMessage(ATOM_CONV, chgnet_atom_message, _atom_conv_cuda, bf16=True)
CHGNET_LINE_CONV = EdgeMessage(LINE_CONV, chgnet_line_message, _line_conv_cuda, bf16=True)
