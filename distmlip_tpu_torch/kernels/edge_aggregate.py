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
  from per-edge gates (E, C, 3) and three (N, 3, 3, C) node arrays
  gathered at the same src ids (``tensornet.py:227-236``);
- ``CHGNET_ATOM_CONV``: ``GatedMLP([v[src] | v[dst] | e]) * abw`` per edge
  (``distmlip_tpu/models/chgnet.py:333-339``);
- ``CHGNET_LINE_CONV``: ``GatedMLP([b[line_src] | b[line_dst] | a |
  v[line_center]])`` per line-graph edge (``chgnet.py:356-365``).

All sum the message onto the dst-sorted rows under the validity mask:
``(num_segments, 3, 3, C)`` for TensorNet, ``(num_segments, C)`` for
CHGNet. CHGNet's messages take the gated MLP's tensors as ``weights``
(``ops.nn.gated_mlp_weights``: core w1, b1, w2, b2, then the gate's), one
hidden layer for the kernels. The ``*_cuda`` wrappers take CUDA tensors
only and raise on anything else; the ``*_reference`` versions build the
message with torch ops and ``masked_segment_sum`` it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.nn import gated_mlp_flat
from ..ops.segment import masked_segment_sum
from .segment import csr_row_offsets, launch_counts

EMBED = "tensornet_embed_aggregate"
INTERACTION = "tensornet_interaction_aggregate"
ATOM_CONV = "chgnet_atom_conv_aggregate"
LINE_CONV = "chgnet_line_aggregate"
launch_counts.update({EMBED: 0, INTERACTION: 0, ATOM_CONV: 0, LINE_CONV: 0})


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


def tensornet_interaction_message(f, i_s, a_s, s_s, *, weights=()):
    """(E, C, 3) gates and (E, 3, 3, C) gathered rows -> (E, 3, 3, C);
    takes no weights."""
    return (f[:, None, None, :, 0] * i_s
            + f[:, None, None, :, 1] * a_s
            + f[:, None, None, :, 2] * s_s)


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


def chgnet_atom_conv_aggregate_reference(node_src, src, node_dst, dst, edge, abw,
                                         weights, segment_ids, num_segments: int,
                                         mask=None):
    msg = chgnet_atom_message(node_src.index_select(0, src), node_dst.index_select(0, dst),
                              edge, abw, weights=weights)
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


def chgnet_line_aggregate_reference(bond_src, line_src, bond_dst, line_dst, angle, node,
                                    center, weights, segment_ids, num_segments: int,
                                    mask=None):
    msg = chgnet_line_message(bond_src.index_select(0, line_src),
                              bond_dst.index_select(0, line_dst), angle,
                              node.index_select(0, center), weights=weights)
    return masked_segment_sum(msg, segment_ids, num_segments, mask)


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
    layer below, and |kernel - plain| <= 2 B."""
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
    return 2 * b


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_fns: dict = {}


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


def _chgnet_fn(symbol: str, n_ptr: int = 0):
    """A function of ``csrc/chgnet_aggregate.cu``: ``n_ptr`` pointers, then
    n_rows, n_edges, C, H and the stream; ``n_ptr = 0`` is the
    shared-memory query."""
    fn = _fns.get(symbol)
    if fn is None:
        from .build import load

        fn = getattr(load("chgnet_aggregate"), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 if n_ptr == 0 else
                       [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        _fns[symbol] = fn
    return fn


def _require_cuda(name, x, ndim):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors; use the *_reference "
                         "version for tensors on the CPU")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got {x.ndim}-d")


def _check(name, x, shape, device):
    _require_cuda(name, x, len(shape))
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: inputs must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} tensor on "
                         f"{device}, got {tuple(x.shape)} on {x.device}")


def _check_index(name, what, x, e, device, dtypes=(torch.int32, torch.int64)):
    if x.ndim != 1 or x.shape[0] != e or x.dtype not in dtypes or x.device != device:
        raise ValueError(f"{name}: {what} must be ({e},) "
                         f"{'/'.join(str(d) for d in dtypes)} on {device}")


def _launch(name, symbol, out, tensors, row_ptr, mask, channels):
    stream = torch.cuda.current_stream(out.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    err = _fn(symbol, len(ptrs) + 3)(
        *ptrs, row_ptr.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), out.shape[0], channels, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launch_counts[name] += 1
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
    (E, 3, 3, 1), float32 contiguous; ``segment_ids`` (E,) nondecreasing
    (not checked: it would cost a device sync); ``mask`` (E,) bool or None.
    Returns (num_segments, 3, 3, C) float32."""
    name = EMBED
    _require_cuda(name, zij, 2)
    e, channels = zij.shape
    dev = zij.device
    for x in (zij, w1, w2, w3):
        _check(name, x, (e, channels), dev)
    for x in (a_e, s_e):
        _check(name, x, (e, 3, 3, 1), dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    num_segments = int(num_segments)
    out = torch.empty((num_segments, 3, 3, channels), dtype=torch.float32, device=dev)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        return _launch(name, "distmlip_tensornet_embed_f32", out,
                       (zij, w1, w2, w3, a_e, s_e), row_ptr, mask, channels)


def tensornet_interaction_aggregate_cuda(f, node_i, node_a, node_s, src,
                                         segment_ids, num_segments: int,
                                         mask=None):
    """Launch the interaction kernel: ``f`` (E, C, 3) and ``node_i, node_a,
    node_s`` (N_node, 3, 3, C), float32 contiguous; ``src`` (E,) int32/int64
    row ids into the node arrays (in range on every valid edge);
    ``segment_ids`` (E,) nondecreasing; ``mask`` (E,) bool or None. Returns
    (num_segments, 3, 3, C) float32."""
    name = INTERACTION
    _require_cuda(name, f, 3)
    e, channels = f.shape[0], f.shape[1]
    dev = f.device
    _check(name, f, (e, channels, 3), dev)
    n_node = node_i.shape[0]
    for x in (node_i, node_a, node_s):
        _check(name, x, (n_node, 3, 3, channels), dev)
    _check_index(name, "src", src, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    num_segments = int(num_segments)
    out = torch.empty((num_segments, 3, 3, channels), dtype=torch.float32, device=dev)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    if n_node >= 2 ** 31:
        raise ValueError(f"{name}: {n_node} node rows exceed int32 src ids")
    with torch.cuda.device(dev):
        src32 = src.to(torch.int32).contiguous()
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        return _launch(name, "distmlip_tensornet_interaction_f32", out,
                       (f, node_i, node_a, node_s, src32), row_ptr, mask, channels)


def _check_gated_weights(name, weights, k1, channels, device):
    """The gated MLP's 8 tensors with one hidden layer: w1 (K1, H), b1 (H),
    w2 (H, C), b2 (C), for the core and then the gate. Returns H."""
    if len(weights) != 8:
        raise ValueError(f"{name}: the kernel takes a gated MLP with exactly one "
                         f"hidden layer (8 tensors), got {len(weights)} tensors")
    hidden = weights[0].shape[1] if weights[0].ndim == 2 else 0
    for half in (0, 4):
        w1, b1, w2, b2 = weights[half:half + 4]
        _check(name, w1, (k1, hidden), device)
        _check(name, b1, (hidden,), device)
        _check(name, w2, (hidden, channels), device)
        _check(name, b2, (channels,), device)
    return hidden


def _index32(name, what, idx, e, device):
    _check_index(name, what, idx, e, device)
    return idx.to(torch.int32).contiguous()


def _launch_chgnet(name, symbol, n_seg, ptrs, weights, segment_ids, num_segments, mask,
                   channels, hidden, device):
    e = segment_ids.shape[0]
    out = torch.empty((num_segments, channels), dtype=torch.float32, device=device)
    if e == 0 or num_segments == 0 or channels == 0:
        return out.zero_()
    if e >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {e} edges exceed the kernel's int32 edge ids")
    smem = _chgnet_fn("distmlip_chgnet_aggregate_smem_bytes")(n_seg, channels, hidden)
    if smem < 0 or channels > 256:
        raise ValueError(f"{name}: C={channels}, H={hidden} is too wide for the "
                         "weights to stay in one block's shared memory (227 KB)")
    with torch.cuda.device(device):
        ids32 = segment_ids.to(torch.int32).contiguous()
        row_ptr = csr_row_offsets(segment_ids, num_segments, mask)
        wptrs = (ctypes.c_void_p * 8)(*(w.data_ptr() for w in weights))
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _chgnet_fn(symbol, len(ptrs) + 5)(
            *ptrs, wptrs, row_ptr.data_ptr(), ids32.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            num_segments, e, channels, hidden, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launch_counts[name] += 1
    return out


def chgnet_atom_conv_aggregate_cuda(node_src, src, node_dst, dst, edge, abw, weights,
                                    segment_ids, num_segments: int, mask=None):
    """Launch the atom-conv kernel: ``node_src``, ``node_dst`` (N, C)
    gathered at ``src``, ``dst`` (E,) int32/int64; ``edge`` (E, C);
    ``abw`` (E, C) or None; ``weights`` the gated MLP's 8 tensors with
    w1 (3C, H); ``segment_ids`` (E,) nondecreasing (not checked: it would
    cost a device sync); ``mask`` (E,) bool or None. float32 contiguous.
    Returns (num_segments, C) float32."""
    name = ATOM_CONV
    _require_cuda(name, edge, 2)
    e, channels = edge.shape
    dev = edge.device
    for x in (edge,) + (() if abw is None else (abw,)):
        _check(name, x, (e, channels), dev)
    for x in (node_src, node_dst):
        _check(name, x, (x.shape[0], channels), dev)
    src32 = _index32(name, "src", src, e, dev)
    dst32 = src32 if dst is src else _index32(name, "dst", dst, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    hidden = _check_gated_weights(name, weights, 3 * channels, channels, dev)
    ptrs = (node_src.data_ptr(), src32.data_ptr(), node_dst.data_ptr(), dst32.data_ptr(),
            edge.data_ptr(), None if abw is None else abw.data_ptr())
    return _launch_chgnet(name, "distmlip_chgnet_atom_conv_f32", 3, ptrs, weights,
                          segment_ids, int(num_segments), mask, channels, hidden, dev)


def chgnet_line_aggregate_cuda(bond_src, line_src, bond_dst, line_dst, angle, node,
                               center, weights, segment_ids, num_segments: int,
                               mask=None):
    """Launch the line-conv kernel: ``bond_src``, ``bond_dst`` (B, C)
    gathered at ``line_src``, ``line_dst`` (L,) int32/int64; ``angle``
    (L, C); ``node`` (N, C) gathered at ``center`` (L,); ``weights`` the
    gated MLP's 8 tensors with w1 (4C, H); ``segment_ids`` (L,)
    nondecreasing; ``mask`` (L,) bool or None. float32 contiguous. Returns
    (num_segments, C) float32."""
    name = LINE_CONV
    _require_cuda(name, angle, 2)
    e, channels = angle.shape
    dev = angle.device
    _check(name, angle, (e, channels), dev)
    for x in (bond_src, bond_dst, node):
        _check(name, x, (x.shape[0], channels), dev)
    ls32 = _index32(name, "line_src", line_src, e, dev)
    ld32 = _index32(name, "line_dst", line_dst, e, dev)
    ctr32 = _index32(name, "center", center, e, dev)
    mask = _ids_and_mask(name, segment_ids, mask, e, dev)
    hidden = _check_gated_weights(name, weights, 4 * channels, channels, dev)
    ptrs = (bond_src.data_ptr(), ls32.data_ptr(), bond_dst.data_ptr(), ld32.data_ptr(),
            angle.data_ptr(), node.data_ptr(), ctr32.data_ptr())
    return _launch_chgnet(name, "distmlip_chgnet_line_conv_f32", 4, ptrs, weights,
                          segment_ids, int(num_segments), mask, channels, hidden, dev)


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
    with ``kernels=True``.
    """

    name: str
    fn: Callable
    cuda: Callable | None = None


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


def _interaction_cuda(items, weights, segment_ids, num_segments, mask):
    _no_weights(INTERACTION, weights)
    f, (node_i, src), (node_a, src_a), (node_s, src_s) = items
    if not (src is src_a and src is src_s):
        raise ValueError(f"{INTERACTION}: I, A and S must be gathered at the "
                         "same src ids (one index tensor)")
    return tensornet_interaction_aggregate_cuda(
        f.contiguous(), node_i.contiguous(), node_a.contiguous(),
        node_s.contiguous(), src, segment_ids, num_segments, mask)


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


TENSORNET_EMBED = EdgeMessage(EMBED, tensornet_embed_message, _embed_cuda)
TENSORNET_INTERACTION = EdgeMessage(INTERACTION, tensornet_interaction_message,
                                    _interaction_cuda)
CHGNET_ATOM_CONV = EdgeMessage(ATOM_CONV, chgnet_atom_message, _atom_conv_cuda)
CHGNET_LINE_CONV = EdgeMessage(LINE_CONV, chgnet_line_message, _line_conv_cuda)
