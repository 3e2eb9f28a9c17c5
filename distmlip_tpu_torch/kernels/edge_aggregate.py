"""TensorNet's fused edge aggregations: the CUDA kernels' wrappers, their
plain PyTorch versions and the named messages the dispatcher routes.

Replaces ``distmlip_tpu/kernels/segment.py::pallas_edge_aggregate`` at
TensorNet's two call sites. The TPU kernel runs any traced ``edge_fn``; a
CUDA kernel cannot take a Python function, so each message is a small named
object (:class:`EdgeMessage`): its torch function (the plain version and
the backward's recompute) plus the launcher of its kernel in
``csrc/edge_aggregate.cu``:

- ``TENSORNET_EMBED``: ``Z * (W1 * eye + W2 * A_e + W3 * S_e)`` from
  per-edge (E, C) rows and (E, 3, 3, 1) geometric tensors
  (``distmlip_tpu/models/tensornet.py:171-179``);
- ``TENSORNET_INTERACTION``: ``f0 * I[src] + f1 * A[src] + f2 * S[src]``
  from per-edge gates (E, C, 3) and three (N, 3, 3, C) node arrays
  gathered at the same src ids (``tensornet.py:227-236``).

Both sum the message onto the dst-sorted rows under the validity mask,
``(num_segments, 3, 3, C)``. The ``*_cuda`` wrappers take CUDA tensors only
and raise on anything else; the ``*_reference`` versions build the message
with torch ops and ``masked_segment_sum`` it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.segment import masked_segment_sum
from .segment import csr_row_offsets, launch_counts

EMBED = "tensornet_embed_aggregate"
INTERACTION = "tensornet_interaction_aggregate"
launch_counts.update({EMBED: 0, INTERACTION: 0})


# ---------------------------------------------------------------------------
# the messages, in torch ops
# ---------------------------------------------------------------------------

def tensornet_embed_message(zij, w1, w2, w3, a_e, s_e):
    """(E, C) x3, (E, 3, 3, 1) x2 -> (E, 3, 3, C)."""
    eye = torch.eye(3, dtype=zij.dtype, device=zij.device)[:, :, None]
    return zij[:, None, None, :] * (
        w1[:, None, None, :] * eye
        + w2[:, None, None, :] * a_e
        + w3[:, None, None, :] * s_e)


def tensornet_interaction_message(f, i_s, a_s, s_s):
    """(E, C, 3) gates and (E, 3, 3, C) gathered rows -> (E, 3, 3, C)."""
    return (f[:, None, None, :, 0] * i_s
            + f[:, None, None, :, 1] * a_s
            + f[:, None, None, :, 2] * s_s)


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


# ---------------------------------------------------------------------------
# named messages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgeMessage:
    """A per-edge message for ``fused_edge_aggregate``.

    ``fn(*rows) -> (E, ...)`` builds the messages from per-edge rows (a
    gathered input arrives as its gathered rows); it is the plain forward
    and the backward's recompute. ``cuda(items, segment_ids, num_segments,
    mask)`` launches the fused kernel, with each gathered input given as a
    ``(node, idx)`` pair; ``None`` means the message has no kernel, and the
    dispatcher raises for it on CUDA tensors with ``kernels=True``.
    """

    name: str
    fn: Callable
    cuda: Callable | None = None


def _embed_cuda(items, segment_ids, num_segments, mask):
    return tensornet_embed_aggregate_cuda(*(x.contiguous() for x in items),
                                          segment_ids, num_segments, mask)


def _interaction_cuda(items, segment_ids, num_segments, mask):
    f, (node_i, src), (node_a, src_a), (node_s, src_s) = items
    if not (src is src_a and src is src_s):
        raise ValueError(f"{INTERACTION}: I, A and S must be gathered at the "
                         "same src ids (one index tensor)")
    return tensornet_interaction_aggregate_cuda(
        f.contiguous(), node_i.contiguous(), node_a.contiguous(),
        node_s.contiguous(), src, segment_ids, num_segments, mask)


TENSORNET_EMBED = EdgeMessage(EMBED, tensornet_embed_message, _embed_cuda)
TENSORNET_INTERACTION = EdgeMessage(INTERACTION, tensornet_interaction_message,
                                    _interaction_cuda)
