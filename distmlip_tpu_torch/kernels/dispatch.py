"""Kernel dispatch: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors or ``kernels=False``.

Every kernel call site goes through here, never through ``segment`` or
``edge_aggregate`` directly. The routing is by where the tensors live and
by semantics — there is no fallback: a CUDA tensor with ``kernels=True``
launches the kernel or raises.

- ``fused_segment_sum`` is a ``torch.autograd.Function``: its backward is
  the transpose of a masked segment sum, the gather ``g[ids] * mask``
  (``distmlip_tpu/kernels/dispatch.py:220-240``), written in
  differentiable torch ops so a later double backward (force-loss
  training) works. bfloat16 data launches the kernel's bf16 instantiation
  (fp32 accumulation, one rounding); the gather backward is exact in bf16
  and comes out in data's dtype.
- ``fused_so2_conv`` (``distmlip_tpu/kernels/dispatch.py:613``) is one
  too: forward the SO(2)-convolution kernel, which reads and writes the
  model's coefficient order through a row table (no permuted copy). The
  backward's input cotangent is the same Function on the transposed
  weight set, so on the card it is one more launch of the kernel; the
  weight cotangents, only when asked for (the force program asks for
  none), and the whole backward on the plain path are the VJP of
  ``so2_conv_reference`` in differentiable torch ops, as the JAX
  package's custom VJP (``:650-657``). The route follows ``h``'s dtype:
  bfloat16 launches the bf16 kernel on bf16 packed weights, and its plain
  products (the reference, the weight cotangents) are taken in fp32 and
  rounded once.
- ``fused_edge_aggregate`` (``distmlip_tpu/kernels/dispatch.py:306``) is
  one too: forward the fused gather -> message -> masked dst sum. Backward:
  a message with a kernel backward (TensorNet's interaction) launches it
  when the forward launched its kernel and no graph is being built (the
  force program); otherwise, under ``create_graph`` (a double backward)
  and on the plain path, the JAX package's chunked recompute
  (``_edge_aggregate_bwd``, ``:482``) in differentiable torch ops, by
  semantics and not as a fallback. ``recompute_chunks`` counts that
  recompute's chunks per message. bfloat16 inputs launch a message's bf16
  kernels where it has them (``EdgeMessage.bf16``: TensorNet's and
  CHGNet's) and raise on the kernel route where it does not, as float16
  does (a call mixing float32 and bf16 raises in the kernel's wrapper);
  the recompute keeps the JAX dispatcher's fp32 views: half node rows
  gather with an fp32-accumulating transpose (``ops.nn.gather_rows``, as
  the message cotangent's gather) and their cotangents sum in fp32,
  rounded once after the last chunk (``:528-584``). The message is an
  ``EdgeMessage`` (a torch function plus its kernels), not an arbitrary
  callable, because a CUDA kernel cannot run a Python function; an edge
  MLP's weights, which the JAX dispatcher hoists from the closure, are
  explicit ``weights``.
  The JAX package's VMEM budget and its pre-gather route have no
  counterpart: the kernels gather node rows from global memory at every
  size.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any

import torch

from ..ops.nn import gather_rows
from ..ops.segment import _HALF_DTYPES, masked_segment_sum
from .edge_aggregate import EdgeMessage, screen_masked_rows
from .segment import segment_sum_cuda, segment_sum_reference
from .so3 import (pack_so2_weights, packed_m_layout, so2_conv_cuda,
                  so2_conv_reference)

# edges per chunk of the edge-aggregate backward (bounds the recomputed
# message and its cotangent), distmlip_tpu/kernels/dispatch.py:49
DEFAULT_BWD_CHUNK = 32768

# chunks of the edge-aggregate backward's plain recompute, by message name:
# a run resets them to 0 to show which backwards took the kernel route
recompute_chunks: dict = {}

# forward routing of the three dispatchers' calls: "kernel" (a hand-written
# kernel launches) or "plain" (its plain PyTorch version runs). Telemetry
# reads the difference over a step for the records' kernel_mode and
# kernel_coverage (the JAX package's trace-time KernelCounter); one int add
# a call, nothing else.
route_counts = {"kernel": 0, "plain": 0}


_route_lock = threading.Lock()


def _route(use_kernel: bool) -> None:
    with _route_lock:  # serving replicas route from their own threads
        route_counts["kernel" if use_kernel else "plain"] += 1


def kernel_routing(before: dict | None = None) -> tuple[str, float]:
    """``(kernel_mode, kernel_coverage)`` of the calls routed since the
    snapshot ``before`` (a copy of ``route_counts``): "cuda" when any
    launched a hand-written kernel, "plain" when all took the plain
    versions, "" when none were routed; the coverage is the kernel share."""
    before = before or {"kernel": 0, "plain": 0}
    k = route_counts["kernel"] - before["kernel"]
    total = k + route_counts["plain"] - before["plain"]
    if total <= 0:
        return "", 0.0
    return ("cuda" if k else "plain"), k / total


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, mask, num_segments, use_kernel):
        fn = segment_sum_cuda if use_kernel else segment_sum_reference
        out = fn(data, segment_ids, num_segments, mask)
        ctx.save_for_backward(segment_ids, mask)
        ctx.dtype = data.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        segment_ids, mask = ctx.saved_tensors
        gd = g.to(ctx.dtype).index_select(0, segment_ids)
        if mask is not None:
            gd = gd * mask.reshape(mask.shape + (1,) * (gd.ndim - 1)).to(gd.dtype)
        return gd, None, None, None, None


def fused_segment_sum(data, segment_ids, num_segments: int, mask=None,
                      indices_are_sorted: bool = False, kernels: bool = True):
    """Dispatching drop-in for ``masked_segment_sum``.

    Sorted ids (``indices_are_sorted=True``, the dst-sorted layout
    contract the kernel's CSR offsets depend on) go through the autograd
    Function: the CUDA kernel for CUDA tensors unless ``kernels=False``,
    the plain version for CPU tensors. Unsorted ids take the plain
    ``masked_segment_sum``, as the JAX dispatcher routes them to XLA.
    ``mask`` is a bool tensor or None.
    """
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"fused_segment_sum: mask must be bool, got {mask.dtype}")
    if not indices_are_sorted:
        _route(False)
        return masked_segment_sum(data, segment_ids, num_segments, mask)
    use_kernel = kernels is not False and data.is_cuda
    _route(use_kernel)
    return _SegmentSum.apply(data, segment_ids, mask, int(num_segments),
                             use_kernel)


# ---------------------------------------------------------------------------
# fused gather -> edge message -> scatter
# ---------------------------------------------------------------------------

@dataclass
class Gather:
    """A node-row gather input to :func:`fused_edge_aggregate`: the rows
    ``idx`` (E,) of ``node`` (N, ...). The kernel gathers inside; the plain
    version and the backward index the rows out."""

    node: Any
    idx: Any


def _items(kinds, tensors):
    """Per input: the per-edge tensor, or ``(node, idx)`` for a gather."""
    n_in = len(kinds)
    arrs, idxs = tensors[:n_in], tensors[n_in:]
    return [a if k is None else (a, idxs[k]) for a, k in zip(arrs, kinds)]


def _rows(items):
    """Per input: the per-edge tensor, or the gathered node rows."""
    return [x[0].index_select(0, x[1]) if isinstance(x, tuple) else x for x in items]


class _EdgeAggregate(torch.autograd.Function):
    # positional layout of apply(): 8 non-differentiable leading arguments,
    # then one tensor per input (a per-edge array or a gathered node array),
    # then the message's weight tensors, then the distinct gather index
    # tensors
    N_LEAD = 8

    @staticmethod
    def forward(ctx, message, kinds, n_weights, use_kernel, chunk, num_segments,
                segment_ids, mask, *tensors):
        n_in = len(kinds)
        weights = tensors[n_in:n_in + n_weights]
        items = _items(kinds, tensors[:n_in] + tensors[n_in + n_weights:])
        if use_kernel:
            out = message.cuda(items, weights, segment_ids, num_segments, mask)
        else:
            rows = screen_masked_rows(mask, *_rows(items))
            out = masked_segment_sum(message.fn(*rows, weights=weights),
                                     segment_ids, num_segments, mask)
        ctx.save_for_backward(segment_ids, mask, *tensors)
        ctx.message, ctx.kinds, ctx.n_weights, ctx.chunk = message, kinds, n_weights, chunk
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        segment_ids, mask, *tensors = ctx.saved_tensors
        n_in, n_w = len(ctx.kinds), ctx.n_weights
        lead = _EdgeAggregate.N_LEAD
        needs = ctx.needs_input_grad[lead:lead + n_in + n_w]
        message = ctx.message
        if ctx.use_kernel and message.backward is not None and not torch.is_grad_enabled():
            items = _items(ctx.kinds, tensors[:n_in] + tensors[n_in + n_w:])
            grads = message.backward(items, tensors[n_in:n_in + n_w], g, segment_ids, mask,
                                     needs)
        else:
            grads = _edge_aggregate_bwd(message, ctx.kinds, tensors[:n_in],
                                        tensors[n_in:n_in + n_w], tensors[n_in + n_w:],
                                        segment_ids, mask, g, ctx.chunk, needs)
        return ((None,) * lead + tuple(grads)
                + (None,) * (len(tensors) - n_in - n_w))


def _edge_aggregate_bwd(message, kinds, arrs, weights, idxs, segment_ids, mask, g, chunk,
                        needs):
    """Chunked backward (``distmlip_tpu/kernels/dispatch.py:482-606``): per
    chunk of edges, recompute the messages and pull the gathered message
    cotangent ``g[dst] * mask`` back through them with
    ``torch.autograd.grad``. Per-edge inputs get their chunk rows (joined in
    edge order); gathered node arrays get the rows' cotangents scatter-added
    onto their source rows; weights get their cotangents summed over the
    chunks. ``needs`` covers the inputs, then the weights: an input or
    weight not needed gets ``None`` and costs nothing (the force program
    asks for no weight gradient). The working set is one chunk of messages.
    Under grad mode (double backward) the graph of this computation is
    kept. Each chunk adds one to ``recompute_chunks[message.name]``.

    Half-precision inputs follow the JAX dispatcher's fp32-view rules
    (``:528-584``): node cotangents accumulate in fp32 across the chunks
    and round once at the end (the ``node_cts0`` carry), and the chunk's
    gathered node rows and message cotangent go through ``gather_rows``,
    whose transpose (reached by a double backward) sums in fp32. The
    weights' cotangents sum in the weights' own dtype (``:573-575``)."""
    fn = message.fn
    create = torch.is_grad_enabled()
    n_in = len(arrs)
    e = segment_ids.shape[0]
    edge_cts = {k: [] for k, kind in enumerate(kinds) if kind is None and needs[k]}
    node_cts = {k: torch.zeros(a.shape, device=a.device, dtype=torch.float32
                               if a.dtype in _HALF_DTYPES else a.dtype)
                for k, (a, kind) in enumerate(zip(arrs, kinds))
                if kind is not None and needs[k]}
    w_cts = {j: None for j in range(len(weights)) if needs[n_in + j]}
    want = [k for k in range(n_in) if needs[k]]
    with torch.enable_grad():
        ws = tuple(w.detach().requires_grad_(True) if needs[n_in + j] and not create
                   else w for j, w in enumerate(weights))
        for s in range(0, e, chunk):
            sl = slice(s, min(s + chunk, e))
            rows = []
            for k, (a, kind) in enumerate(zip(arrs, kinds)):
                r = a[sl] if kind is None else gather_rows(a, idxs[kind][sl])
                if needs[k] and not create:
                    r = r.detach().requires_grad_(True)
                rows.append(r)
            gm = gather_rows(g, segment_ids[sl])
            if mask is not None:
                m = mask[sl].to(gm.dtype)
                gm = gm * m.reshape(m.shape + (1,) * (gm.ndim - 1))
            targets = [rows[k] for k in want] + [ws[j] for j in w_cts]
            cts = torch.autograd.grad(fn(*rows, weights=ws), targets, gm,
                                      create_graph=create, allow_unused=True)
            with _route_lock:
                recompute_chunks[message.name] = recompute_chunks.get(message.name, 0) + 1
            for k, ct in zip(want, cts):
                if ct is None:
                    ct = torch.zeros_like(rows[k])
                if kinds[k] is None:
                    edge_cts[k].append(ct)
                elif create:  # keep the graph: out of place
                    node_cts[k] = node_cts[k].index_add(0, idxs[kinds[k]][sl],
                                                        ct.to(node_cts[k].dtype))
                else:
                    node_cts[k].index_add_(0, idxs[kinds[k]][sl], ct.to(node_cts[k].dtype))
            for j, ct in zip(w_cts, cts[len(want):]):
                if ct is not None:
                    w_cts[j] = ct if w_cts[j] is None else w_cts[j] + ct
    out = []
    for k in range(n_in):
        if not needs[k]:
            out.append(None)
        elif kinds[k] is None:
            out.append(torch.cat(edge_cts[k]))
        else:
            out.append(node_cts[k].to(arrs[k].dtype))
    for j, w in enumerate(weights):
        if j not in w_cts:
            out.append(None)
        else:
            out.append(torch.zeros_like(w) if w_cts[j] is None else w_cts[j])
    return out


def fused_edge_aggregate(message, inputs, segment_ids, num_segments: int,
                         mask=None, indices_are_sorted: bool = True,
                         kernels: bool = True, bwd_chunk: int = DEFAULT_BWD_CHUNK,
                         weights=()):
    """Fused gather + per-edge message + dst-sorted masked segment sum.

    ``message``: an :class:`EdgeMessage`. ``inputs``: per-edge tensors
    (E, ...) and/or :class:`Gather` markers, in the order ``message.fn``
    takes its rows. ``weights``: the message's weight tensors (an edge
    MLP's), passed to ``message.fn`` as ``weights=`` and to its kernel;
    they are explicit inputs of the autograd Function, so the backward
    returns their gradients when asked for them and nothing otherwise
    (the JAX dispatcher's hoisted consts and ``diff_params``, ``:377-399``).
    The result is ``sum_{e: dst[e] = n} mask[e] * message.fn(rows)[e]``
    with ``masked_segment_sum``'s padding semantics. The plain route zeroes
    the masked edges' rows before ``message.fn`` (``screen_masked_rows``),
    as the kernels never read them, so no non-finite value there reaches a
    valid edge's message.

    Sorted ids with edges and rows go through the autograd Function: the
    message's CUDA kernel for CUDA tensors unless ``kernels=False``, the
    plain version for CPU tensors. A message with no kernel raises on CUDA
    tensors with ``kernels=True``. Unsorted ids, or no edges or rows, take
    the plain path, as the JAX dispatcher routes them to XLA (``:338-344``).
    ``bwd_chunk`` bounds the backward's edge chunk. bfloat16 inputs on the
    kernel route launch the message's bf16 kernels (``message.bf16``), or
    raise where it has none: no half input is upcast or sent to the plain
    version there.
    """
    if not isinstance(message, EdgeMessage):
        raise TypeError("fused_edge_aggregate: message must be an EdgeMessage "
                        f"(a torch function plus its kernel), got {message!r}")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"fused_edge_aggregate: mask must be bool, got {mask.dtype}")
    inputs = list(inputs)
    weights = tuple(weights)
    num_segments = int(num_segments)
    if not indices_are_sorted or segment_ids.shape[0] == 0 or num_segments == 0:
        rows = screen_masked_rows(mask, *[i.node.index_select(0, i.idx)
                                          if isinstance(i, Gather) else i for i in inputs])
        _route(False)
        return masked_segment_sum(message.fn(*rows, weights=weights), segment_ids,
                                  num_segments, mask)
    use_kernel = kernels is not False and segment_ids.is_cuda
    if use_kernel and message.cuda is None:
        raise NotImplementedError(
            f"fused_edge_aggregate: message {message.name!r} has no CUDA kernel; "
            "pass kernels=False to run its plain version on the card")
    chunk = int(bwd_chunk)
    if chunk < 1:
        raise ValueError(f"bwd_chunk={chunk} must be >= 1")
    kinds, arrs, idxs = [], [], []
    for item in inputs:
        if isinstance(item, Gather):
            # one index tensor gathered by several inputs is passed once
            pos = next((k for k, t in enumerate(idxs) if t is item.idx), None)
            if pos is None:
                idxs.append(item.idx)
                pos = len(idxs) - 1
            kinds.append(pos)
            arrs.append(item.node)
        else:
            kinds.append(None)
            arrs.append(item)
    half = {a.dtype for a in (*arrs, *weights) if a.dtype in _HALF_DTYPES}
    if use_kernel and half and not (message.bf16 and half == {torch.bfloat16}):
        raise NotImplementedError(
            f"fused_edge_aggregate: {'/'.join(map(str, sorted(half, key=str)))} inputs "
            f"to the {message.name!r} kernel, which takes float32"
            f"{' or bfloat16' if message.bf16 else ''}")
    _route(use_kernel)
    return _EdgeAggregate.apply(message, tuple(kinds), len(weights), use_kernel, chunk,
                                num_segments, segment_ids, mask, *arrs, *weights, *idxs)


# ---------------------------------------------------------------------------
# fused SO(2) convolution (eSCN channel mixing)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _row_tables(perm: tuple, inv: tuple, device):
    """The packed order's gather tables on ``device``, made once: a host
    copy per call would synchronise the host with the card."""
    return (torch.tensor(perm, dtype=torch.long, device=device),
            torch.tensor(inv, dtype=torch.long, device=device))


def _so2_plain(h, weights, perm, inv, segments, channels):
    """``so2_conv_reference`` in the model's coefficient order."""
    return so2_conv_reference(h.index_select(1, perm), weights, segments,
                              channels).index_select(1, inv)


class _SO2Conv(torch.autograd.Function):
    # positional layout of apply(): 7 non-differentiable leading arguments
    # (the host row order for the kernel, its device copies for the plain
    # ops, the packed weights for the kernel or None), then h, then the
    # weight matrices
    N_LEAD = 7

    @staticmethod
    def forward(ctx, use_kernel, perm_np, perm, inv, segments, channels, packed, h,
                *weights):
        if use_kernel:
            out = so2_conv_cuda(h.contiguous(), list(weights), segments, channels, perm_np,
                                packed=packed)
        else:
            out = _so2_plain(h, weights, perm, inv, segments, channels)
        ctx.save_for_backward(perm, inv, h, *weights)
        ctx.use_kernel, ctx.perm_np, ctx.packed = use_kernel, perm_np, packed
        ctx.segments, ctx.channels = segments, channels
        return out

    @staticmethod
    def backward(ctx, g):
        perm, inv, h, *weights = ctx.saved_tensors
        lead = _SO2Conv.N_LEAD
        need_h = ctx.needs_input_grad[lead]
        need_w = ctx.needs_input_grad[lead + 1:]
        plain_h = need_h and not ctx.use_kernel
        gh, gws = None, [None] * len(weights)
        if plain_h or any(need_w):
            gh, gws = _so2_vjp(h, weights, g, perm, inv, ctx.segments, ctx.channels,
                               plain_h, need_w)
        if need_h and ctx.use_kernel:
            # the input cotangent is the same convolution on the transposed
            # weight set, so the kernel runs it (and its own backward, for a
            # double backward, swaps the packed buffers back)
            gh = _SO2Conv.apply(True, ctx.perm_np, perm, inv, ctx.segments, ctx.channels,
                                ctx.packed.transposed(), g,
                                *_so2_transposed_weights(weights, ctx.segments))
        return (None,) * lead + (gh,) + tuple(gws)


def _so2_transposed_weights(weights, segments):
    """The weight set whose convolution is the input cotangent: W0^T for
    m = 0, and Wr^T, -Wi^T for m > 0, since [[Wr, Wi], [-Wi, Wr]]^T =
    [[Wr^T, -Wi^T], [Wi^T, Wr^T]] is the same form. Differentiable, so a
    double backward reaches the weights."""
    out, wi = [], 0
    for m, _, _ in segments:
        if m == 0:
            out.append(weights[wi].t())
            wi += 1
        else:
            out += [weights[wi].t(), -weights[wi + 1].t()]
            wi += 2
    return out


def _so2_vjp(h, weights, g, perm, inv, segments, channels, need_h, need_w):
    """The VJP of ``_so2_plain`` in differentiable torch ops
    (``distmlip_tpu/kernels/dispatch.py:650-657``), per |m| in the packed
    order: with g the output cotangent,
        m = 0:  gf0 = g0 W0^T,                 gW0 = f0^T g0
        m > 0:  gf+ = g+ Wr^T + g- Wi^T,       gWr = f+^T g+ + f-^T g-
                gf- = g- Wr^T - g+ Wi^T,       gWi = f+^T g- - f-^T g+
    ``need_w`` flags each weight; one not needed gets ``None`` and costs
    nothing, and the input rows are gathered only when a weight is.
    Half-precision operands take these products in fp32 and each cotangent
    is rounded once to its operand's dtype, as the kernel's route does."""
    if g.dtype in _HALF_DTYPES:
        gh, gws = _so2_vjp(h.float(), [w.float() for w in weights], g.float(), perm, inv,
                           segments, channels, need_h, need_w)
        return (None if gh is None else gh.to(h.dtype),
                [None if x is None else x.to(w.dtype) for x, w in zip(gws, weights)])
    e, c = g.shape[0], channels
    gp = g.index_select(1, perm)
    hp = h.index_select(1, perm) if any(need_w) else None
    gh_parts, gws = [], [None] * len(weights)
    wi = 0
    for m, start, nl in segments:
        d = nl * c
        if m == 0:
            g0 = gp[:, start:start + nl].reshape(e, d)
            if need_h:
                gh_parts.append((g0 @ weights[wi].transpose(0, 1)).reshape(e, nl, c))
            if need_w[wi]:
                gws[wi] = hp[:, start:start + nl].reshape(e, d).transpose(0, 1) @ g0
            wi += 1
            continue
        gplus = gp[:, start:start + nl].reshape(e, d)
        gminus = gp[:, start + nl:start + 2 * nl].reshape(e, d)
        wr, wim = weights[wi], weights[wi + 1]
        if need_h:
            gh_parts.append((gplus @ wr.transpose(0, 1) + gminus @ wim.transpose(0, 1)
                             ).reshape(e, nl, c))
            gh_parts.append((gminus @ wr.transpose(0, 1) - gplus @ wim.transpose(0, 1)
                             ).reshape(e, nl, c))
        if need_w[wi] or need_w[wi + 1]:
            fpt = hp[:, start:start + nl].reshape(e, d).transpose(0, 1)
            fmt = hp[:, start + nl:start + 2 * nl].reshape(e, d).transpose(0, 1)
            if need_w[wi]:
                gws[wi] = fpt @ gplus + fmt @ gminus
            if need_w[wi + 1]:
                gws[wi + 1] = fpt @ gminus - fmt @ gplus
        wi += 2
    gh = torch.cat(gh_parts, dim=1).index_select(1, inv) if need_h else None
    return gh, gws


def so2_packed_weights(weights, m_idx: dict, channels: int, kernels: bool = True):
    """The kernel's packed form of ``weights`` (``pack_so2_weights``, with
    the transposed set for the backward) when ``fused_so2_conv`` will
    launch the kernel for them, else None. A model builds it once per layer
    and passes it to every chunk's call."""
    if kernels is False or not weights[0].is_cuda:
        return None
    return pack_so2_weights(weights, packed_m_layout(m_idx)[2], int(channels))


def fused_so2_conv(h, weights, m_idx: dict, channels: int, kernels: bool = True,
                   packed=None):
    """SO(2) convolution over all |m| blocks, dispatched.

    ``h``: (E, S, C) coefficients in the model's (e3nn) order;
    ``weights``: ``[W0, W1r, W1i, ...]`` mixed (d, d) matrices per m;
    ``m_idx``: the model's per-|m| (plus, minus) index sets; ``packed``:
    ``so2_packed_weights`` of the same weights, packed here when not given.
    Returns the convolved coefficients in the SAME order. A CUDA tensor with
    ``kernels=True`` launches the kernel (or raises), forward and, for the
    input cotangent, backward; CPU tensors and ``kernels=False`` take the
    plain version and its plain VJP; no edges take the plain path, as in
    the JAX dispatcher (``:634``). The weights get cotangents only when
    they require them, from the plain VJP's products.
    """
    perm_np, inv_np, segments = packed_m_layout(m_idx)
    perm, inv = _row_tables(tuple(perm_np.tolist()), tuple(inv_np.tolist()), h.device)
    use_kernel = kernels is not False and h.is_cuda and h.shape[0] > 0
    _route(use_kernel)
    if use_kernel and packed is None:
        packed = pack_so2_weights(weights, segments, int(channels),
                                  backward=h.requires_grad)
    return _SO2Conv.apply(use_kernel, perm_np, perm, inv, segments, int(channels),
                          packed if use_kernel else None, h, *weights)
