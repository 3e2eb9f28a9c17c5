"""The SO(2) convolution of eSCN: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``distmlip_tpu/kernels/so3.py::so2_conv_pallas``. eSCN's SO(2)
convolution is, per edge, a stack of small per-|m| products over the
(+m, -m) complex coefficient pairs:

    m = 0:  y0 = f0 @ W0
    m > 0:  y+ = f+ @ Wr - f- @ Wi,   y- = f+ @ Wi + f- @ Wr

with ``f`` the (nl * C)-flattened coefficient block of that |m|. In the
packed per-m layout (``packed_m_layout``: ``[m=0 | m=1 plus | m=1 minus |
m=2 plus | ...]``) the plus and minus blocks of one |m| sit side by side,
so each m > 0 is ONE product of contraction 2d, ``[f+ | f-] @ [[Wr, Wi],
[-Wi, Wr]]``, and the whole convolution is a block-diagonal product of the
(E, S * C) rows. The kernel (``csrc/so2_conv.cu``) runs it as one tiled
GEMM over (segment, column tile) x (edge row tile) and never builds the
2d x 2d matrix.

``so2_conv_cuda`` takes CUDA tensors only and raises on anything else;
``so2_conv_reference`` is the plain version, used on the CPU and by the
on-card comparison. The dispatcher (``kernels/dispatch.py``
``fused_so2_conv``) chooses between them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .segment import launch_counts

launch_counts["so2_conv"] = 0


def packed_m_layout(m_idx: dict) -> tuple:
    """(perm, inv, segments): the packed per-m coefficient order.

    ``m_idx[m] = (plus_indices, minus_indices)`` in the source layout
    (models/escn.py ``self.m_idx``). ``perm`` gathers source -> packed,
    ``inv`` gathers packed -> source, ``segments`` lists
    ``(m, start, nl)`` static slice bounds of each packed block (for
    ``m > 0`` the minus block sits at ``start + nl``).
    """
    order = []
    segments = []
    for m in sorted(m_idx):
        plus, minus = m_idx[m]
        segments.append((m, len(order), len(plus)))
        order.extend(int(i) for i in plus)
        if m > 0:
            order.extend(int(i) for i in minus)
    perm = np.asarray(order, dtype=np.int32)
    inv = np.argsort(perm).astype(np.int32)
    return perm, inv, tuple(segments)


def so2_conv_reference(h_packed, weights, segments, channels: int):
    """Plain SO(2) convolution on packed-layout coefficients.

    ``weights`` is ``[W0, W1r, W1i, W2r, W2i, ...]`` (one (d, d) matrix
    per m=0 block, a real/imag pair per m > 0, ``d = nl * C``). Returns
    the packed-layout output.
    """
    e = h_packed.shape[0]
    c = channels
    out = []
    wi = 0
    for m, start, nl in segments:
        d = nl * c
        if m == 0:
            f = h_packed[:, start:start + nl, :].reshape(e, d)
            out.append((f @ weights[wi]).reshape(e, nl, c))
            wi += 1
        else:
            fp = h_packed[:, start:start + nl, :].reshape(e, d)
            fm = h_packed[:, start + nl:start + 2 * nl, :].reshape(e, d)
            wr, wim = weights[wi], weights[wi + 1]
            wi += 2
            out.append((fp @ wr - fm @ wim).reshape(e, nl, c))
            out.append((fp @ wim + fm @ wr).reshape(e, nl, c))
    return torch.cat(out, dim=1)


def so2_conv_error_bound(h_packed, weights, segments, channels: int):
    """Elementwise bound on |kernel - plain| in the packed layout:
    ``2 k u T`` per output, with ``k`` the contraction length (d for m = 0,
    2d for m > 0, the pair's two products summed), u = 2^-24 and ``T`` the
    sum of |terms| of that output (``|f0| @ |W0|``; ``|f+| @ |Wr| + |f-| @
    |Wi|`` for y+ and ``|f+| @ |Wi| + |f-| @ |Wr|`` for y-). Each side's
    float32 dot products are within about k u T of the exact value in any
    summation order; the plain side's two length-d products and their add
    stay within (d + 1) u T."""
    u = 2.0 ** -24
    e, c = h_packed.shape[0], channels
    ha = h_packed.abs()
    wa = [w.abs() for w in weights]
    out = []
    wi = 0
    for m, start, nl in segments:
        d = nl * c
        fp = ha[:, start:start + nl, :].reshape(e, d)
        if m == 0:
            out.append((fp @ wa[wi] * (2 * d * u)).reshape(e, nl, c))
            wi += 1
            continue
        fm = ha[:, start + nl:start + 2 * nl, :].reshape(e, d)
        wr, wim = wa[wi], wa[wi + 1]
        wi += 2
        out.append(((fp @ wr + fm @ wim) * (4 * d * u)).reshape(e, nl, c))
        out.append(((fp @ wim + fm @ wr) * (4 * d * u)).reshape(e, nl, c))
    return torch.cat(out, dim=1)


def _lib():
    from .build import load

    fn = load("so2_conv").distmlip_so2_conv_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def so2_conv_cuda(h, weights, segments, channels: int, rows):
    """Launch the CUDA SO(2)-convolution kernel.

    ``h``: (E, S, C) float32, contiguous, on a CUDA device. ``weights``:
    ``[W0, W1r, W1i, ...]`` as in ``so2_conv_reference``, (d, d) float32
    contiguous on ``h``'s device. ``segments``: ``packed_m_layout``'s.
    ``rows``: host (S,) ints, packed row i read from and written to row
    ``rows[i]`` of ``h`` and the output: the ``perm`` of
    ``packed_m_layout`` for the model's (e3nn) order, so no permuted copy
    is made; ``range(S)`` for packed input. Returns (E, S, C) float32 in
    ``h``'s order. Raises on anything the kernel does not take, and when
    the launch is refused.
    """
    if not (isinstance(h, torch.Tensor) and h.is_cuda):
        raise ValueError("so2_conv_cuda takes CUDA tensors; use so2_conv_reference "
                         "for tensors on the CPU")
    if h.dtype != torch.float32:
        raise TypeError(f"so2_conv_cuda: h must be float32, got {h.dtype}")
    if h.ndim != 3 or not h.is_contiguous():
        raise ValueError("so2_conv_cuda: h must be a contiguous (E, S, C) tensor")
    e, s, c = h.shape
    if c != channels:
        raise ValueError(f"so2_conv_cuda: h has {c} channels, expected {channels}")
    seg_m, seg_row0, seg_nl, dims = [], [], [], []
    covered = 0
    for m, start, nl in segments:
        if start != covered:
            raise ValueError(f"so2_conv_cuda: segments must tile the rows in order, "
                             f"got start {start} after {covered} rows")
        covered += nl * (1 if m == 0 else 2)
        seg_m.append(int(m))
        seg_row0.append(int(start))
        seg_nl.append(int(nl))
        dims += [nl * c] * (1 if m == 0 else 2)
    if covered != s:
        raise ValueError(f"so2_conv_cuda: segments cover {covered} rows, h has {s}")
    if len(weights) != len(dims):
        raise ValueError(f"so2_conv_cuda: {len(dims)} weight matrices expected, "
                         f"got {len(weights)}")
    for w, d in zip(weights, dims):
        if (not isinstance(w, torch.Tensor) or w.device != h.device
                or w.dtype != torch.float32 or tuple(w.shape) != (d, d)
                or not w.is_contiguous()):
            raise ValueError(f"so2_conv_cuda: each weight must be a contiguous "
                             f"({d}, {d}) float32 tensor on h's device")
    rows = np.asarray(rows, dtype=np.int32)
    if rows.shape != (s,) or not np.array_equal(np.sort(rows), np.arange(s)):
        raise ValueError("so2_conv_cuda: rows must be a permutation of range(S)")
    n_seg = len(seg_m)
    if n_seg > 7 or s > 49:
        raise ValueError("so2_conv_cuda: at most 7 |m| segments (l_max <= 6)")
    out = torch.empty_like(h)
    if e == 0:
        return out
    vec = 4 if (c % 4 == 0 and h.data_ptr() % 16 == 0
                and all(w.data_ptr() % 16 == 0 for w in weights)) else 1
    i32 = lambda xs: (ctypes.c_int * len(xs))(*xs)  # noqa: E731
    w_ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib()(h.data_ptr(), out.data_ptr(), e, s, c, n_seg, i32(seg_m),
                     i32(seg_row0), i32(seg_nl), w_ptrs, i32(rows.tolist()), vec,
                     stream)
    if err != 0:
        raise RuntimeError(f"so2_conv kernel launch failed: cudaError_t {err}")
    launch_counts["so2_conv"] += 1
    return out
