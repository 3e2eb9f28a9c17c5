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
GEMM over (segment, column tile) x (edge row tile) on the tensor cores,
float32-exact through a 3xTF32 split. Its weight operand is the explicit
block of each segment, K-major and split into TF32 hi and lo parts,
packed on the device once per layer by ``pack_so2_weights``; the same
packing, untransposed, is the operand of the backward's input cotangent.

In bfloat16 (the models' ``compute_dtype="bfloat16"``) the kernel takes
bf16 rows and one bf16 weight buffer (no split: a bf16 product is exact in
fp32), accumulates in fp32 on the tensor cores and rounds each output to
bf16 once, as the Pallas body does (``preferred_element_type=f32``, one
``astype`` on the way out). Its schedule is its own: a persistent grid of
128 x 256 output tiles (``so2_bf16_plan``; ``so2_bf16_l2_bytes`` counts
what a plan brings from L2 into shared memory).

``so2_conv_cuda`` takes CUDA tensors only, float32 or bfloat16, and raises
on anything else; ``so2_conv_reference`` is the plain version (for bf16
inputs: the same products in fp32, rounded once), used on the CPU and by
the on-card comparison. The dispatcher (``kernels/dispatch.py``
``fused_so2_conv``) chooses between them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.segment import _HALF_DTYPES
from .segment import count_launch, launch_counts

launch_counts["so2_conv"] = 0
launch_counts["so2_conv_bf16"] = 0


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
    the packed-layout output. Half-precision inputs are computed in fp32
    and rounded once to their dtype (the kernels' and the Pallas body's
    arithmetic).
    """
    if h_packed.dtype in _HALF_DTYPES:
        out = so2_conv_reference(h_packed.float(), [w.float() for w in weights], segments,
                                 channels)
        return out.to(h_packed.dtype)
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
    ``(60 ceil(k / 8) + k + 13) u T`` per output, with ``k`` the
    contraction length (d for m = 0, 2d for m > 0, the pair's two products
    summed), u = 2^-24 and ``T`` the sum of |terms| of that output
    (``|f0| @ |W0|``; ``|f+| @ |Wr| + |f-| @ |Wi|`` for y+ and ``|f+| @
    |Wi| + |f-| @ |Wr|`` for y-).

    The kernel (3xTF32 on the tensor cores, ``csrc/so2_conv.cu``) is within
    ``(60 ceil(k / 8) + 13) u T`` of the exact value:
    - the split: each operand is x = hi + lo + r with hi = tf32(x),
      lo = tf32(x - hi), both rounded to nearest at 11 significant bits, so
      |x - hi| <= 2^-11 |x| and |r| <= 2^-22 |x|. A product is taken as
      a_hi b_hi + a_hi b_lo + a_lo b_hi; the dropped a_lo b_lo and the r
      terms stay within (3 + 2^-9) 2^-22 |ab| < 13 u |ab|: 13 u T;
    - products of TF32 values (11 x 11 significant bits) are exact in fp32;
    - the accumulation: 3 wgmma instructions per 8 contraction entries,
      3 ceil(k / 8) in all, each adding 8 products to the fp32
      accumulator. The bound does not assume round to nearest: each
      instruction's 9 addends may be aligned to the largest and truncated,
      and its sum truncated, each losing less than one ulp (2u of a
      magnitude of at most T): 20 u T an instruction, 60 ceil(k / 8) u T.

    The plain side's float32 dot products are within about k u T of the
    exact value in any summation order (the pair's two length-d products
    and their add within (d + 1) u T).

    bfloat16 inputs: products of bf16 values are exact in fp32, so there
    is no split term; one wgmma instruction per 16 entries adds 17
    addends, 36 u T each: the two fp32 sums differ by at most
    ``e = (36 ceil(k / 16) + k) u T``. Each side then rounds to bf16 once
    (to nearest: 8 significant bits, within 2^-8 of its value), so the two
    bf16 outputs differ by at most ``e + 2^-7 (|y| + e)`` (one bf16 ulp
    where the two fp32 values straddle a rounding boundary), with ``y`` the
    plain side's fp32 value."""
    u = 2.0 ** -24
    half = h_packed.dtype in _HALF_DTYPES
    e, c = h_packed.shape[0], channels
    ha = h_packed.float().abs()
    wa = [w.float().abs() for w in weights]

    def factor(k):
        if half:
            return (36 * -(-k // 16) + k) * u
        return (60 * -(-k // 8) + k + 13) * u

    out = []
    wi = 0
    for m, start, nl in segments:
        d = nl * c
        fp = ha[:, start:start + nl, :].reshape(e, d)
        if m == 0:
            out.append((fp @ wa[wi] * factor(d)).reshape(e, nl, c))
            wi += 1
            continue
        fm = ha[:, start + nl:start + 2 * nl, :].reshape(e, d)
        wr, wim = wa[wi], wa[wi + 1]
        wi += 2
        out.append(((fp @ wr + fm @ wim) * factor(2 * d)).reshape(e, nl, c))
        out.append(((fp @ wim + fm @ wr) * factor(2 * d)).reshape(e, nl, c))
    bound = torch.cat(out, dim=1)
    if half:
        y = so2_conv_reference(h_packed.float(), [w.float() for w in weights], segments, c)
        bound = bound + 2.0 ** -7 * (y.abs() + bound)
    return bound


def tf32_round(x):
    """``x`` (float32) rounded to TF32, 10 explicit mantissa bits, to
    nearest with ties away from zero: what ``cvt.rna.tf32.f32`` does in the
    kernel. Works on the bit pattern, so it is exact on any device."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def so2_block_matrices(weights, segments):
    """The (width, width) block of each segment: ``W0`` for m = 0,
    ``[[Wr, Wi], [-Wi, Wr]]`` for m > 0, so that the packed rows of a
    segment times its block is the convolution."""
    blocks, wi = [], 0
    for m, _, _ in segments:
        if m == 0:
            blocks.append(weights[wi])
            wi += 1
        else:
            wr, wim = weights[wi], weights[wi + 1]
            wi += 2
            blocks.append(torch.cat([torch.cat([wr, wim], 1), torch.cat([-wim, wr], 1)], 0))
    return blocks


def _k_block(dtype) -> int:
    """Contraction entries in one 128-byte swizzled row of the kernel's
    stage: 32 float32 entries, 64 bfloat16 ones."""
    return 64 if dtype == torch.bfloat16 else 32


def _block_layout(segments, channels: int, k_block: int = 32):
    """Per segment ``(offset, width, npad, kpad)`` in each part of the
    packed buffer (entries), and the part's size: width rounded up to the
    kernel's 128 output columns (npad) and to its ``k_block`` contraction
    entries a stage (kpad: 32 in float32, 64 in bfloat16)."""
    layout, off = [], 0
    for m, _, nl in segments:
        w = nl * channels * (1 if m == 0 else 2)
        npad, kpad = -(-w // 128) * 128, -(-w // k_block) * k_block
        layout.append((off, w, npad, kpad))
        off += npad * kpad
    return tuple(layout), off


@functools.lru_cache(maxsize=4)
def _pack_index(segments: tuple, channels: int, backward: bool, device, k_block: int = 32):
    """Gather table of the packing, made once per layout and device (the
    last 4 kept; a model uses one): entry i of direction r's buffer half
    takes ``src[index[r, i]]``, with ``src`` the flattened weights, then the
    same negated, then one zero (the padding). Direction 0 is each segment's K-major block B^T (element
    (n, k) = B[k, n]); direction 1, when ``backward``, is B itself, the
    K-major form of the transposed set's block."""
    layout, total = _block_layout(segments, channels, k_block)
    sizes = [(nl * channels) ** 2 for m, _, nl in segments for _ in range(1 if m == 0 else 2)]
    w_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    n_w = int(sum(sizes))
    zero = 2 * n_w
    dirs = (True, False) if backward else (True,)
    index = np.full((len(dirs), total), zero, dtype=np.int32)
    wi = 0
    for (off, w, npad, kpad), (m, _, nl) in zip(layout, segments):
        d = nl * channels
        rows, cols = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
        for r, transpose in enumerate(dirs):
            k, n = (cols, rows) if transpose else (rows, cols)  # block element B[k, n]
            if m == 0:
                src = w_off[wi] + k * d + n
            else:
                kq, nq = k >= d, n >= d
                kk, nn = np.where(kq, k - d, k), np.where(nq, n - d, n)
                # [[Wr, Wi], [-Wi, Wr]]: Wr on the diagonal quadrants, Wi
                # above, -Wi (the negated copy) below
                src = np.where(kq == nq, w_off[wi], w_off[wi + 1]) + kk * d + nn
                src = np.where(kq & ~nq, src + n_w, src)
            index[r, off:off + npad * kpad].reshape(npad, kpad)[:w, :w] = src
        wi += 1 if m == 0 else 2
    return torch.as_tensor(index.reshape(-1), device=device)  # int32: half the memory


@dataclass(frozen=True)
class PackedSO2Weights:
    """The SO(2) weights in the kernel's form, built by ``pack_so2_weights``.

    ``fwd`` is a (2, total) float32 buffer, the TF32 hi parts then the lo
    parts, holding per segment at ``layout[i][0]`` the K-major block B^T
    ((npad, kpad) row-major, zero past the width): the operand of
    ``y = f B``. In bfloat16 it is a (1, total) bf16 buffer of the blocks
    themselves (kpad a multiple of 64). ``bwd`` holds B the same way: the operand of the input
    cotangent ``g B^T``, which is the same convolution on the transposed
    weight set (W0^T; Wr^T and -Wi^T per m). ``transposed()`` swaps the
    two. ``bwd`` is None when no backward was asked for."""

    fwd: torch.Tensor
    bwd: torch.Tensor | None
    layout: tuple

    def transposed(self) -> "PackedSO2Weights":
        if self.bwd is None:
            raise ValueError("PackedSO2Weights: packed without the backward's blocks")
        return PackedSO2Weights(self.bwd, self.fwd, self.layout)


def pack_so2_weights(weights, segments, channels: int, backward: bool = True):
    """Pack ``[W0, W1r, W1i, ...]`` for the kernel: once per layer, on the
    weights' device, in a dozen plain torch ops (one gather through
    ``_pack_index``, then the TF32 split); no gradient flows through it,
    the dispatcher keeps the weights themselves for their cotangents.
    bfloat16 weights pack into one bf16 buffer, no split."""
    dtype = weights[0].dtype
    k_block = _k_block(dtype)
    with torch.no_grad():
        flat = torch.cat([w.detach().float().reshape(-1) for w in weights])
        src = torch.cat([flat, -flat, flat.new_zeros(1)])
        index = _pack_index(tuple(segments), int(channels), bool(backward), flat.device,
                            k_block)
        blocks = src.index_select(0, index).view(2 if backward else 1, -1)
        if dtype == torch.bfloat16:
            packed = blocks.to(torch.bfloat16)[:, None]
        else:
            hi = tf32_round(blocks)
            packed = torch.stack([hi, tf32_round(blocks - hi)], dim=1)
    layout = _block_layout(segments, channels, k_block)[0]
    return PackedSO2Weights(packed[0], packed[1] if backward else None, layout)


_SYMBOLS = {torch.float32: "distmlip_so2_conv_f32", torch.bfloat16: "distmlip_so2_conv_bf16"}


def so2_bf16_l2_bytes(e: int, widths, tile_rows: int = 128, tile_cols: int = 256) -> tuple:
    """(A bytes, B bytes) that the bf16 kernel brings from L2 (or HBM) into
    shared memory for one call at E edge rows and the segments' ``widths``
    (d for m = 0, 2d for m > 0), for an output tile of ``tile_rows`` x
    ``tile_cols``: A, each segment's E x width bf16 entries once per column
    tile of the segment (rows past E are TMA zero fill, not read); B, each
    segment's packed block (width rounded up to 128 rows of width rounded
    up to 64 entries) once per row tile. The first bf16 design (192 x 128
    tiles) moved 2.03 GB at (32768, 25, 128); this one (128 x 256) 1.85 GB."""
    row_tiles = -(-e // tile_rows)
    a = sum(2 * e * w * -(-w // tile_cols) for w in widths)
    b = sum(2 * row_tiles * -(-w // 128) * 128 * -(-w // 64) * 64 for w in widths)
    return a, b


def so2_bf16_plan(e: int, segments, channels: int, device=None) -> dict:
    """The bf16 kernel's launch plan at E edge rows, ``segments`` and C on
    ``device`` (a card), as ``so2_conv_cuda`` launches it on contiguous,
    16-byte aligned h: ``tile_rows`` x ``tile_cols`` output tiles,
    ``row_tiles`` x ``col_tiles`` tiles walked as ``tiles`` (row tile,
    column tile) pairs by ``blocks`` blocks (one an SM at most),
    ``a_mode`` (0 TMA, 1 16-byte copies, 2 element copies), ``stages``; and
    ``l2_bytes_a`` / ``l2_bytes_b`` (``so2_bf16_l2_bytes``)."""
    keys = ("tile_rows", "tile_cols", "row_tiles", "col_tiles", "tiles", "blocks", "a_mode",
            "stages")
    seg_m = [int(m) for m, _, _ in segments]
    seg_nl = [int(nl) for _, _, nl in segments]
    out = (ctypes.c_int64 * len(keys))()
    fn = _plan_fn()
    with torch.cuda.device(device):
        err = fn(e, channels, len(seg_m), (ctypes.c_int * len(seg_m))(*seg_m),
                 (ctypes.c_int * len(seg_nl))(*seg_nl), 8 if channels % 8 == 0 else 1, out)
    if err != 0:
        raise RuntimeError(f"so2_conv bf16 plan failed: cudaError_t {err}")
    plan = dict(zip(keys, out))
    widths = [nl * channels * (1 if m == 0 else 2) for m, nl in zip(seg_m, seg_nl)]
    plan["l2_bytes_a"], plan["l2_bytes_b"] = so2_bf16_l2_bytes(
        e, widths, plan["tile_rows"], plan["tile_cols"])
    return plan


@functools.lru_cache(maxsize=None)
def _plan_fn():
    from .build import load

    fn = load("so2_conv").distmlip_so2_conv_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _lib(dtype):
    from .build import load

    fn = getattr(load("so2_conv"), _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    if dtype == torch.float32:
        args.append(ctypes.c_int64)  # the size of one part (hi, lo) of the buffer
    fn.argtypes = args + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def so2_conv_cuda(h, weights, segments, channels: int, rows, packed=None):
    """Launch the CUDA SO(2)-convolution kernel.

    ``h``: (E, S, C) float32 or bfloat16, contiguous, on a CUDA device.
    ``weights``: ``[W0, W1r, W1i, ...]`` as in ``so2_conv_reference``,
    (d, d) in ``h``'s dtype on ``h``'s device. ``segments``:
    ``packed_m_layout``'s. ``rows``: host (S,) ints, packed row i read from
    and written to row ``rows[i]`` of ``h`` and the output: the ``perm`` of
    ``packed_m_layout`` for the model's (e3nn) order, so no permuted copy
    is made; ``range(S)`` for packed input. ``packed``: the weights'
    ``pack_so2_weights`` (the kernel reads its ``fwd`` buffer); packed here
    when not given. Returns (E, S, C) in ``h``'s dtype and order (bf16:
    accumulated in fp32, rounded once). Raises on anything the kernel does
    not take, and when the launch is refused.
    """
    if not (isinstance(h, torch.Tensor) and h.is_cuda):
        raise ValueError("so2_conv_cuda takes CUDA tensors; use so2_conv_reference "
                         "for tensors on the CPU")
    if h.dtype not in _SYMBOLS:
        raise TypeError(f"so2_conv_cuda: h must be float32 or bfloat16, got {h.dtype}")
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
                or w.dtype != h.dtype or tuple(w.shape) != (d, d)):
            raise ValueError(f"so2_conv_cuda: each weight must be a ({d}, {d}) {h.dtype} "
                             f"tensor on h's device")
    rows = np.asarray(rows, dtype=np.int32)
    if rows.shape != (s,) or not np.array_equal(np.sort(rows), np.arange(s)):
        raise ValueError("so2_conv_cuda: rows must be a permutation of range(S)")
    n_seg = len(seg_m)
    if n_seg > 7 or s > 49:
        raise ValueError("so2_conv_cuda: at most 7 |m| segments (l_max <= 6)")
    if packed is None:
        packed = pack_so2_weights(weights, segments, c, backward=False)
    layout, total = _block_layout(segments, c, _k_block(h.dtype))
    parts = 2 if h.dtype == torch.float32 else 1
    buf = packed.fwd
    if (packed.layout != layout or buf.device != h.device or buf.dtype != h.dtype
            or tuple(buf.shape) != (parts, total) or not buf.is_contiguous()
            or buf.data_ptr() % 16 != 0):
        raise ValueError("so2_conv_cuda: packed weights do not match the segments, "
                         "the channels, h's dtype or h's device")
    out = torch.empty_like(h)
    if e == 0:
        return out
    # elements a 16-byte copy of the edge rows: 4 float32, 8 bfloat16
    per16 = 16 // h.element_size()
    vec = per16 if (c % per16 == 0 and h.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0) else 1
    i32 = lambda xs: (ctypes.c_int * len(xs))(*xs)  # noqa: E731
    offsets = (ctypes.c_int64 * n_seg)(*(blk[0] for blk in layout))
    head = (h.data_ptr(), out.data_ptr(), e, s, c, n_seg, i32(seg_m), i32(seg_row0),
            i32(seg_nl), buf.data_ptr())
    size = (total,) if parts == 2 else ()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib(h.dtype)(*head, *size, offsets, i32(rows.tolist()), vec, stream)
    if err == -1:
        raise RuntimeError("so2_conv kernel: the CUDA driver has no cuTensorMapEncodeTiled")
    if err == -2:
        raise RuntimeError("so2_conv kernel: the driver refused a TMA tensor map (of the "
                           "packed weights or of h)")
    if err != 0:
        raise RuntimeError(f"so2_conv kernel launch failed: cudaError_t {err}")
    count_launch("so2_conv" if h.dtype == torch.float32 else "so2_conv_bf16")
    return out
