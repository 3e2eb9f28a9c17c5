"""Masked segment sum of dst-sorted rows: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``distmlip_tpu/kernels/segment.py::pallas_segment_sum``. The
kernel (``csrc/segment_sum.cu``) finds each dst row's contiguous edge range
in the sorted ids itself, so this wrapper only checks what the kernel
takes, allocates the output and launches one kernel on PyTorch's current
stream. ``csr_row_offsets`` stays for the edge-aggregate kernels and the
graph builder.

``segment_sum_cuda`` takes CUDA tensors only, float32 or bfloat16 (fp32
accumulation, each output rounded to bf16 once; rows wider than 32 columns
on 16-byte lanes, one block a dst row, ``segment_sum_bf16_plan``), and
raises on anything else;
``segment_sum_reference`` is the plain version (``masked_segment_sum``,
which accumulates half data in fp32 and rounds once too), used on the CPU
and by the on-card comparison. The dispatcher (``kernels/dispatch.py``)
chooses between them.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..ops.segment import masked_segment_sum

# launches of each kernel of the package, by name: one per kernel launch,
# and only there (a run resets them to 0 to show the main path went through
# the kernels). kernels/edge_aggregate.py adds its own names.
launch_counts = {"segment_sum": 0, "segment_sum_bf16": 0}
# serving replicas launch from their own scheduler threads, and ``+= 1`` on
# a dict entry is a read-modify-write that can lose a count when two threads
# interleave: every count goes through count_launch
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``launch_counts`` (thread-safe)."""
    with _count_lock:
        launch_counts[name] += 1


def csr_row_offsets(segment_ids, num_segments: int, mask=None):
    """(num_segments + 1,) int64 CSR offsets of nondecreasing ids on their
    device: row r owns edges [offsets[r], offsets[r + 1]) (``searchsorted``
    at ``arange(N + 1)``, the JAX package's ``dst_tile_offsets`` at tile
    size 1). With a mask, every offset is clamped to one past the last
    valid edge, so the repeated-tail padding (all masked, all on the last
    real dst row) is never walked; what it drops is masked anyway. No host
    sync."""
    ids = segment_ids.contiguous()
    bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    offsets = torch.searchsorted(ids, bounds)
    if mask is not None:
        pos = torch.arange(1, ids.shape[0] + 1, device=ids.device)
        end = torch.where(mask, pos, torch.zeros((), dtype=pos.dtype,
                                                  device=pos.device)).amax()
        offsets = torch.minimum(offsets, end)
    return offsets


def segment_sum_reference(data, segment_ids, num_segments: int, mask=None):
    """Plain PyTorch version: equal to ``masked_segment_sum``."""
    return masked_segment_sum(data, segment_ids, num_segments, mask)


def current_stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device`` (a
    card), without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_fns: dict = {}
_SYMBOLS = {torch.float32: "distmlip_segment_sum_f32",
            torch.bfloat16: "distmlip_segment_sum_bf16"}


def _lib(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from .build import load

        fn = getattr(load("segment_sum"), _SYMBOLS[dtype])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        _fns[dtype] = fn
    return fn


def segment_sum_cuda(data, segment_ids, num_segments: int, mask=None):
    """Launch the CUDA segment-sum kernel: one launch, no offsets tensor.

    ``data`` (E, ...) float32 or bfloat16, contiguous; ``segment_ids``
    (E,) int32/int64, nondecreasing (the dst-sorted layout contract — not
    checked, it would cost a device sync); ``mask`` (E,) bool or None. All
    on one CUDA device. Returns (num_segments, ...) in ``data``'s dtype,
    accumulated in float32. Raises on anything the kernel does not take,
    and when the launch is refused.
    """
    if not (isinstance(data, torch.Tensor) and data.is_cuda):
        raise ValueError("segment_sum_cuda takes CUDA tensors; use "
                         "segment_sum_reference for tensors on the CPU")
    if data.dtype not in _SYMBOLS:
        raise TypeError(f"segment_sum_cuda: data must be float32 or bfloat16, got {data.dtype}")
    if data.ndim < 1 or not data.is_contiguous():
        raise ValueError("segment_sum_cuda: data must be a contiguous (E, ...) tensor")
    dev = data.device
    e = data.shape[0]
    if (segment_ids.ndim != 1 or segment_ids.shape[0] != e
            or segment_ids.dtype not in (torch.int32, torch.int64)
            or segment_ids.device != dev):
        raise ValueError("segment_sum_cuda: segment_ids must be (E,) int32/int64 "
                         "on data's device")
    if mask is not None and (mask.ndim != 1 or mask.shape[0] != e
                             or mask.dtype != torch.bool or mask.device != dev):
        raise ValueError("segment_sum_cuda: mask must be (E,) bool on data's device")
    num_segments = int(num_segments)
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} must be >= 0")
    trailing = data.shape[1:]
    width = math.prod(trailing)
    if e == 0 or num_segments == 0 or width == 0:
        return torch.zeros((num_segments,) + tuple(trailing), dtype=data.dtype, device=dev)
    ids = segment_ids.contiguous()
    m = None if mask is None else mask.contiguous()
    out = torch.empty((num_segments,) + tuple(trailing), dtype=data.dtype, device=dev)
    args = (data.data_ptr(), ids.data_ptr(), ids.element_size(),
            None if m is None else m.data_ptr(), out.data_ptr(), e, num_segments, width)
    fn = _lib(data.dtype)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, current_stream_ptr(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, current_stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError_t {err}")
    count_launch("segment_sum" if data.dtype == torch.float32 else "segment_sum_bf16")
    return out


_BF16_PATHS = {0: "rows of 16-byte lanes, a block a dst row",
               1: "narrow, pairs", 2: "narrow, single values",
               3: "wide, pairs", 4: "wide, single values"}


def segment_sum_bf16_plan(data, segment_ids=None, out=None):
    """The plan ``segment_sum_cuda`` takes for bf16 ``data`` (E, ...) on the
    card, from the kernel library's own routing (the launch's): the path,
    elements a load, columns a warp, warps a dst row, edge rows in flight a
    warp (narrow: edges a warp step), row searches a dst row and the
    kernel's registers a thread. ``segment_ids`` gives the id width (int32
    when None); ``out`` the output (None: a fresh allocation, aligned)."""
    if not (isinstance(data, torch.Tensor) and data.is_cuda and data.dtype == torch.bfloat16):
        raise ValueError("segment_sum_bf16_plan takes a bf16 CUDA tensor")
    from .build import load

    fn = load("segment_sum").distmlip_segment_sum_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    plan = (ctypes.c_int64 * 7)()
    id_bytes = 4 if segment_ids is None else segment_ids.element_size()
    err = fn(data.data_ptr(), None if out is None else out.data_ptr(),
             math.prod(data.shape[1:]), id_bytes, plan)
    if err != 0:
        raise RuntimeError(f"segment_sum_bf16_plan failed: cudaError_t {err}")
    keys = ("path", "elements_a_load", "columns_a_warp", "warps_a_row", "edges_in_flight",
            "searches_a_row", "registers")
    result = dict(zip(keys, plan))
    result["path"] = _BF16_PATHS[result["path"]]
    return result
