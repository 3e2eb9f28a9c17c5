"""Masked segment sum of dst-sorted rows: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``distmlip_tpu/kernels/segment.py::pallas_segment_sum``. The
kernel (``csrc/segment_sum.cu``) walks each dst row's contiguous edge range
given as CSR offsets; this wrapper computes those offsets on the device
(``searchsorted`` of the ids at ``arange(N + 1)``, the JAX package's
``dst_tile_offsets`` at tile size 1), checks what the kernel takes, and
launches it on PyTorch's current stream.

``segment_sum_cuda`` takes CUDA tensors only and raises on anything else;
``segment_sum_reference`` is the plain version (``masked_segment_sum``),
used on the CPU and by the on-card comparison. The dispatcher
(``kernels/dispatch.py``) chooses between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.segment import masked_segment_sum

# launches of each kernel of this module: one per kernel launch, and only
# there (a run resets it to 0 to show the main path went through the kernel)
launch_counts = {"segment_sum": 0}


def segment_sum_reference(data, segment_ids, num_segments: int, mask=None):
    """Plain PyTorch version: equal to ``masked_segment_sum``."""
    return masked_segment_sum(data, segment_ids, num_segments, mask)


def _lib():
    from .build import load

    fn = load("segment_sum").distmlip_segment_sum_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def segment_sum_cuda(data, segment_ids, num_segments: int, mask=None):
    """Launch the CUDA segment-sum kernel.

    ``data`` (E, ...) float32, contiguous; ``segment_ids`` (E,) int32/int64,
    nondecreasing (the dst-sorted layout contract — not checked, it would
    cost a device sync); ``mask`` (E,) bool or None. All on one CUDA
    device. Returns (num_segments, ...) float32. Raises on anything the
    kernel does not take, and when the launch is refused.
    """
    if not (isinstance(data, torch.Tensor) and data.is_cuda):
        raise ValueError("segment_sum_cuda takes CUDA tensors; use "
                         "segment_sum_reference for tensors on the CPU")
    if data.dtype != torch.float32:
        raise TypeError(f"segment_sum_cuda: data must be float32, got {data.dtype}")
    if data.ndim < 1 or not data.is_contiguous():
        raise ValueError("segment_sum_cuda: data must be a contiguous (E, ...) tensor")
    e = data.shape[0]
    if (segment_ids.ndim != 1 or segment_ids.shape[0] != e
            or segment_ids.dtype not in (torch.int32, torch.int64)
            or segment_ids.device != data.device):
        raise ValueError("segment_sum_cuda: segment_ids must be (E,) int32/int64 "
                         "on data's device")
    if mask is not None and (mask.ndim != 1 or mask.shape[0] != e
                             or mask.dtype != torch.bool
                             or mask.device != data.device):
        raise ValueError("segment_sum_cuda: mask must be (E,) bool on data's device")
    num_segments = int(num_segments)
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} must be >= 0")
    out_shape = (num_segments,) + tuple(data.shape[1:])
    width = data[0].numel() if e else 0
    if e == 0 or num_segments == 0 or width == 0:
        return torch.zeros(out_shape, dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        ids = segment_ids.contiguous()
        bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
        row_ptr = torch.searchsorted(ids, bounds)          # (N + 1,) int64
        out = torch.empty(out_shape, dtype=data.dtype, device=data.device)
        m = None if mask is None else mask.contiguous()
        vec = 4 if (width % 4 == 0 and data.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0) else 1
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = _lib()(data.data_ptr(), row_ptr.data_ptr(),
                     None if m is None else m.data_ptr(), out.data_ptr(),
                     num_segments, width, vec, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError_t {err}")
    launch_counts["segment_sum"] += 1
    return out
