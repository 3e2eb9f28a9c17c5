"""Kernel dispatch: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors or ``kernels=False``.

Every kernel call site goes through here, never through ``segment`` directly.
The routing is by where the tensors live and by semantics — there is no
fallback: a CUDA tensor with ``kernels=True`` launches the kernel or raises.

``fused_segment_sum`` is a ``torch.autograd.Function``: its backward is the
transpose of a masked segment sum, the gather ``g[ids] * mask``
(``distmlip_tpu/kernels/dispatch.py:220-240``), written in differentiable
torch ops so a later double backward (force-loss training) works.
"""

from __future__ import annotations

import torch

from ..ops.segment import masked_segment_sum
from .segment import segment_sum_cuda, segment_sum_reference


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, mask, num_segments, use_kernel):
        fn = segment_sum_cuda if use_kernel else segment_sum_reference
        out = fn(data, segment_ids, num_segments, mask)
        ctx.save_for_backward(segment_ids, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        segment_ids, mask = ctx.saved_tensors
        gd = g.index_select(0, segment_ids)
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
        return masked_segment_sum(data, segment_ids, num_segments, mask)
    use_kernel = kernels is not False and data.is_cuda
    return _SegmentSum.apply(data, segment_ids, mask, int(num_segments),
                             use_kernel)
