"""Masked segment reductions for padded graphs (plain PyTorch).

All graph aggregation goes through these or through the kernel dispatcher
(``kernels/dispatch.py``), whose plain path this is: messages on padded
(invalid) edges are screened by the mask, so static-shape padding never
corrupts results. Padding contract (``partition/graph.py``): padded
``dst``/``segment_ids`` rows repeat the LAST REAL value — keeping the index
arrays nondecreasing and in-bounds — never 0 and never ``num_segments``.
"""

from __future__ import annotations

import torch

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def masked_segment_sum(data, segment_ids, num_segments: int, mask=None):
    """segment_sum with an optional validity mask on the data rows.

    Masked rows are screened with a select (``torch.where``), so a
    non-finite value in a padded row cannot leak into the sum. Ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops
    them. Half-precision data accumulates in fp32 and rounds once on the
    way out; full-precision data accumulates as-is.
    """
    dtype = data.dtype
    acc_dtype = torch.float32 if dtype in _HALF_DTYPES else dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=acc_dtype, device=data.device)
    if num_segments == 0 or data.shape[0] == 0:
        return out.to(dtype)
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        valid = valid & mask
    valid = valid.reshape(valid.shape + (1,) * (data.ndim - 1))
    rows = torch.where(valid, data.to(acc_dtype),
                       torch.zeros((), dtype=acc_dtype, device=data.device))
    out.index_add_(0, ids.clamp(0, num_segments - 1), rows)
    return out.to(dtype)
