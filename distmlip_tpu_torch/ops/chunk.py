"""Edge-chunked loops shared by the models.

Models bound per-edge memory by looping over fixed-size edge chunks
(MACE's density projection). The padding contract matches ops/segment.py:
padded index rows repeat the LAST real value so dst stays nondecreasing
(padding is masked).

``chunk_layout`` is the JAX package's (``distmlip_tpu/ops/chunk.py:18``)
verbatim; ``scan_accumulate`` there is a ``lax.scan`` and here a Python loop
whose chunk bodies run under ``torch.utils.checkpoint`` when ``remat`` is
set, so the backward keeps one chunk's intermediates at a time instead of
every chunk's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def chunk_layout(e_cap: int, chunk: int, e_split: int | None = None):
    """Row-gather chunk layout for edge loops, aligned to the
    interior/frontier boundary.

    Returns ``(row_index, row_valid, K, chunk)``: take chunk ``k`` of each
    input as ``x[row_index][k*chunk:(k+1)*chunk]`` and AND ``row_valid``
    into the edge mask. With an active split (``0 <= e_split < e_cap``) the
    two segments are padded to chunk multiples INDEPENDENTLY, so no chunk
    ever straddles the boundary and every chunk's dst rows stay
    nondecreasing. Padding rows repeat each segment's last row (sorted,
    in-bounds, masked out by ``row_valid``).
    """
    if e_cap == 0:
        return (np.zeros(0, np.int32), np.zeros(0, bool), 1, 0)
    if e_split is not None and 0 <= e_split < e_cap:
        segments = [(0, e_split), (e_split, e_cap)]
    else:
        segments = [(0, e_cap)]
    longest = max(b - a for a, b in segments)
    chunk = longest if chunk <= 0 else min(chunk, longest)
    idx, valid = [], []
    for a, b in segments:
        n = b - a
        if n == 0:
            continue
        pad = -(-n // chunk) * chunk - n
        idx.append(np.arange(a, b, dtype=np.int32))
        valid.append(np.ones(n, dtype=bool))
        if pad:
            idx.append(np.full(pad, b - 1, dtype=np.int32))
            valid.append(np.zeros(pad, dtype=bool))
    row_index = np.concatenate(idx)
    row_valid = np.concatenate(valid)
    return row_index, row_valid, len(row_index) // chunk, chunk


def remat_wrap(body, remat: bool):
    """``body`` itself (``remat=False``) or ``body`` under a non-reentrant
    ``torch.utils.checkpoint`` (``remat=True``): its intermediates are
    dropped after the forward and recomputed in the backward. The JAX
    package's checkpoint-policy names (``"dots"``) are not ported."""
    if remat is False:
        return body
    if remat is not True:
        raise NotImplementedError(
            f"remat={remat!r}: only True/False are ported (checkpoint "
            "policies are queued in ROADMAP.md)")

    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return wrapped


def scan_accumulate(body, xs, K: int, *, remat: bool):
    """Sum ``body(*xs_k)`` over chunks ``k < K``; ``xs`` are tensors with a
    leading ``K * chunk`` axis, cut into K equal slices.

    The body is checkpointed whenever ``remat`` — including for K == 1, so
    a system just under one chunk keeps the same bounded backward memory as
    one just over.
    """
    b = remat_wrap(body, remat)
    acc = None
    for k, parts in enumerate(zip(*(torch.chunk(x, K) for x in xs))):
        out = b(*parts)
        acc = out if k == 0 else acc + out
    return acc
