"""Device-memory statistics (``distmlip_tpu/utils/memory.py``).

The same functions over the CUDA caching allocator: ``bytes_in_use`` is
``torch.cuda.memory_allocated``, ``peak_bytes_in_use``
``torch.cuda.max_memory_allocated`` (the high-water mark since the process
started or since the last ``torch.cuda.reset_peak_memory_stats``) and
``bytes_limit`` the card's total memory from ``torch.cuda.mem_get_info``.
Without a card every function degrades to ``{}`` / ``None``, as the JAX
versions do on a backend that reports no limit. With one, an error of the
CUDA runtime raises: the trainer's memory gate reads its budget here and
must not be switched off by a failed query."""

from __future__ import annotations

import torch


def device_memory_stats() -> dict:
    """Per-card ``dev<i>_bytes_in_use``, ``dev<i>_peak_bytes_in_use`` and
    ``dev<i>_bytes_limit``; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"dev{i}_bytes_in_use"] = int(torch.cuda.memory_allocated(i))
        out[f"dev{i}_peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(i))
        out[f"dev{i}_bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
    return out


def measured_peak_bytes(stats: dict | None = None) -> int | None:
    """Worst card's peak residency (``peak_bytes_in_use``, else
    ``bytes_in_use``); None without a card. The peak is the allocator's
    high-water mark since the process started or its last reset, not the
    last step's alone."""
    stats = device_memory_stats() if stats is None else stats
    peaks = [v for k, v in stats.items() if k.endswith("_peak_bytes_in_use")]
    if peaks:
        return max(peaks)
    used = [v for k, v in stats.items() if k.endswith("_bytes_in_use") and "peak" not in k]
    return max(used) if used else None


def device_bytes_limit(stats: dict | None = None) -> int | None:
    """Smallest card's total memory: the budget memory-aware callers plan
    against; None without a card."""
    stats = device_memory_stats() if stats is None else stats
    limits = [v for k, v in stats.items() if k.endswith("_bytes_limit")]
    return min(limits) if limits else None


__all__ = ["device_memory_stats", "device_bytes_limit", "measured_peak_bytes"]
