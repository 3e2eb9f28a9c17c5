"""Device-memory statistics (``distmlip_tpu/utils/memory.py``).

The same functions over the CUDA caching allocator: ``bytes_in_use`` is
``torch.cuda.memory_allocated``, ``peak_bytes_in_use``
``torch.cuda.max_memory_allocated`` (the high-water mark since the process
started or since the last reset: every batched calculate and a trainer's
measured step reset it, ``device.begin_peak_measurement``; the mark across
those is ``device.peak_allocated``) and
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
        limit = int(torch.cuda.mem_get_info(i)[1])
        # one allocator query for both counters, read from its nested form:
        # memory_allocated and max_memory_allocated each build and flatten
        # the whole stats dict, which a telemetry record a step would pay
        # twice (chip_smoke.py [telemetry] times both ways)
        alloc = torch.cuda.memory_stats_as_nested_dict(i).get("allocated_bytes", {}).get("all", {})
        out[f"dev{i}_bytes_in_use"] = int(alloc.get("current", 0))
        out[f"dev{i}_peak_bytes_in_use"] = int(alloc.get("peak", 0))
        out[f"dev{i}_bytes_limit"] = limit
    return out


def hbm_usage_frac(stats: dict | None = None) -> float | None:
    """Worst card's ``bytes_in_use / bytes_limit``, or None without a
    limit (the CPU). ``stats`` lets callers reuse one snapshot (and the
    report parse recorded ``device_memory`` dicts, of either package)."""
    stats = device_memory_stats() if stats is None else stats
    worst = None
    for k, used in stats.items():
        if not k.endswith("_bytes_in_use") or "peak" in k:
            continue
        limit = stats.get(k.replace("_bytes_in_use", "_bytes_limit"), 0)
        if limit > 0:
            frac = used / limit
            worst = frac if worst is None else max(worst, frac)
    return worst


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


__all__ = ["device_memory_stats", "device_bytes_limit", "hbm_usage_frac",
           "measured_peak_bytes"]
