"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA (explicitly or by default) on a machine
without a card raises.

TF32 would round every float32 matrix product and convolution to ~3
decimal digits, so the entry points turn it off for both cuBLAS and cuDNN.
The bfloat16 compute path (MACE, eSCN) accumulates every product in fp32,
as the TPU does: cuBLAS's reduced-precision reduction for bf16 (split-K
partial sums rounded to bf16, PyTorch's default) is turned off too.
"""

from __future__ import annotations

import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when CUDA is requested but absent.

    Also pins float32 math to full precision
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``) and bf16 products to fp32
    accumulation (``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction = False``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "distmlip_tpu_torch: CUDA was requested (device="
            f"{device!r}) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


_phase_locks: dict = {}
_phase_locks_guard = threading.Lock()


def device_phase_key(device) -> tuple:
    """``(type, index)`` of a device, ``cuda`` without an index resolved
    to the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index or 0)


def device_phase(device) -> threading.RLock:
    """The lock that serializes the device work of everything in this
    process that measures the device's memory on ``device``.

    Serving replicas share one card, each on its own scheduler thread, and
    the card's allocator counters (``torch.cuda.memory_allocated`` /
    ``max_memory_allocated``) are process-wide: a batch's peak read while a
    second replica allocates would count the other's work, and a trainer's
    peak reset would cut a replica's measurement short.
    ``BatchedPotential`` (upload, force program, copy back), the ensemble
    lane and the ``Trainer`` (its measured step, its steps and its evals)
    take this lock around their device work, so a measured peak covers one
    participant's work (``begin_peak_measurement``); host work (packing,
    neighbor search) runs outside it and still overlaps. Re-entrant, one per
    device."""
    key = device_phase_key(device)
    with _phase_locks_guard:
        lock = _phase_locks.get(key)
        if lock is None:
            lock = _phase_locks[key] = threading.RLock()
        return lock


# the allocator's high-water mark from before each measured phase's reset,
# per card, so that peak_allocated still reads the mark since reset_peak
_high_water: dict = {}


def begin_peak_measurement(device) -> int:
    """Start measuring one phase's own peak on a CUDA ``device`` (the caller
    holds ``device_phase(device)``): resets the allocator's high-water mark,
    keeping the mark it had for ``peak_allocated``. Returns the bytes
    allocated now; ``torch.cuda.max_memory_allocated`` after the phase, less
    that, is the phase's own peak, whatever ran before it."""
    key = device_phase_key(device)
    with _phase_locks_guard:
        _high_water[key] = max(_high_water.get(key, 0),
                               int(torch.cuda.max_memory_allocated(device)))
    torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.memory_allocated(device))


def reset_peak(device=None) -> None:
    """Reset the card's high-water mark that ``peak_allocated`` reads."""
    key = device_phase_key("cuda" if device is None else device)
    with _phase_locks_guard:
        _high_water.pop(key, None)
    torch.cuda.reset_peak_memory_stats(device)


def peak_allocated(device=None) -> int:
    """The card's allocated high-water mark since the process started or
    the last ``reset_peak``, across the resets of measured phases
    (``begin_peak_measurement``), which ``torch.cuda.max_memory_allocated``
    alone does not see past."""
    key = device_phase_key("cuda" if device is None else device)
    with _phase_locks_guard:
        before = _high_water.get(key, 0)
    return max(before, int(torch.cuda.max_memory_allocated(device)))
