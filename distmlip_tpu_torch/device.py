"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA (explicitly or by default) on a machine
without a card raises.

Float32 only in this port so far: TF32 would round every float32 matrix
product and convolution to ~3 decimal digits, so the entry points turn it
off for both cuBLAS and cuDNN.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raises when CUDA is requested but absent.

    Also pins float32 math to full precision
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``).
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
    return dev
