"""DistMLIP in PyTorch on CUDA: the port of ``distmlip_tpu`` to one NVIDIA
Hopper card.

Mirrors the JAX package's module layout (``geometry``, ``neighbors``,
``partition``, ``ops``, ``kernels``, ``parallel``, ``models``,
``calculators``, ``utils``) so each counterpart is easy to find. This
package imports ``torch`` and numpy only: never ``jax`` and nothing of
``distmlip_tpu`` (it keeps its own copies of the numpy modules it needs).

Entry points (``DistPotential``) run on CUDA unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
The TPU Pallas kernels on the evaluated path are rewritten as CUDA C++ for
``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first use; the host
neighbor search and slab partitioner are C++/OpenMP (``neighbors/src``),
built with g++ at first use.

Dtype policy (reference: DistMLIP/__init__.py:9-33): a process-global
default float/int width for host-side graph arrays, and a global compute
dtype (``set_compute_dtype``) that ``DistPotential`` applies to models with
a compute-dtype switch: MACE, eSCN, TensorNet and CHGNet run bfloat16;
the pair potential ignores it.
"""

from __future__ import annotations

import numpy as np

__version__ = "0.1.0"

# ---------------------------------------------------------------------------
# Global dtype registry.
#
# float_np/int_np: host-side (numpy) graph arrays.
# Neighbor search always runs in float64 on the host regardless of this
# setting (matches the reference's C layer, fpis.c).
# ---------------------------------------------------------------------------
float_np = np.float32
int_np = np.int32
_compute_dtype = "float32"  # "float32" | "bfloat16"


def set_default_dtype(type_: str = "float", size: int = 32) -> None:
    """Set the process-global default dtypes (reference
    DistMLIP/__init__.py:15-33): numpy dtypes used for graph arrays."""
    global float_np, int_np
    if type_ != "float":
        raise ValueError(f"Unsupported type {type_!r}; only 'float'.")
    if size == 32:
        float_np, int_np = np.float32, np.int32
    elif size == 64:
        float_np, int_np = np.float64, np.int64
    else:
        raise ValueError(f"Unsupported float size {size}; use 32 or 64.")


def set_compute_dtype(name: str) -> None:
    """Set the on-device compute dtype ("float32" or "bfloat16")."""
    global _compute_dtype
    if name not in ("float32", "bfloat16"):
        raise ValueError(name)
    _compute_dtype = name


def compute_dtype():
    import torch

    return torch.bfloat16 if _compute_dtype == "bfloat16" else torch.float32


from . import geometry  # noqa: E402,F401
