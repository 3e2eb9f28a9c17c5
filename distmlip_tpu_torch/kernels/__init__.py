"""Hand-written CUDA kernels for the message-passing hot path.

- :mod:`segment` — ``segment_sum_cuda`` (the wrapper of
  ``csrc/segment_sum.cu``, replacing the TPU ``pallas_segment_sum``), its
  plain version ``segment_sum_reference`` and the launch counts.
- :mod:`dispatch` — ``fused_segment_sum``, the autograd Function every call
  site goes through.
- :mod:`build` — ``nvcc`` at first use into ``build/kernels/``, ctypes load.

The TPU's ``pallas_edge_aggregate`` (TensorNet, CHGNet) and
``so2_conv_pallas`` (eSCN) are queued in ROADMAP.md.
"""

from .dispatch import fused_segment_sum  # noqa: F401
from .segment import (launch_counts, segment_sum_cuda,  # noqa: F401
                      segment_sum_reference)
