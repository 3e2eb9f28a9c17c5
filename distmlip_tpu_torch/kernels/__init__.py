"""Hand-written CUDA kernels for the message-passing hot path.

- :mod:`segment` — ``segment_sum_cuda`` (the wrapper of
  ``csrc/segment_sum.cu``, replacing the TPU ``pallas_segment_sum``; float32
  and bf16, the bf16 plan ``segment_sum_bf16_plan``), its plain version
  ``segment_sum_reference``,
  the shared CSR row offsets and the launch counts of every kernel.
- :mod:`edge_aggregate` — ``tensornet_embed_aggregate_cuda``,
  ``tensornet_interaction_aggregate_cuda`` (on compact I/A/S node rows,
  ``tensornet_full`` assembling a 3x3 from them) and
  ``tensornet_interaction_backward_cuda`` (both cotangents in one pass over
  the edges in ``src_order``; its bf16 kernel's plan
  ``tensornet_interaction_backward_bf16_plan``; the bf16 forwards' plans
  ``tensornet_embed_bf16_plan`` and ``tensornet_interaction_bf16_plan``),
  the wrappers of
  ``csrc/edge_aggregate.cu`` (float32 and bf16, counted under ``*_bf16``), with their
  tolerances ``tensornet_embed_error_bound``,
  ``tensornet_interaction_error_bound`` and
  ``tensornet_interaction_backward_error_bound`` (float32 and bf16 data);
  and ``chgnet_atom_conv_aggregate_cuda`` and
  ``chgnet_line_aggregate_cuda`` (of ``csrc/chgnet_aggregate.cu``, with
  its row projection ``chgnet_row_projection_cuda``; float32 and bf16
  variants, the bf16 ones on the tensor cores, the tolerance
  ``chgnet_aggregate_error_bound`` with the bf16 message's
  ``chgnet_message_terms``, the bf16 kernels' bar against the float32
  kernels ``chgnet_tensor_core_error_bound`` and their launch plan
  ``chgnet_aggregate_plan``), which replace the TPU
  ``pallas_edge_aggregate`` at TensorNet's and CHGNet's call sites; their
  ``*_reference`` plain versions, the CHGNet weight packing
  ``chgnet_pack_weights`` and table plan ``chgnet_row_tables``, and the
  named messages
  ``TENSORNET_EMBED``, ``TENSORNET_INTERACTION``, ``CHGNET_ATOM_CONV`` and
  ``CHGNET_LINE_CONV``.
- :mod:`so3` — ``so2_conv_cuda`` (the wrapper of ``csrc/so2_conv.cu``,
  replacing the TPU ``so2_conv_pallas`` of eSCN), its plain version
  ``so2_conv_reference``, the packed per-|m| layout ``packed_m_layout``,
  the kernel's weight packing ``pack_so2_weights`` (K-major blocks split
  into TF32 hi and lo by ``tf32_round``; one bf16 buffer for the bf16
  kernel) and the derived kernel tolerance ``so2_conv_error_bound``; the
  bf16 kernel's launch plan ``so2_bf16_plan`` and its L2 traffic
  ``so2_bf16_l2_bytes``.
- :mod:`dispatch` — ``fused_segment_sum``, ``fused_edge_aggregate`` (with
  its ``Gather`` marker and the ``recompute_chunks`` count of its plain
  backward) and ``fused_so2_conv`` (with
  ``so2_packed_weights``, its weights packed once per layer), the autograd Functions
  every call site goes through.
- :mod:`build` — ``nvcc`` at first use into ``build/kernels/``, ctypes load.

Every TPU kernel of the JAX package has its CUDA counterpart here.
"""

from .dispatch import (Gather, fused_edge_aggregate, fused_segment_sum,  # noqa: F401
                       fused_so2_conv, kernel_routing, recompute_chunks, route_counts,
                       so2_packed_weights)
from .edge_aggregate import (CHGNET_ATOM_CONV, CHGNET_LINE_CONV,  # noqa: F401
                             PROJECTION_MAX_K, PROJECTION_MAX_M, TENSORNET_EMBED,
                             TENSORNET_INTERACTION, EdgeMessage,
                             chgnet_aggregate_error_bound, chgnet_aggregate_plan,
                             chgnet_atom_conv_aggregate_cuda,
                             chgnet_atom_conv_aggregate_reference,
                             chgnet_line_aggregate_cuda,
                             chgnet_line_aggregate_reference, chgnet_message_terms,
                             chgnet_pack_weights,
                             chgnet_projection_error_bound, chgnet_projection_plan,
                             chgnet_row_projection_cuda,
                             chgnet_row_projection_reference, chgnet_row_tables,
                             chgnet_tensor_core_error_bound, src_order, tensornet_embed_aggregate_cuda,
                             tensornet_embed_aggregate_reference, tensornet_embed_bf16_plan,
                             tensornet_embed_error_bound, tensornet_full,
                             tensornet_interaction_aggregate_cuda,
                             tensornet_interaction_aggregate_reference,
                             tensornet_interaction_backward_bf16_plan,
                             tensornet_interaction_backward_cuda,
                             tensornet_interaction_backward_error_bound,
                             tensornet_interaction_backward_reference,
                             tensornet_interaction_bf16_plan,
                             tensornet_interaction_error_bound)
from .segment import (count_launch, csr_row_offsets, launch_counts,  # noqa: F401
                      segment_sum_bf16_plan, segment_sum_cuda, segment_sum_reference)
from .so3 import (PackedSO2Weights, pack_so2_weights, packed_m_layout,  # noqa: F401
                  so2_bf16_l2_bytes, so2_bf16_plan, so2_block_matrices, so2_conv_cuda,
                  so2_conv_error_bound, so2_conv_reference, tf32_round)
