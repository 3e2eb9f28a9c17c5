#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``distmlip_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

Phases (each failure raises, so the exit code is non-zero):

1. environment — the card's name, power limit and UUID (``nvidia-smi``) and
   the host name, torch and CUDA versions, both TF32 flags (off: float32
   math stays float32) and the bf16 reduced-precision reduction flag (off:
   bf16 products accumulate in fp32);
2. build — ``nvcc`` compiles every kernel under
   ``distmlip_tpu_torch/kernels/csrc`` (one process per source, in
   parallel) into ``build/kernels``, and prints each kernel's registers,
   spills and shared memory (``-Xptxas -v``);
3. kernels vs plain — each kernel's wrapper on card tensors at the shapes
   the main paths give it, held against its plain PyTorch version with the
   stated tolerance, plus edge cases; times of the kernel, the plain
   version, one library call and the least time the card could take. The
   segment sum at MACE's chunk shapes; the two TensorNet edge aggregations
   on the graph of the TensorNet path's 16384-atom structure (the
   interaction on compact I/A/S rows, tolerance
   ``kernels.tensornet_interaction_error_bound``), and the interaction's
   backward kernel there and on the edge cases (all four cotangents within
   ``kernels.tensornet_interaction_backward_error_bound``, 2 (k + 3) u T;
   timed against today's plain chunked recompute and against one
   ``index_add_`` of the (E, 10 C) node-row cotangent by src); the two
   CHGNet aggregations (``[kernels] chgnet``) on the graph of the CHGNet
   path's structure at its real ids (``edge_dst`` under ``in_r`` for the
   atom conv, ``line_dst`` under ``line_ok`` for the line conv) with random
   inputs and weights at C = H = 64, then all-masked, the padding-only tail
   on one dst row, E not a multiple of any block, empty dst rows, C = 16
   and C = 7, H != C (64/32, 24/64, 16/12), NaN in the node and bond rows
   no valid edge gathers, distinct tensors at the two gathered ends, and
   the atom conv without abw. Each wrapper's time includes its row
   projections (the gathered segments' layer-1 products, once per node or
   bond row), which are also timed alone at the same shapes and held
   against ``x @ w + b`` within ``kernels.chgnet_projection_error_bound``
   (2 (K + 2) u on each dot product's sum of |terms|; library call one
   ``addmm``). Their tolerance is derived in
   ``kernels.chgnet_aggregate_error_bound``: first-order rounding of both
   layers' dot products (K + 2) u, the activations' slopes and ulps, the
   gating products and the k-term dst sum, for each side. The SO(2)
   kernel (``[kernels] so2_conv``, 3xTF32 on the tensor cores) at the eSCN
   path's chunk shape (32768, 25, 128) with l_max-4 weights from a seed,
   reading and writing the e3nn order through its row table with the
   weights packed once, as the model calls it, forward and on the
   backward's route (the transposed weight set against the plain VJP's
   input cotangent), then at E of 1, 37 and 1003 for l_max 1, 2, 4, 6 and
   C 8, 16, 128, and C = 7 (the 4-byte-copy path); tolerance
   ``kernels.so2_conv_error_bound``, |kernel - plain| <= (60 ceil(k / 8) +
   k + 13) u (|f| @ |W|) with k the contraction length (d, or 2d for
   m > 0) and u = 2^-24: the split, the tensor cores' fp32 accumulation
   without assuming round to nearest, and the plain side. Its bound is the
   3xTF32 one (3 x operations at 495 TFLOP/s), with the float32-core one
   beside it; the weight packing is timed alone. The segment sum also at
   eSCN's (32768, 25 * 128) row width, and across a width sweep (1, 2, 3,
   4, 8, 16, 31, 32, 33, 100, 800 and 3200 floats, int32 and int64 ids
   checked) on one chunk's ids and mask. Every timed shape of the segment
   sum and of the row projection carries its call ms (CUDA events over
   back-to-back calls), the kernel alone (``torch.profiler`` device time),
   the host µs per call (host clock, no sync) and the library call timed
   the same three ways (``distmlip_tpu_torch/tools/kernel_ab.py``);
2b. the host graph build (``[host-graph]``) — the native C++/OpenMP
   neighbor search (built by g++, its first call apart) against the numpy
   search on bench.py's 16,384-atom Si crystal at 5.5 Å and at 6.5 / 3.5
   Å and on ``[relax-chgnet]``'s 864 Li, sorted edge sets equal and
   distances within 1e-10 Å; the native slab plans against the numpy ones
   at P = 2 and 4 with and without bonds, every field equal; the first
   call and the median of 5 warm calls of each, and the host's CPU;
4. the MACE path — MACE at the MACE-MP-0-medium widths (channels 128,
   l_max = a_lmax = 3, correlation 3, 2 interactions; random weights from
   seed 0) through ``DistPotential(device="cuda", skin=0.5)`` on a
   2048-atom Si crystal: one calculate plus 3 MD-like steps. The kernels'
   launch counts are set to 0 just before and read just after, and must
   equal the count derived from the code. The same 4 geometries through a
   ``kernels=False`` potential on the card are the reference;
4b. ``[main-zbl]`` — the same with ``zbl=True`` (MACE-MP-0b's ZBL pair
   term): 2 interactions x 2K + 1 width-1 segment sums per calculate,
   against ``kernels=False`` at the repo's bar; the width-1 call alone
   against its plain version, ``index_add_`` and its bound; a small MACE
   on 32 Si packed to 2.19 Å (where the pair term is not 0) against
   ``kernels=False`` and the CPU;
5. the TensorNet path — TensorNet at the matgl TensorNet-MatPES-PBE layout
   (89 species, 64 channels, 32 RBF, 2 layers, cutoff 5 Å; random weights
   from seed 0) on bench.py's 16384-atom Si crystal, the same way. Launches
   derived: per calculate 1 embed, one interaction forward per layer and
   one interaction backward kernel per layer (the force program's backward
   runs outside grad mode); the plain backward recompute
   (``kernels.recompute_chunks``) runs ceil(e_cap / 32768) chunks per
   calculate for the embed and none for the interaction;
6. the CHGNet path (``[main-chgnet]``) — CHGNet at the matgl MPtrj layout
   (89 species, 64 units, 31 RBF, max_f 4, 4 blocks, cutoff 6 Å, bond
   cutoff 3 Å; random weights from seed 0, ``species_ref`` and
   ``data_std`` off their defaults) through ``DistPotential(device="cuda",
   skin=0.5, compute_magmom=True)`` on bench.py's 16384-atom Si crystal, the
   same way, magmoms held to max |dm| < 1e-4 too. Launches derived: each
   calculate runs one atom-conv aggregation per block (4) and one line
   aggregation per bond block (num_blocks - 1 = 3); the backward is the
   plain chunked recompute and launches none. 4 calculates give 16 and 12,
   and 40 row projections (one per atom conv, two per line conv);
7. the eSCN path (``[main-escn]``) — eSCN at the single-chip UMA widths
   (channels 128, l_max 4, 2 layers, 8 experts, cutoff 5 Å; random weights
   from seed 0, ``species_ref`` off its default) with charge 1, spin 1 and
   dataset 2 through ``DistPotential(device="cuda", skin=0.5)`` on the
   2048-atom Si crystal, the same way. Launches derived: per calculate, K
   edge chunks forward and K recomputes of the checkpointed chunk bodies in
   the backward, and the SO(2) kernel once more per chunk for its input
   cotangent, so the SO(2) kernel runs 2 layers x 3K and the segment sum 3
   scans (the edge-degree pass and 2 layers) x 2K;
8. a small structure of each model on the card (kernels) against the CPU
   (plain), CHGNet's with magmoms, eSCN's with conditioning set;
9. the end of the main path, ``MolecularDynamics`` and ``Relaxer``
   (``examples/01_static_and_md.py``, ``02_relax_chgnet.py``), each with
   every launch count set to 0 just before its driver is made and read
   after its last step, and held to a count derived per calculate:
   ``[md]`` MACE at the MACE-MP-0-medium widths on the 2048-atom crystal
   (``skin=0.5``; Maxwell-Boltzmann velocities at 600 K, 60 ``nvt_bussi``
   steps, seed 0, of 0.35 fs: random weights make a potential that
   collapses the crystal at 2 fs); ``[md-tensornet]`` TensorNet at the
   MatPES layout on the 16384-atom crystal, 40 such steps of 2 fs, then
   the same 40 with ``device_rebuild=False``; ``[relax-chgnet]`` CHGNet at the MPtrj layout
   with magmoms on 864 Li (cell x 1.02, 0.08 Å noise, seed 1), FIRE with
   the cell relaxed, 30 steps (``RELAX_TOL``), a host rebuild at every
   step. Each prints step ms by what the skin cache did (median of hits,
   device refreshes, host rebuilds), atoms/s, the refresh's ms, the host
   build's s, the rebuild counters, the largest displacement per step and
   peak memory; it fails on a non-finite value, on fewer than 2 device
   refreshes in an MD phase or a host rebuild after the first that is not
   an overflow, and where a refresh frame or the last frame disagrees with
   a fresh host-built graph (``skin=0``) beyond the float32 bar, or a
   refreshed graph's pairs closer than r_build - 1e-4 Å differ from a
   float64 host search's;
10. slab graph parallelism on the card (``[parallel-*]``): each family at
   P = 2 (TensorNet also 4) against P = 1 and ``kernels=False``
   (``phase_parallel``); ``[parallel-md]``: 20 MD steps at P = 2 with the
   background prefetch rebuild (hits, waits, adopted and hit step ms),
   then with ``async_rebuild=False`` and at P = 1 from the same seed, the
   trajectories held to each other;
11. the batched engine on block-diagonally packed graphs: ``[batched-mace]``,
   ``[batched-tensornet]``, ``[batched-chgnet]`` (magmoms) and
   ``[batched-escn]`` (8 experts: the per-structure MOLE gate mixes the
   outputs of one SO(2) kernel call per expert) run
   ``BatchedPotential(device="cuda", skin=0.5)``
   at B = 1 and 8 on bench.py's 32-atom pool and on a mixed batch (32, 108,
   256 atoms and a lone atom without an edge), each structure held against
   ``DistPotential`` on it alone and against ``kernels=False``, the kernels
   against their plain versions on the packed graph's own arrays;
   ``[batched-md]`` (TensorNet, 8 x 32 atoms, ``nvt_berendsen`` at 300 /
   600 K, 40 steps of 2 fs, the packed device refresh checked against a
   fresh host pack) and ``[batched-relax]`` (CHGNet, FIRE; each host repack
   and the last frame against a fresh pack); ``[serve]``: ``ServeEngine``
   over MACE at ``max_batch`` 1 and 8, open- and closed-loop traffic, the
   2048-atom crystal through the ``DistPotential`` fallback lane and a NaN
   request that fails alone, the measured open loop's results and a last
   round's against ``DistPotential``. Launch counts derived per calculate,
   as above.

12. bfloat16 compute (``compute_dtype="bfloat16"``, MACE, eSCN, TensorNet,
   CHGNet):
   ``[kernels] segment_sum bf16`` (B1's bf16 kernels at MACE's two
   chunk shapes and eSCN's rows, the width sweep with int32 and int64 ids,
   all-masked and the padding-only chunk; tolerance one bf16 ulp over the
   fp32 sums' bound, e + 2^-7 (|y| + e); library call ``index_add_`` of the
   rows upcast to float32; bound at 2 bytes an element; each timed line
   with the plan its call took and the share of the bound) and
   ``[kernels] so2_conv bf16`` (B3's bf16 kernel, persistent 128 x 256
   tiles, at (32768, 25, 128), forward and backward
   route, and the small and ragged cases, within ``so2_conv_error_bound``'s
   bf16 form; its plan and L2 -> shared-memory bytes a call beside the
   first design's; library call the five cuBLAS bf16 products on
   pre-packed operands; bound at 989 TFLOP/s); ``[main-bf16]``
   (MACE at bench.py's bf16 configuration) and ``[main-escn-bf16]`` (eSCN
   at example 05's, with its conditioning) on the 2048-atom crystal, 4
   calculates, launches derived as the float32 paths' on the bf16 kernels,
   against ``kernels=False`` on the card and against the port's float32
   (the bars below), step ms and peak beside float32's; ``[md-bf16]`` (MACE, 20
   ``nvt_bussi`` steps of 0.35 fs) and ``[batched-mace-bf16]`` (B = 1 and
   8, against ``DistPotential`` and ``kernels=False`` at the bf16 bar).
   TensorNet at bf16 (``TENSORNET_BF16_KW``, the MatPES layout):
   ``[kernels] tensornet bf16`` (the bf16 embed, interaction and
   interaction backward on the 16,384-atom graph, E 917,504, C 64, against
   their plain bf16 versions within ``tensornet_embed_error_bound`` /
   ``tensornet_interaction_error_bound`` /
   ``tensornet_interaction_backward_error_bound`` at bf16 data, all masked
   writing zeros, the padding-only tail and three small cases; call ms,
   kernel alone, host µs, the bound at 2 bytes an element, ``index_add_``
   of the built message upcast to float32; the backward's plan and share
   of the bound), ``[main-tensornet-bf16]`` (4
   calculates at 16,384 atoms, launches derived as the float32 path's,
   the first calculate's ms logged alone), ``[md-tensornet-bf16]``
   (MD_BF16_STEPS ``nvt_bussi`` steps with the device refresh, refreshes
   counted, their pair sets checked), ``[parallel-tensornet-bf16]`` (P = 2
   against P = 1 and ``kernels=False``, the kernels on the flattened
   graph's segments) and ``[batched-tensornet-bf16]`` (B = 1 and 8).
   CHGNet at bf16 (``CHGNET_BF16_KW``, the MPtrj layout, magmoms):
   ``[kernels] chgnet bf16`` (the bf16 atom conv and line conv, their
   per-edge products on the tensor cores, on ``[kernels] chgnet``'s cases
   with every input and weight in bf16, within
   ``chgnet_aggregate_error_bound``'s bf16 form, within
   ``chgnet_tensor_core_error_bound`` of the float32 per-edge kernel on
   the upcast inputs and the same tables, and bit for bit on a second
   call; the bf16 row projection on the tensor cores at the wrappers'
   shapes, K = 6 and 7 too, within its own bar, with its plan and L2 ->
   shared-memory bytes; call ms, kernel alone, host µs, the bound at 2
   bytes an element, ``index_add_`` of the message upcast to float32, the
   projection's same-function ``addmm`` to a float32 table and ``addmm`` to
   a bf16 table; for each conv the float32 kernel's times in the same run,
   its floors (its own bytes, the SFU, the tensor cores), its plan and its
   host µs by part),
   ``[main-chgnet-bf16]`` (4 calculates at 16,384 atoms, launches derived
   as ``[main-chgnet]``'s on the bf16 kernels and each conv's plain
   backward chunks, magmoms within 0.05 max |m| of the plain route),
   ``[relax-chgnet-bf16]`` (``[relax-chgnet]``'s 30 FIRE steps with the
   cell), ``[parallel-chgnet-bf16]`` and ``[batched-chgnet-bf16]``.
   The bf16 bars: the kernels' route within rel dE < 1e-3 and max |dF| <
   0.1 max |F| of the plain one, and no further from float32 than the
   plain route is (x 1.25 + 0.005 max |F|): each route rounds the same
   fp32 sums at other bf16 ulps where they straddle a boundary, and the
   model carries the flips on, so the two bf16 routes differ by bf16
   noise, which their distances from float32 measure; both within rel dE
   < 2e-2 and max |dF| < 0.3 max |F| of float32 (a sanity bar: at these
   widths bf16 itself is 0.5% in energy and ~14% in max force from float32
   on the card, PERF.md §6).

13. pretrained-weight ingestion and the UMA family: ``[kernels] segment_sum
   escn_md`` (B1 at ESCNMD's edge-scan rows, (32768, 9, 128) at the UMA-S
   widths, float32 and bf16, on one chunk's ids at the UMA graph's mean
   edges a dst row, with the columns of phase 3); ``[uma]`` (ESCNMD at the
   widths of fairchem's published UMA-S backbone, ``tools/workload.py``
   ``UMA_KW``: 128 sphere channels, lmax = mmax = 2, 4 layers, 32 experts,
   cutoff 6 Å; a synthetic fairchem-named state dict from
   ``tests/torch_upstream_dicts.py`` converted by ``models/convert.py``'s
   ``from_torch`` with zero unmapped tensors) through
   ``UMAPredictor(task_name="omat")`` with charge 1 and spin 1 on the
   2048-atom crystal: ``drive``'s 4 calculates, B1's launches against
   (1 + num_layers) x 2K per calculate, step ms, peak, e_cap and K, and
   ``kernels=False`` within the float32 bar; ``[uma-bf16]`` the same at
   bf16 within the bf16 bars below, against its plain route and
   ``[uma]``'s float32 results; ``[convert]`` (the MACE-MP-0-medium,
   TensorNet-MatPES and CHGNet-MPtrj synthetic dicts converted with zero
   unmapped tensors, each evaluated once on the 256-atom crystal with its
   launches derived per calculate, against ``kernels=False`` at the float32
   bar). Each logs its seconds.

14. the device-resident MD loop and the ensemble: ``[device-md]``
   (TensorNet at the MatPES layout on the 16,384-atom crystal, skin 0.5,
   40 NVE steps of 2 fs from 600 K Maxwell-Boltzmann velocities) runs
   ``DeviceMD`` with the in-loop refresh (at least one refresh), then with
   the host rebuild (``device_rebuild=False`` on the potential), in two
   chunks of 5 and 35 steps, then ``MolecularDynamics`` (NVE) from the same
   start, then the first 5 steps with ``kernels=False`` (positions within
   1e-4 Å). Each DeviceMD run prints ms a step by chunk, host reads and
   synchronizing CUDA calls a step inside its chunks
   (``torch.cuda.set_sync_debug_mode("warn")``, by the line that made
   them), refreshes, overflows, and device memory after each chunk, which
   must not grow; launches derived as 1 embed + L interactions + L
   interaction backwards per force evaluation (one a step, one at each
   chunk's start); at most one host read a step plus one a refresh and one
   a chunk. ``[device-md-mace]``: the same for MACE at the
   MACE-MP-0-medium widths on the 2048-atom crystal at 0.35 fs, B1
   launches num_interactions x 2K per evaluation. ``[ensemble]``:
   ``EnsemblePotential`` over 3 MACE members (seeds 0-2) on the 2048-atom
   crystal, then 2 CHGNet members with magmoms on the 16,384-atom one,
   stacked and sequential, 3 calculates each (ms and peak per route),
   launches derived per member and calculate, each member against a lone
   ``DistPotential`` and the two routes against each other at the float32
   bar. The kernels line gains each kernel's ``device_md_launches`` (the
   DeviceMD runs) and ``ensemble_launches``.

15. training (``phase_train``): ``[train]`` (MACE at the MACE-MP-0-medium
   widths), ``[train-tensornet]``, ``[train-chgnet]``, ``[train-escn]`` and
   ``[train-bf16]`` (MACE at bench.py's bf16 configuration, loss scale
   2^15) through ``train.Trainer`` on bench.py's train set (8 x 108-atom
   Si labelled by a teacher of the same architecture from seed 1, student
   from seed 0, Adam 1e-3, micro-batch 4; MACE also accumulation 4 at
   micro-batch 1): the first step's loss terms and parameter gradient with
   the kernels against ``kernels=False`` (float32: rel 1e-5, rel L2 1e-4;
   bf16: no further from the float32 model than the plain bf16 route);
   three timed steps after a warm one (step ms, examples/s, peak and the
   measured ``est_peak_bytes``, skipped steps, fp32 master weights), their
   launches by role (forward, force backward, parameter backward) held to
   ``train_expected``; MACE's checkpoint after step 2 restored into a fresh
   ``Trainer`` for step 3 (largest parameter difference from the unbroken
   run). The kernels line gains ``train_launches`` and
   ``train_launches_by_role``.
16. telemetry and observability: ``[telemetry]`` (``phase_telemetry``:
   ``[md]``'s MACE workload without and with a telemetry hub under
   deterministic algorithms, positions bit for bit, one checked record per
   calculate, the JSONL's report; the hub's cost on warm steps attached and
   detached in turn; ``DeviceMD`` without and with the hub: the same
   trajectory and syncs, one ``md_chunk`` record a chunk),
   ``[telemetry-serve]`` (``ServeEngine`` at B = 8 with the obs hub: every
   request trace complete, the metrics scraped from localhost parsed, the
   SLO feed and the records) and ``[attribution]`` (one warm MACE step and
   one eSCN step under ``torch.profiler``: ``obs.attribution``'s
   ``custom_kernel`` bucket within 2% of ``step_profile.device_split``'s
   own-kernel time from the same capture, B1 on MACE and B1 and B3 on eSCN,
   the device time by layer). The kernels line gains
   ``telemetry_launches``.

Prints one ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name/power
line, then ``{"ok": true, "device": {...}}`` as the last line. Without a
card, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import socket
import statistics
import subprocess
import sys
import time
from unittest import mock

try:  # the timing helpers and the main path's edge-chunk case, shared with kernel_ab.py
    from distmlip_tpu_torch.tools.kernel_ab import (H100_BYTES_PER_S, chgnet_graph,
                                                    chgnet_inputs, cuda_ms, edge_inputs,
                                                    interaction_backward_cost,
                                                    library_split, projection_library_call,
                                                    segment_sum_bytes, slice_case, split,
                                                    tensornet_graph)
except ImportError as e:
    sys.exit(f"chip_smoke: run from the root of a checkout ({e})")

H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12         # TF32 in the tensor cores, dense
H100_BF16_FLOPS = 989e12         # bf16 in the tensor cores, dense
REPLACES = {"segment_sum": "distmlip_tpu/kernels/segment.py:142",
            "tensornet_embed_aggregate": "distmlip_tpu/kernels/segment.py:224",
            "tensornet_interaction_aggregate": "distmlip_tpu/kernels/segment.py:224",
            # the custom VJP's chunked recompute around pallas_edge_aggregate
            "tensornet_interaction_backward": "distmlip_tpu/kernels/dispatch.py:482",
            "chgnet_atom_conv_aggregate": "distmlip_tpu/kernels/segment.py:224",
            "chgnet_line_aggregate": "distmlip_tpu/kernels/segment.py:224",
            "chgnet_row_projection": "distmlip_tpu/kernels/segment.py:224",
            "so2_conv": "distmlip_tpu/kernels/so3.py:89",
            # the same TPU kernels at bf16 data (their VMEM scratch and
            # dots in data.dtype, fp32 accumulation)
            "segment_sum_bf16": "distmlip_tpu/kernels/segment.py:142",
            "so2_conv_bf16": "distmlip_tpu/kernels/so3.py:89",
            "tensornet_embed_aggregate_bf16": "distmlip_tpu/kernels/segment.py:224",
            "tensornet_interaction_aggregate_bf16": "distmlip_tpu/kernels/segment.py:224",
            "tensornet_interaction_backward_bf16": "distmlip_tpu/kernels/dispatch.py:482",
            "chgnet_atom_conv_aggregate_bf16": "distmlip_tpu/kernels/segment.py:224",
            "chgnet_line_aggregate_bf16": "distmlip_tpu/kernels/segment.py:224",
            "chgnet_row_projection_bf16": "distmlip_tpu/kernels/segment.py:224"}
SOURCES = {"segment_sum": "distmlip_tpu_torch/kernels/csrc/segment_sum.cu",
           "tensornet_embed_aggregate": "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "tensornet_interaction_aggregate":
               "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "tensornet_interaction_backward":
               "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "chgnet_atom_conv_aggregate": "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu",
           "chgnet_line_aggregate": "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu",
           "chgnet_row_projection": "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu",
           "so2_conv": "distmlip_tpu_torch/kernels/csrc/so2_conv.cu",
           "segment_sum_bf16": "distmlip_tpu_torch/kernels/csrc/segment_sum.cu",
           "so2_conv_bf16": "distmlip_tpu_torch/kernels/csrc/so2_conv.cu",
           "tensornet_embed_aggregate_bf16": "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "tensornet_interaction_aggregate_bf16":
               "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "tensornet_interaction_backward_bf16":
               "distmlip_tpu_torch/kernels/csrc/edge_aggregate.cu",
           "chgnet_atom_conv_aggregate_bf16":
               "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu",
           "chgnet_line_aggregate_bf16": "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu",
           "chgnet_row_projection_bf16": "distmlip_tpu_torch/kernels/csrc/chgnet_aggregate.cu"}
STEPS = 3
TENSORNET_REPS = 16  # bench.py's default structure: 16384 atoms
CHGNET_REPS = 16


def log(*args):
    print(*args, flush=True)


def check_segment_sum(torch, data, ids, mask, n):
    """Kernel vs plain on one input; returns max |kernel - plain|. float32
    in two summation orders: each output may differ by up to e = 2 k u
    sum|x| (k = the largest row's edge count, u = 2^-24). bfloat16 rows:
    both sides sum in fp32 (within e) and round once to bf16 (8 significant
    bits), so e + 2^-7 (|y| + e), y the fp32 sum: one bf16 ulp."""
    from distmlip_tpu_torch.kernels import segment_sum_cuda, segment_sum_reference

    got = segment_sum_cuda(data, ids, n, mask)
    want = segment_sum_reference(data, ids, n, mask)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"segment_sum shape/dtype {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}")
    k = max(int(torch.bincount(ids.long(), minlength=n).max()), 1)
    bound = 2 * k * 2.0 ** -24 * segment_sum_reference(data.float().abs(), ids, n, mask)
    if data.dtype == torch.bfloat16:
        y = segment_sum_reference(data.float(), ids, n, mask)
        bound = bound + 2.0 ** -7 * (y.abs() + bound)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= bound + 1e-30).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"segment_sum disagrees with its plain version: max "
                             f"|err| {float(err.max())}, bound {float(bound.max())}")
    return float(err.max()) if err.numel() else 0.0


def bound(nbytes, ops, flops=H100_FP32_FLOPS):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the card's peak rate for their type (float32 outside
    the tensor cores unless ``flops`` says otherwise)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_segment_sum(torch, data, ids, mask, n):
    """The segment sum's call ms (CUDA events), kernel-alone ms (profiler),
    host µs per call, plain ms, and one ``index_add_`` of the masked rows
    (float32: bf16 rows upcast beforehand, an fp32 accumulation as the
    kernel's) timed the same ways; its bytes bound at the rows' element
    size."""
    from distmlip_tpu_torch.kernels import segment_sum_cuda, segment_sum_reference

    e = data.shape[0]
    w = data[0].numel()
    timed = split(torch, lambda: segment_sum_cuda(data, ids, n, mask), "segment_sum")
    plain_ms = cuda_ms(torch, lambda: segment_sum_reference(data, ids, n, mask))
    masked = torch.where(mask.reshape((e,) + (1,) * (data.ndim - 1)), data.float(), 0.0)
    out = torch.zeros((n,) + tuple(data.shape[1:]), device="cuda")
    ids_long = ids.long()
    timed.update(library_split(torch, lambda: out.index_add_(0, ids_long, masked)))
    del masked, out
    n_valid = int(mask.sum())
    nbytes = segment_sum_bytes(data, ids, mask, n)
    bound_ms, bound_by = bound(nbytes, n_valid * w)
    return {"shape": [e] + list(data.shape[1:]), "dtype": str(data.dtype).split(".")[-1],
            "width": w, "n_segments": n,
            "valid_rows": n_valid, **timed, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


SEGMENT_WIDTHS = (1, 2, 3, 4, 8, 16, 31, 32, 33, 100, 800, 3200)


def phase_kernels(torch):
    """B1 at MACE's two edge-chunk shapes, across the width sweep (the
    narrow mapping up to 16 columns, a warp per 32-column chunk past that)
    on one chunk's ids and mask, then the edge cases."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs, timed = [], []
    for q in (16, 40):  # the two interactions' Q; C = 128
        case = slice_case(torch, gen, 32768, (q, 128))
        errs.append(check_segment_sum(torch, *case))
        timed.append(time_segment_sum(torch, *case))
        log(f"[kernels] segment_sum {timed[-1]['shape']}: {json.dumps(timed[-1])}")
        del case
    sweep = []
    _, ids, mask, n = slice_case(torch, gen, 32768, (1,))
    for w in SEGMENT_WIDTHS:
        data = torch.randn((32768, w), generator=gen, device="cuda")
        errs.append(check_segment_sum(torch, data, ids, mask, n))
        errs.append(check_segment_sum(torch, data, ids.long(), mask, n))
        sweep.append(time_segment_sum(torch, data, ids, mask, n))
        log(f"[kernels] segment_sum width {w}: {json.dumps(sweep[-1])}")
    # edge cases: E not a multiple of any block, empty rows, W = 1,
    # all-masked, and the padding-only chunk (every row masked, one dst row)
    data, ids, mask, n = slice_case(torch, gen, 1003, (5,), n_rows=300, pad=17,
                                    interior_masked=9)
    errs.append(check_segment_sum(torch, data, ids, mask, n))
    errs.append(check_segment_sum(torch, data[:, :1].contiguous(), ids, mask, n))
    errs.append(check_segment_sum(torch, data, ids, torch.zeros_like(mask), n))
    pad_ids = torch.full((32768,), 2047, dtype=torch.int32, device="cuda")
    pad_data = torch.randn((32768, 40 * 128), generator=gen, device="cuda")
    pad_mask = torch.zeros(32768, dtype=torch.bool, device="cuda")
    errs.append(check_segment_sum(torch, pad_data, pad_ids, pad_mask, 2560))
    pad_time = time_segment_sum(torch, pad_data, pad_ids, pad_mask, 2560)
    log(f"[kernels] segment_sum padding-only chunk: {json.dumps(pad_time)}")
    log(f"[kernels] all cases agree with the plain version; max |err| {max(errs)}")
    return max(errs), timed, sweep


def with_plan(timed, plan):
    """A timed case for its log line: the plan its call took and the kernel
    alone's share of the bound (bound ms / kernel ms)."""
    share = (timed["bound_ms"] / timed["kernel_ms"]) if timed.get("kernel_ms") else None
    return {**timed, "plan": plan, "bound_share": share}


def phase_kernels_bf16(torch):
    """``[kernels] segment_sum bf16``: B1's bf16 kernels at MACE's two
    edge-chunk shapes and eSCN's rows (bf16 rows), across the width sweep
    on one chunk's ids and mask (int32 and int64 ids), then all-masked and
    the padding-only chunk; each against its plain bf16 version. Each timed
    line also prints the plan the call took (``kernels.segment_sum_bf16_plan``)
    and the kernel's share of its bound."""
    from distmlip_tpu_torch import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(4321)
    errs, timed = [], []
    for trailing in ((16, 128), (40, 128), (25, 128)):
        data, ids, mask, n = slice_case(torch, gen, 32768, trailing)
        data = data.bfloat16()
        errs.append(check_segment_sum(torch, data, ids, mask, n))
        timed.append(time_segment_sum(torch, data, ids, mask, n))
        log(f"[kernels] segment_sum bf16 {timed[-1]['shape']}: "
            f"{json.dumps(with_plan(timed[-1], K.segment_sum_bf16_plan(data, ids)))}")
        del data
    sweep = []
    _, ids, mask, n = slice_case(torch, gen, 32768, (1,))
    for w in SEGMENT_WIDTHS:
        data = torch.randn((32768, w), generator=gen, device="cuda").bfloat16()
        errs.append(check_segment_sum(torch, data, ids, mask, n))
        errs.append(check_segment_sum(torch, data, ids.long(), mask, n))
        sweep.append(time_segment_sum(torch, data, ids, mask, n))
        log(f"[kernels] segment_sum bf16 width {w}: "
            f"{json.dumps(with_plan(sweep[-1], K.segment_sum_bf16_plan(data, ids)))}")
    errs.append(check_segment_sum(torch, data, ids, torch.zeros_like(mask), n))
    pad_ids = torch.full((32768,), 2047, dtype=torch.int32, device="cuda")
    pad_data = torch.randn((32768, 40 * 128), generator=gen, device="cuda").bfloat16()
    errs.append(check_segment_sum(torch, pad_data, pad_ids,
                                  torch.zeros(32768, dtype=torch.bool, device="cuda"), 2560))
    log(f"[kernels] segment_sum bf16: all cases agree with the plain version; max |err| "
        f"{max(errs)}")
    return max(errs), timed, sweep


def check_edge_aggregate(torch, which, arrays, ids, mask, n):
    """Kernel vs plain on one input; returns max |kernel - plain|.
    Per output element |kernel - plain| <= 2 (k + 3) u T: k is the row's
    valid-edge count, u = 2^-24, T the exact sum of |terms| (the plain
    version on |inputs|; ``kernels.tensornet_embed_error_bound`` and
    ``kernels.tensornet_interaction_error_bound``, whose T takes the lower
    triangle's terms from the upper one). bf16 inputs: the bounds' bf16
    form, the plain route's r bf16 roundings of each message entry (r = 6
    embed, 4 interaction) over T, then one bf16 ulp of the result,
    e + 2^-7 (|y| + e); and bit for bit the float32 kernel on the upcast
    inputs, rounded once (the bf16 kernels' arithmetic and order are its)."""
    from distmlip_tpu_torch import kernels as K

    cuda, ref, bound_fn = {
        "embed": (K.tensornet_embed_aggregate_cuda, K.tensornet_embed_aggregate_reference,
                  K.tensornet_embed_error_bound),
        "interaction": (K.tensornet_interaction_aggregate_cuda,
                        K.tensornet_interaction_aggregate_reference,
                        K.tensornet_interaction_error_bound)}[which]
    got = cuda(*arrays, ids, n, mask)
    want = ref(*arrays, ids, n, mask)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{which} shape/dtype {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}")
    tol = bound_fn(*arrays, ids, n, mask)
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + 1e-30).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{which} disagrees with its plain version: max |err| "
                             f"{float(err.max())}, max tolerance {float(tol.max())}")
    if got.dtype == torch.bfloat16:
        up = [x.float() if x.is_floating_point() else x for x in arrays]
        if not torch.equal(got, cuda(*up, ids, n, mask).bfloat16()):
            raise AssertionError(f"bf16 {which} differs from the float32 kernel on the upcast "
                                 "inputs rounded once")
    return float(err.max()) if err.numel() else 0.0


def time_edge_aggregate(torch, which, arrays, ids, mask, n):
    """A TensorNet forward kernel's call ms (CUDA events), the kernel alone
    (profiler) and the host µs a call, its plain version's ms, one
    ``index_add_`` of the built message (bf16 upcast to float32
    beforehand: an fp32 accumulation as the kernel's), and the bound at
    the inputs' element size (index and mask bytes unchanged). The
    interaction's line adds its L2 gather (each valid edge's 10 compact
    words a channel) and the rate the kernel alone draws it at; a bf16
    call's, the wrapper's host µs by part (``host_split``)."""
    from distmlip_tpu_torch import kernels as K

    cuda, ref, message = {
        "embed": (K.tensornet_embed_aggregate_cuda, K.tensornet_embed_aggregate_reference,
                  K.TENSORNET_EMBED.fn),
        "interaction": (K.tensornet_interaction_aggregate_cuda,
                        K.tensornet_interaction_aggregate_reference,
                        K.TENSORNET_INTERACTION.fn)}[which]
    timed = split(torch, lambda: cuda(*arrays, ids, n, mask), f"tensornet_{which}_kernel")
    half = arrays[0].dtype == torch.bfloat16
    plain_ms = cuda_ms(torch, lambda: ref(*arrays, ids, n, mask), iters=5)
    e = ids.shape[0]
    c = arrays[0].shape[1]
    es = arrays[0].element_size()
    if which == "embed":
        msg = message(*arrays)
    else:
        src = arrays[4]
        msg = message(arrays[0], *(x.index_select(0, src) for x in arrays[1:4]))
    masked = torch.where(mask[:, None, None, None], msg.float(), 0.0).reshape(e, 9 * c)
    del msg
    out = torch.zeros((n, 9 * c), device="cuda")
    ids_long = ids.long()
    # the scatter alone: one index_add_ of the already-materialised message
    library_ms = cuda_ms(torch, lambda: out.index_add_(0, ids_long, masked))
    del masked, out
    n_valid = int(mask.sum())
    io = e * ids.element_size() + e + n * 9 * c * es  # ids, mask, output
    if which == "embed":
        nbytes = n_valid * (4 * c + 18) * es + io
        ops = n_valid * c * (9 * 6 + 3)
    else:
        # f and src of each valid edge, each gathered src row's 10 C
        # compact floats once; 10 multiply-adds per (edge, channel) and
        # 9 adds per (row, channel) to assemble the 3x3
        n_src = int(torch.unique(arrays[4][mask]).numel())
        nbytes = n_valid * (3 * c * es + arrays[4].element_size()) + n_src * 10 * c * es + io
        ops = n_valid * c * 10 * 2 + n * c * 9
    bound_ms, bound_by = bound(nbytes, ops)
    out = {"which": which, "dtype": str(arrays[0].dtype).split(".")[-1], "e": e,
           "valid_edges": n_valid, "channels": c, "n_segments": n, **timed,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "index_add_ of the materialised (E, 9C) message"
           + (" upcast to float32" if half else "") + ": the scatter alone",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    if which == "interaction":
        out["unique_src_rows"] = n_src
        # every valid edge's 10 compact words a channel, gathered through L2
        out["l2_gather_bytes"] = n_valid * 10 * c * es
        if timed.get("kernel_ms"):
            out["l2_gather_tb_s"] = out["l2_gather_bytes"] / timed["kernel_ms"] / 1e9
    if half:
        out["host_split_us"] = host_split(torch, lambda: cuda(*arrays, ids, n, mask),
                                          TENSORNET_HOST_PARTS)
    return out


def check_interaction_backward(torch, g, arrays, ids, mask):
    """The backward kernel vs its plain version on one input, all four
    cotangents within ``kernels.tensornet_interaction_backward_error_bound``
    (2 (k + 3) u T: k the src row's valid-edge count for d i, d a, d s and
    the dot product's length 1, 3, 6 for d f's columns; T the same
    computation on |inputs|); masked edges' d f rows must be zero. Returns
    max |kernel - plain|."""
    from distmlip_tpu_torch import kernels as K

    got = K.tensornet_interaction_backward_cuda(g, *arrays, ids, mask)
    want = K.tensornet_interaction_backward_reference(g, *arrays, ids, mask)
    torch.cuda.synchronize()
    tols = K.tensornet_interaction_backward_error_bound(g, *arrays, ids, mask)
    worst = 0.0
    for name, x, y, tol in zip(("d_f", "d_i", "d_a", "d_s"), got, want, tols):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"interaction backward {name} shape/dtype {x.shape} "
                                 f"{x.dtype} vs {y.shape} {y.dtype}")
        err = (x.float() - y.float()).abs()
        if not bool((err <= tol + 1e-30).all()) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"interaction backward {name} disagrees with its plain "
                                 f"version: max |err| {float(err.max())}, max tolerance "
                                 f"{float(tol.max())}")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    if bool(got[0][~mask].any()):
        raise AssertionError("interaction backward: a masked edge got a nonzero d f row")
    return worst


def time_interaction_backward(torch, g, arrays, ids, mask):
    """The backward kernel's time (its wrapper: the src sort, the CSR
    offsets and the launch), the sort alone, the plain chunked recompute of
    today's backward for this message (``dispatch._edge_aggregate_bwd``,
    32,768-edge chunks) and one ``index_add_`` of the materialised (E, 10 C)
    node-row cotangent by src: the scatter alone."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    f, node_i, node_a, node_s, src = arrays
    n_node = node_i.shape[0]
    timed = split(torch, lambda: K.tensornet_interaction_backward_cuda(g, *arrays, ids, mask),
                  "tensornet_interaction_bwd_kernel")
    sort_ms = cuda_ms(torch, lambda: K.src_order(src, n_node, mask))

    def plain():
        with torch.no_grad():
            dispatch._edge_aggregate_bwd(K.TENSORNET_INTERACTION, (None, 0, 0, 0),
                                         [f, node_i, node_a, node_s], (), [src], ids, mask, g,
                                         dispatch.DEFAULT_BWD_CHUNK, (True,) * 4)

    plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
    e, c = f.shape[0], f.shape[1]
    rows = torch.where(mask[:, None], torch.randn((e, 10 * c), device="cuda"), 0.0)
    out = torch.zeros((n_node, 10 * c), device="cuda")
    src_long = src.long()
    library_ms = cuda_ms(torch, lambda: out.index_add_(0, src_long, rows))
    del rows, out
    n_valid = int(mask.sum())
    nbytes, ops = interaction_backward_cost(torch, f, src, ids, mask, n_node)
    bound_ms, bound_by = bound(nbytes, ops)
    return {"dtype": str(f.dtype).split(".")[-1], "e": e, "valid_edges": n_valid,
            "channels": c, "n_node": n_node, **timed,
            "sort_ms": sort_ms, "plain_ms": plain_ms,
            "plain": "the chunked recompute (dispatch._edge_aggregate_bwd)",
            "library_ms": library_ms, "library": "index_add_ of the materialised (E, 10C) "
            "float32 node-row cotangent by src: the scatter alone", "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops}


def phase_edge_aggregate_kernels(torch):
    """Both TensorNet kernels and the interaction's backward kernel at the
    TensorNet path's shapes (its graph, C = 64), then the edge cases."""
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW

    gen = torch.Generator(device="cuda").manual_seed(4321)
    ids, src, mask, n = tensornet_graph(torch, TENSORNET_REPS)
    c = TENSORNET_KW["units"]
    errs, timed = {}, {}
    for which in ("embed", "interaction"):
        arrays = edge_inputs(torch, gen, which, ids.shape[0], c, n, src)
        errs[which] = [check_edge_aggregate(torch, which, arrays, ids, mask, n)]
        timed[which] = time_edge_aggregate(torch, which, arrays, ids, mask, n)
        log(f"[kernels] tensornet {which}: {json.dumps(timed[which])}")
        if which == "interaction":
            g = torch.randn((n, 3, 3, c), generator=gen, device="cuda")
            errs["backward"] = [check_interaction_backward(torch, g, arrays, ids, mask)]
            torch.cuda.empty_cache()
            timed["backward"] = time_interaction_backward(torch, g, arrays, ids, mask)
            log(f"[kernels] tensornet interaction backward: {json.dumps(timed['backward'])}")
            errs["backward"].append(check_interaction_backward(torch, g, arrays, ids,
                                                               torch.zeros_like(mask)))
        # a fully masked input, and the padding-only tail on one dst row
        errs[which].append(check_edge_aggregate(torch, which, arrays, ids,
                                                torch.zeros_like(mask), n))
        one_row = torch.full_like(ids, int(ids[-1]))
        errs[which].append(check_edge_aggregate(torch, which, arrays, one_row,
                                                torch.zeros_like(mask), n))
        last5 = torch.arange(len(ids), device="cuda") >= len(ids) - 5
        errs[which].append(check_edge_aggregate(torch, which, arrays, one_row, last5, n))
        del arrays
        torch.cuda.empty_cache()
        # E not a multiple of any block, empty dst rows, C not a multiple
        # of 4, C past one block of threads
        for e, rows, cc in ((1003, 300, 7), (517, 45, 5), (300, 900, 64), (90, 13, 300)):
            sub_ids = torch.sort(torch.randint(0, rows, (e,), generator=gen,
                                               device="cuda"))[0].to(torch.int32)
            sub_mask = torch.rand(e, generator=gen, device="cuda") > 0.1
            sub_mask[-17:] = False
            sub_ids[-17:] = sub_ids[-18]
            sub = edge_inputs(torch, gen, which, e, cc, 37)
            errs[which].append(check_edge_aggregate(torch, which, sub, sub_ids, sub_mask,
                                                    rows))
            if which == "interaction":
                sub_g = torch.randn((rows, 3, 3, cc), generator=gen, device="cuda")
                errs["backward"].append(check_interaction_backward(torch, sub_g, sub, sub_ids,
                                                                   sub_mask))
        torch.cuda.empty_cache()
        log(f"[kernels] tensornet {which}: all cases agree with the plain version; "
            f"max |err| {max(errs[which])}")
    log(f"[kernels] tensornet interaction backward: all cases agree with the plain "
        f"version; max |err| {max(errs['backward'])}")
    return {w: max(v) for w, v in errs.items()}, timed


def phase_edge_aggregate_kernels_bf16(torch):
    """``[kernels] tensornet bf16``: the bf16 embed, interaction and
    interaction backward on the TensorNet path's graph (C = 64) at bf16
    inputs, each against its plain bf16 version within its bound's bf16
    form (the forwards also bit for bit against the float32 kernel on the
    upcast inputs, rounded once), then all masked (every output zero: the
    plain version's zeros within a bound of 0), the padding-only tail on
    one dst row, three small cases (C = 7 with E not a multiple of any
    block, C = 65 on the single-channel paths, C = 300 past one block of
    threads), the forwards' first input viewed one bf16 element off a
    4-byte boundary (the single-channel path at C = 64) and two (channel
    pairs), and NaN in the masked edges' rows. Each timed line also prints
    its plan (``kernels.tensornet_embed_bf16_plan``,
    ``tensornet_interaction_bf16_plan``,
    ``tensornet_interaction_backward_bf16_plan``) and share of the bound;
    the forwards' the wrapper's host µs by part, the interaction's its L2
    gather and rate."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW

    gen = torch.Generator(device="cuda").manual_seed(4322)
    ids, src, mask, n = tensornet_graph(torch, TENSORNET_REPS)
    c = TENSORNET_KW["units"]
    plans = {"embed": K.tensornet_embed_bf16_plan,
             "interaction": K.tensornet_interaction_bf16_plan}

    def bf16(arrays):
        return [x.bfloat16() if x.is_floating_point() else x for x in arrays]

    def view(x, off):
        """``x`` ``off`` elements into a buffer of its dtype"""
        buf = torch.zeros(x.numel() + off, dtype=x.dtype, device="cuda")
        buf[off:] = x.reshape(-1)
        return buf[off:].view(x.shape)

    errs, timed = {}, {}
    for which in ("embed", "interaction"):
        arrays = bf16(edge_inputs(torch, gen, which, ids.shape[0], c, n, src))
        errs[which] = [check_edge_aggregate(torch, which, arrays, ids, mask, n)]
        timed[which] = time_edge_aggregate(torch, which, arrays, ids, mask, n)
        log(f"[kernels] tensornet bf16 {which}: "
            f"{json.dumps(with_plan(timed[which], plans[which](*arrays[:4], n)))}")
        # all masked: the plain version is zeros and the bound 0
        errs[which].append(check_edge_aggregate(torch, which, arrays, ids,
                                                torch.zeros_like(mask), n))
        one_row = torch.full_like(ids, int(ids[-1]))
        last5 = torch.arange(len(ids), device="cuda") >= len(ids) - 5
        errs[which].append(check_edge_aggregate(torch, which, arrays, one_row, last5, n))
        if which == "interaction":
            g = torch.randn((n, 3, 3, c), generator=gen, device="cuda").bfloat16()
            errs["backward"] = [check_interaction_backward(torch, g, arrays, ids, mask)]
            torch.cuda.empty_cache()
            timed["backward"] = time_interaction_backward(torch, g, arrays, ids, mask)
            plan = K.tensornet_interaction_backward_bf16_plan(g, *arrays[:4])
            log(f"[kernels] tensornet bf16 interaction backward: "
                f"{json.dumps(with_plan(timed['backward'], plan))}")
            errs["backward"].append(check_interaction_backward(torch, g, arrays, ids,
                                                               torch.zeros_like(mask)))
        del arrays
        torch.cuda.empty_cache()
        for e, rows, cc in ((1003, 300, 7), (90, 13, 300), (517, 45, 65), (2000, 40, 64)):
            sub_ids = torch.sort(torch.randint(0, rows, (e,), generator=gen,
                                               device="cuda"))[0].to(torch.int32)
            sub_mask = torch.rand(e, generator=gen, device="cuda") > 0.1
            sub_mask[-17:] = False
            sub_ids[-17:] = sub_ids[-18]
            sub = bf16(edge_inputs(torch, gen, which, e, cc, 37))
            errs[which].append(check_edge_aggregate(torch, which, sub, sub_ids, sub_mask, rows))
            if which == "interaction" and cc != 64:
                sub_g = torch.randn((rows, 3, 3, cc), generator=gen, device="cuda").bfloat16()
                errs["backward"].append(check_interaction_backward(torch, sub_g, sub, sub_ids,
                                                                   sub_mask))
        # the C = 64 case: views off a 4-byte boundary, then NaN in the masked rows
        for off, lanes in ((1, 1), (2, 2)):
            moved = [view(sub[0], off)] + sub[1:]
            if plans[which](*moved[:4], rows)["channels_a_lane"] != lanes:
                raise AssertionError(f"bf16 {which}: a view {off} off took the wrong path")
            errs[which].append(check_edge_aggregate(torch, which, moved, sub_ids, sub_mask,
                                                    rows))
        for x in (sub[:6] if which == "embed" else sub[:1]):
            x[~sub_mask] = float("nan")
        errs[which].append(check_edge_aggregate(torch, which, sub, sub_ids, sub_mask, rows))
    torch.cuda.empty_cache()
    log(f"[kernels] tensornet bf16: all cases agree with the plain bf16 versions; max |err| "
        f"{json.dumps({w: max(v) for w, v in errs.items()})}")
    return {w: max(v) for w, v in errs.items()}, timed


def chgnet_rows(torch, which, arrays):
    """The concat rows (E, K1) of a CHGNet message and its abw (or None)."""
    if which == "atom":
        node_src, src, node_dst, dst, edge, abw = arrays
        return torch.cat([node_src[src.long()], node_dst[dst.long()], edge], -1), abw
    bond_src, ls, bond_dst, ld, angle, node, ctr = arrays
    return torch.cat([bond_src[ls.long()], bond_dst[ld.long()], angle,
                      node[ctr.long()]], -1), None


def _chgnet_fns(which):
    from distmlip_tpu_torch import kernels as K

    if which == "atom":
        return (K.chgnet_atom_conv_aggregate_cuda, K.chgnet_atom_conv_aggregate_reference,
                "chgnet_atom_conv_aggregate")
    return (K.chgnet_line_aggregate_cuda, K.chgnet_line_aggregate_reference,
            "chgnet_line_aggregate")


def bf16_tables(x, w, bias):
    """The bf16 call's row projection, for a float32 call on upcast bf16
    inputs (the same values, exactly): both calls' per-edge kernels then
    read one set of float32 tables."""
    from distmlip_tpu_torch.kernels import chgnet_row_projection_cuda

    return chgnet_row_projection_cuda(x.bfloat16(), w.bfloat16(), bias)


def check_chgnet(torch, which, arrays, weights, ids, mask, n):
    """Kernel vs plain on one input, within the derived bound
    ``chgnet_aggregate_error_bound`` (for each side: (K + 2) u on each dot
    product's sum of |terms|, activation slopes and ulps, the gating
    products, k u on the dst sum; |kernel - plain| <= twice that; at bf16
    data the plain route's r = 8 (7) bf16 roundings of each message entry
    over ``chgnet_message_terms``, one more of slack, and one bf16 ulp of
    the result). A bf16 call's tensor-core kernel is also held against the
    float32 per-edge kernel on the upcast inputs and the same float32
    tables (the float32 call given the bf16 projection, ``bf16_tables``, in
    the place of ``edge_aggregate.chgnet_row_projection_cuda``) within
    ``chgnet_tensor_core_error_bound`` (the float32 kernel's own 2 b, each
    mma layer's truncating k16 accumulation, the hidden's one bf16
    rounding, one bf16 ulp of the output), and against itself on a second
    call, bit for bit. Returns (max |kernel - plain|, max |kernel - plain| /
    bound, and for bf16 max |kernel - float32 kernel| / its bar, else
    None)."""
    from distmlip_tpu_torch.kernels import (chgnet_aggregate_error_bound,
                                            chgnet_tensor_core_error_bound, edge_aggregate)

    cuda, ref, _ = _chgnet_fns(which)
    got = cuda(*arrays, weights, ids, n, mask)
    want = ref(*arrays, weights, ids, n, mask)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"chgnet {which} shape/dtype {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}")
    x, abw = chgnet_rows(torch, which, arrays)
    tol = chgnet_aggregate_error_bound(x, abw, weights, ids, n, mask)
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + 1e-30).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"chgnet {which} disagrees with its plain version: max "
                             f"|err| {float(err.max())}, max tolerance {float(tol.max())}")
    if got.dtype == torch.bfloat16:
        f32_arrays, f32_weights = float_case(arrays, weights)
        with mock.patch.object(edge_aggregate, "chgnet_row_projection_cuda", bf16_tables):
            f32 = cuda(*f32_arrays, f32_weights, ids, n, mask)
        bar = chgnet_tensor_core_error_bound(x, abw, weights, ids, n, mask)
        tc_err = (got.float() - f32).abs()
        if not bool((tc_err <= bar + 1e-30).all()):
            raise AssertionError(f"chgnet {which} bf16 is off the float32 kernel on the upcast "
                                 f"inputs and the same tables by {float(tc_err.max())}, past "
                                 f"its bar in {int((tc_err > bar + 1e-30).sum())} elements")
        if not torch.equal(got, cuda(*arrays, weights, ids, n, mask)):
            raise AssertionError(f"chgnet {which} bf16 differs between two calls")
    del x
    tc_ratio = (float((tc_err / (bar + 1e-30)).max()) if got.dtype == torch.bfloat16
                and err.numel() else None)
    if not err.numel():
        return 0.0, 0.0, tc_ratio
    return float(err.max()), float((err / (tol + 1e-30)).max()), tc_ratio


def max_sm_clock_hz():
    """The card's largest SM clock (``nvidia-smi``'s clocks.max.sm), in Hz."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def time_chgnet(torch, which, arrays, weights, ids, mask, n):
    """A CHGNet wrapper's call ms (CUDA events; its row projections
    included), the per-edge kernel alone (profiler) and the host µs a call,
    its plain version's ms, one ``index_add_`` of the built message (bf16
    upcast to float32 beforehand: an fp32 accumulation as the kernel's),
    and the bound at the inputs' element size (ids and mask unchanged) and
    the peak rate for their type (bf16: the tensor cores; the float32 CUDA
    cores' operations time beside it, as ``fp32_core_ops_ms``). bf16 also:
    the float32 wrapper on the upcast inputs in the same run
    (``float32_kernel``), the per-edge kernel's floors (``floors``: its
    gathered bytes, the SFU's activations, the tensor cores' products) and
    its launch plan, and the host µs of ``_launch_chgnet`` by part
    (``host_split_us``)."""
    from distmlip_tpu_torch import kernels as K

    cuda, ref, _ = _chgnet_fns(which)
    key = f"chgnet_{which}_conv"  # the per-edge kernel, float32 or bf16, not the projection
    timed = split(torch, lambda: cuda(*arrays, weights, ids, n, mask), key)
    plain_ms = cuda_ms(torch, lambda: ref(*arrays, weights, ids, n, mask), iters=5)
    e, c = ids.shape[0], arrays[4].shape[1]
    h = weights[0].shape[1]
    x, abw = chgnet_rows(torch, which, arrays)
    msg = (K.CHGNET_ATOM_CONV if which == "atom" else K.CHGNET_LINE_CONV).fn(
        *x.split(c, dim=-1), *(() if abw is None else (abw,)), weights=weights)
    del x
    masked = torch.where(mask[:, None], msg.float(), 0.0)
    del msg
    out = torch.zeros((n, c), device="cuda")
    ids_long = ids.long()
    # the scatter alone: one index_add_ of the already-materialised message
    library_ms = cuda_ms(torch, lambda: out.index_add_(0, ids_long, masked))
    del masked, out
    n_valid = int(mask.sum())
    k1 = (3 if which == "atom" else 4) * c
    # the gather ids of each gathered segment: (src, dst) or (line_src,
    # line_dst, center), on the valid edges
    gathers = [arrays[i][mask] for i in ((1, 3) if which == "atom" else (1, 3, 6))]
    rows_per_segment = [int(torch.unique(g).numel()) for g in gathers]
    n_seg = k1 // c
    # operations, the least the function needs. Layer 1 is linear, so a
    # gathered segment's products (C -> H, core and gate: 4 C H) are taken
    # once per distinct row the valid edges gather from it, with the
    # layer-1 bias folded into the first segment's rows (2 H). Per valid
    # edge: the per-edge segment's products (4 C H), the adds joining the
    # n_seg partial products (2 (n_seg - 1) H), layer 2 of core and gate
    # with its bias (4 H C + 2 C), the gating product (and the abw product
    # of the atom conv) and the add onto the dst row. The activations are
    # not counted.
    ops = (4 * c * h * sum(rows_per_segment) + 2 * h * rows_per_segment[0]
           + n_valid * (4 * c * h + 2 * (n_seg - 1) * h + 4 * h * c + 2 * c
                        + (3 if which == "atom" else 2) * c))
    # bytes: each node row used by a valid edge read once, the valid edges'
    # per-edge rows and gather ids, all ids and the mask, the weights, the
    # output written once; float data at its element size (2 for bf16)
    es = arrays[4].element_size()
    if which == "atom":
        node_rows = int(torch.unique(torch.cat(gathers)).numel())
        per_edge = (1 if arrays[5] is None else 2) * c * es + 2 * 4
    else:
        node_rows = (int(torch.unique(torch.cat(gathers[:2])).numel())
                     + rows_per_segment[2])
        per_edge = c * es + 3 * 4
    w_floats = sum(w.numel() for w in weights)
    nbytes = (node_rows * c * es + n_valid * per_edge + e * (ids.element_size() + 1)
              + w_floats * es + n * c * es)
    half = es == 2
    bound_ms, bound_by = bound(nbytes, ops, H100_BF16_FLOPS if half else H100_FP32_FLOPS)
    if half:
        f32_arrays, f32_weights = float_case(arrays, weights)
        timed["float32_kernel"] = split(
            torch, lambda: cuda(*f32_arrays, f32_weights, ids, n, mask), key)
        del f32_arrays
        timed["floors"] = chgnet_floors(torch, which, c, h, n_valid, e, n, rows_per_segment)
        timed["plan"] = K.chgnet_aggregate_plan(c, h, n, e)
        timed["host_split_us"] = host_split(torch, lambda: cuda(*arrays, weights, ids, n, mask),
                                         CHGNET_HOST_PARTS)
    return {"which": which, "dtype": str(arrays[4].dtype).split(".")[-1], "e": e,
            "valid_edges": n_valid, "channels": c, "hidden": h, "in_dim": k1,
            "n_segments": n, **timed, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "index_add_ of the materialised (E, C) "
            "message" + (" upcast to float32" if half else "") + ": the scatter alone",
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({"fp32_core_ops_ms": ops / H100_FP32_FLOPS * 1e3} if half else {}),
            "bytes": nbytes, "ops": ops, "gathered_rows": rows_per_segment}


def chgnet_floors(torch, which, c, h, n_valid, e, n, rows_per_segment):
    """The bf16 per-edge kernel's floors at this run's inputs (ms): its own
    bytes (each float32 table row the valid edges gather read once, 2 hp
    floats, the valid edges' bf16 rows and gather ids, every edge's dst id
    and mask byte, the bf16 output; ``table_bytes_no_reuse`` counts a table
    row per gathered segment and valid edge instead), the SFU (2 (H + C)
    activations a valid edge, one MUFU operation each through tanh.approx,
    16 a clock an SM at the card's largest SM clock; ``sfu_exact_ms`` the
    two of an exact expf and division) and the tensor cores (4 C H
    multiply-adds a valid edge at 989 TFLOP/s)."""
    hp = -(-h // 4) * 4
    table_bytes = sum(rows_per_segment) * 2 * hp * 4
    per_edge = (2 if which == "atom" else 1) * c * 2 + len(rows_per_segment) * 4
    nbytes = table_bytes + n_valid * per_edge + e * 5 + n * c * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_ms = n_valid * 2 * (h + c) / (sms * 16 * max_sm_clock_hz()) * 1e3
    return {"bytes": nbytes, "table_bytes": table_bytes,
            "table_bytes_no_reuse": n_valid * len(rows_per_segment) * 2 * hp * 4,
            "bytes_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "sfu_ms": sfu_ms, "sfu_exact_ms": 2 * sfu_ms,
            "tensor_core_ms": n_valid * 8 * c * h / H100_BF16_FLOPS * 1e3}


def host_split(torch, call, parts, iters=200):
    """Host µs per call of a kernel wrapper (no sync) and of its parts:
    each of ``parts`` is (name, attribute of ``kernels.edge_aggregate``,
    symbol test): the attribute's calls are timed as the part while
    ``call`` runs, or, with a symbol test, the attribute looks up a C
    function and the calls of the functions whose symbol passes are timed;
    ``checks`` is the rest (the wrapper's checks, index casts, the output's
    allocation). CHGNet's parts (``CHGNET_HOST_PARTS``): the weight
    packing, the row projections (their wrappers and launches), the CSR
    offsets and the C launch of the per-edge kernel; TensorNet's
    (``TENSORNET_HOST_PARTS``): the CSR offsets and the C launch."""
    from distmlip_tpu_torch.kernels import edge_aggregate

    spent = {name: 0.0 for name, _, _ in parts}

    def timed(part, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[part] += time.perf_counter() - t0
            return out
        return run

    def timed_lookup(part, lookup, test):
        def get(symbol, *args):
            fn = lookup(symbol, *args)
            return timed(part, fn) if test(symbol) else fn
        return get

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, attr, test in parts:
            real = getattr(edge_aggregate, attr)
            stack.enter_context(mock.patch.object(
                edge_aggregate, attr,
                timed(name, real) if test is None else timed_lookup(name, real, test)))
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        total = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {k: v / iters * 1e6 for k, v in spent.items()}
    out["checks"] = total / iters * 1e6 - sum(out.values())
    out["total"] = total / iters * 1e6
    return out


CHGNET_HOST_PARTS = (("packing", "chgnet_pack_weights", None),
                     ("projections", "chgnet_row_tables", None),
                     ("csr_offsets", "csr_row_offsets", None),
                     ("launch", "_chgnet_fn", lambda symbol: "_conv_" in symbol))
TENSORNET_HOST_PARTS = (("csr_offsets", "csr_row_offsets", None),
                        ("launch", "_fn", lambda symbol: True))


def projection_inputs(which, arrays, weights):
    """The row projections the wrapper runs for one CHGNet aggregation, as
    (x, w, bias) triples, from the wrapper's own table plan: the atom
    conv's node rows against the src and dst blocks side by side; the line
    conv's bond rows the same way and its atom rows against the center
    block."""
    from distmlip_tpu_torch.kernels import chgnet_pack_weights, chgnet_row_tables

    nodes = [arrays[0], arrays[2]] + ([arrays[5]] if which == "line" else [])
    packed = chgnet_pack_weights(weights, len(nodes) + 1, 2, arrays[4].shape[1])
    calls = []
    chgnet_row_tables(nodes, packed, lambda x, w, b: calls.append((x, w, b)))
    return calls


def check_projection(torch, x, w, b):
    """The row projection kernel vs ``x @ w + b`` within
    ``chgnet_projection_error_bound`` (float32: 2 (K + 2) u on each dot
    product's sum of |terms|; bf16 rows and blocks on the tensor cores:
    (36 ceil(K / 16) + K + 2) u), and the same bits on a second call;
    returns max |kernel - plain|."""
    from distmlip_tpu_torch import kernels as K

    got = K.chgnet_row_projection_cuda(x, w, b)
    want = K.chgnet_row_projection_reference(x, w, b)
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = K.chgnet_projection_error_bound(x, w, b)
    if not bool((err <= tol + 1e-30).all()) or got.shape != want.shape:
        raise AssertionError(f"row projection disagrees with its plain version: max |err| "
                             f"{float(err.max())}, max tolerance {float(tol.max())}")
    if not torch.equal(got, K.chgnet_row_projection_cuda(x, w, b)):
        raise AssertionError(f"row projection ({x.dtype}) differs between two calls")
    return float(err.max()) if err.numel() else 0.0


def time_projection(torch, x, w, b):
    """Call ms, kernel-alone ms, host µs, plain ms and library (one PyTorch
    call of the same function, timed the same ways: ``addmm`` in float32;
    on bf16 rows ``projection_library_call``, bf16 operands and a float32
    table, with ``addmm`` to a bf16 table beside it as
    ``library_bf16_out_ms``) of one row projection, and its bound: x and W
    at their element size, the bias read once and the float32 table
    written once; 2 R K M + R M operations at the peak rate for x's type
    (float32 on the CUDA cores; bf16 on the tensor cores, the CUDA cores'
    time beside it as ``fp32_core_ops_ms``). The plan (bf16: with its L2 ->
    shared-memory bytes) from ``chgnet_projection_plan``."""
    from distmlip_tpu_torch import kernels as K

    rows, k = x.shape
    m = w.shape[1]
    timed = split(torch, lambda: K.chgnet_row_projection_cuda(x, w, b), "row_projection")
    plain_ms = cuda_ms(torch, lambda: K.chgnet_row_projection_reference(x, w, b))
    half = x.dtype == torch.bfloat16
    bias = torch.zeros(m, device="cuda") if b is None else b
    if half:
        library, call = projection_library_call(torch, x, w, bias)
        timed.update(library_split(torch, call))
        timed["library_bf16_out_ms"] = cuda_ms(
            torch, lambda: torch.addmm(bias.bfloat16(), x, w))
    else:
        library = "torch.addmm"
        timed.update(library_split(torch, lambda: torch.addmm(bias, x, w)))
    nbytes = rows * k * x.element_size() + k * m * w.element_size() + (m + rows * m) * 4
    ops = 2 * rows * k * m + rows * m
    bound_ms, bound_by = bound(nbytes, ops, H100_BF16_FLOPS if half else H100_FP32_FLOPS)
    return {"shape": [rows, k, m], "dtype": str(x.dtype).split(".")[-1], **timed,
            "plain_ms": plain_ms, "library": library,
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({"fp32_core_ops_ms": ops / H100_FP32_FLOPS * 1e3} if half else {}),
            "bytes": nbytes,
            "plan": K.chgnet_projection_plan(rows, k, m, dtype=x.dtype)}


def chgnet_sub_case(torch, gen, which, e, rows, c, h, n_node=None):
    """A small CHGNet case: dst-sorted ids over ``rows`` rows with ~10%
    masked and a 17-edge padding tail on the last row, random inputs."""
    sub_ids = torch.sort(torch.randint(0, rows, (e,), generator=gen,
                                       device="cuda"))[0].to(torch.int32)
    sub_mask = torch.rand(e, generator=gen, device="cuda") > 0.1
    sub_mask[-17:] = False
    sub_ids[-17:] = sub_ids[-18]
    if n_node is None:
        n_node = 37 if which == "atom" else (41, 37)
    sub, sub_w = chgnet_inputs(torch, gen, which, e, c, h, n_node)
    return sub, sub_w, sub_ids, sub_mask, rows


def chgnet_kernel_cases(torch, gen, which, lg, in_r, line_ok, c):
    """One CHGNet kernel's cases at the CHGNet path's shapes: its graph, its
    real dst ids and masks, random inputs and weights at C = H = ``c``;
    then all masked, the padding-only tail on one dst row, E not a
    multiple of any block, empty dst rows, C = 7 and 16, H != C, NaN in
    the node (bond) rows no valid edge gathers, distinct tensors at the two
    gathered ends, and (atom conv) no abw. Returns the cases, the first
    being the path's own."""
    if which == "atom":
        ids, mask, n = lg.edge_dst, in_r, lg.n_cap
        arrays, weights = chgnet_inputs(torch, gen, which, ids.shape[0], c, c, n,
                                        (lg.edge_src, lg.edge_dst))
    else:
        ids, mask, n = lg.line_dst, line_ok, lg.b_cap
        arrays, weights = chgnet_inputs(torch, gen, which, ids.shape[0], c, c,
                                        (lg.b_cap, lg.n_cap),
                                        (lg.line_src, lg.line_dst, lg.line_center))
    cases = [(arrays, weights, ids, mask, n)]
    # a fully masked input, and the padding-only tail on one dst row
    one_row = torch.full_like(ids, int(ids[-1]))
    last5 = torch.arange(len(ids), device="cuda") >= len(ids) - 5
    cases += [(arrays, weights, ids, torch.zeros_like(mask), n),
              (arrays, weights, one_row, torch.zeros_like(mask), n),
              (arrays, weights, one_row, last5, n)]
    # E not a multiple of any block, empty dst rows, C = 7 and 16, H != C
    for e, rows, cc, hh in ((1003, 300, 7, 7), (517, 45, 16, 16), (300, 900, 64, 64),
                            (90, 13, 16, 12), (517, 45, 64, 32), (333, 41, 24, 64)):
        cases.append(chgnet_sub_case(torch, gen, which, e, rows, cc, hh))
    # NaN in the node (bond) rows no valid edge gathers
    sub, sub_w, sub_ids, sub_mask, rows = chgnet_sub_case(
        torch, gen, which, 700, 40, c, c, 2000 if which == "atom" else (2000, 2000))
    gathers = {0: (1, 3)} if which == "atom" else {0: (1, 3), 5: (6,)}
    for k, idx in gathers.items():
        used = torch.zeros(sub[k].shape[0], dtype=torch.bool, device="cuda")
        for i in idx:
            used[sub[i][sub_mask].long()] = True
        sub[k][~used] = float("nan")
    cases.append((sub, sub_w, sub_ids, sub_mask, rows))
    # distinct tensors at the two gathered ends (two projection passes)
    sub, sub_w, sub_ids, sub_mask, rows = chgnet_sub_case(torch, gen, which, 600, 50, c, c)
    sub[2] = torch.randn(sub[0].shape, generator=gen, device="cuda")
    cases.append((sub, sub_w, sub_ids, sub_mask, rows))
    if which == "atom":  # no per-edge weights
        cases.append((arrays[:5] + [None], weights, ids, mask, n))
    return cases


def phase_chgnet_kernels(torch):
    """Both CHGNet kernels at the CHGNet path's shapes (its graph, its real
    dst ids and masks, C = H = 64), then the edge cases; the row projection
    at the shapes the wrappers give it."""
    from distmlip_tpu_torch.tools.workload import CHGNET_KW

    gen = torch.Generator(device="cuda").manual_seed(2468)
    lg, in_r, line_ok = chgnet_graph(torch, CHGNET_REPS)
    c = CHGNET_KW["units"]
    errs, ratios, timed = {}, {}, {}
    proj_errs, proj_timed = [], []
    for which in ("atom", "line"):
        cases = chgnet_kernel_cases(torch, gen, which, lg, in_r, line_ok, c)
        arrays, weights, ids, mask, n = cases[0]
        found = [check_chgnet(torch, which, *case) for case in cases]
        errs[which] = max(f[0] for f in found)
        ratios[which] = max(f[1] for f in found)
        timed[which] = time_chgnet(torch, which, arrays, weights, ids, mask, n)
        proj = projection_inputs(which, arrays, weights)
        proj_errs += [check_projection(torch, *p) for p in proj]
        shapes = [time_projection(torch, *p) for p in proj]
        proj_timed += shapes
        timed[which]["projection_ms"] = sum(t["ms"] for t in shapes)
        log(f"[kernels] chgnet {which}: {json.dumps(timed[which])}")
        for t in shapes:
            log(f"[kernels] chgnet {which} row projection {t['shape']}: {json.dumps(t)}")
        log(f"[kernels] chgnet {which}: all {len(cases)} cases agree with the plain "
            f"version; max |err| {errs[which]}, max |err| / tolerance {ratios[which]}")
        del arrays, weights, cases
        torch.cuda.empty_cache()
    for rows, k, m, has_bias in ((1, 8, 48, True), (517, 7, 24, True), (300, 16, 64, False)):
        x = torch.randn((rows, k), generator=gen, device="cuda")
        w = torch.randn((k, m), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn(m, generator=gen, device="cuda") if has_bias else None
        proj_errs.append(check_projection(torch, x, w, b))
    log(f"[kernels] chgnet row projection: all {len(proj_errs)} cases agree with the plain "
        f"version; max |err| {max(proj_errs)}")
    return errs, timed, max(proj_errs), proj_timed


def float_case(arrays, weights):
    """A bf16 case's float tensors upcast to float32 (exactly); the same
    tensor at both gathered ends stays one tensor."""
    out, seen = [], {}
    for x in arrays:
        out.append(x if x is None or not x.is_floating_point()
                   else seen.setdefault(id(x), x.float()))
    return out, [w.float() for w in weights]


def bf16_case(case):
    """A CHGNet case with its float tensors (inputs and weights) rounded to
    bf16 once; the same tensor at both gathered ends stays one tensor."""
    arrays, weights, ids, mask, n = case
    out, seen = [], {}
    for x in arrays:
        if x is None or not x.is_floating_point():
            out.append(x)
        else:
            out.append(seen.setdefault(id(x), x.bfloat16()))
    return out, [w.bfloat16() for w in weights], ids, mask, n


def phase_chgnet_kernels_bf16(torch):
    """``[kernels] chgnet bf16``: the bf16 variants of both CHGNet kernels
    (the per-edge products on the tensor cores) on
    ``phase_chgnet_kernels``' cases (the path's graph and masks at C = H =
    64, then the edge cases) with every float input and weight rounded to
    bf16, each against its plain bf16 version within
    ``chgnet_aggregate_error_bound``'s bf16 form, each also within
    ``chgnet_tensor_core_error_bound`` of the float32 per-edge kernel on the
    upcast inputs and the same tables and bit for bit against a second
    call; each kernel's time beside the float32 kernel's in the same run,
    its floors (bytes, SFU, tensor cores), its plan (warps, blocks, shared
    bytes) and its host µs by part; the bf16 row projection (bf16 rows and packed blocks on the
    tensor cores, a float32 table) at the shapes the wrappers give it
    against its plain version within its own bar, plus K = 6 and K = 7
    (plain loads), with its plan and L2 -> shared-memory bytes. Times:
    call, kernel alone, host µs, plain, the bound at 2 bytes an element and
    the bf16 tensor-core rate, ``index_add_`` of the message upcast to
    float32 (convs), the same function's ``addmm`` to a float32 table and
    ``addmm`` to a bf16 table (projection)."""
    from distmlip_tpu_torch.tools.workload import CHGNET_KW

    gen = torch.Generator(device="cuda").manual_seed(2469)
    lg, in_r, line_ok = chgnet_graph(torch, CHGNET_REPS)
    c = CHGNET_KW["units"]
    errs, ratios, timed = {}, {}, {}
    proj_errs, proj_timed = [], []
    for which in ("atom", "line"):
        cases = [bf16_case(case)
                 for case in chgnet_kernel_cases(torch, gen, which, lg, in_r, line_ok, c)]
        arrays, weights, ids, mask, n = cases[0]
        found = [check_chgnet(torch, which, *case) for case in cases]
        errs[which] = max(f[0] for f in found)
        ratios[which] = max(f[1] for f in found)
        tc_ratio = max(f[2] for f in found if f[2] is not None)
        timed[which] = time_chgnet(torch, which, arrays, weights, ids, mask, n)
        proj = projection_inputs(which, arrays, weights)
        proj_errs += [check_projection(torch, *p) for p in proj]
        shapes = [time_projection(torch, *p) for p in proj]
        proj_timed += shapes
        timed[which]["projection_ms"] = sum(t["ms"] for t in shapes)
        log(f"[kernels] chgnet bf16 {which}: {json.dumps(timed[which])}")
        for t in shapes:
            log(f"[kernels] chgnet bf16 {which} row projection {t['shape']}: {json.dumps(t)}")
        log(f"[kernels] chgnet bf16 {which}: all {len(cases)} cases agree with the plain "
            f"bf16 version; max |err| {errs[which]}, max |err| / tolerance {ratios[which]}; "
            f"with the float32 kernel on the same tables, max |err| / bar {tc_ratio}")
        timed[which]["float32_bar_ratio"] = tc_ratio
        del arrays, weights, cases
        torch.cuda.empty_cache()
    for rows, k, m, has_bias in ((1, 8, 48, True), (517, 7, 24, True), (300, 6, 24, True),
                                 (300, 16, 64, False)):
        x = torch.randn((rows, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((k, m), generator=gen, device="cuda") / k ** 0.5).bfloat16()
        b = torch.randn(m, generator=gen, device="cuda") if has_bias else None
        proj_errs.append(check_projection(torch, x, w, b))
    log(f"[kernels] chgnet bf16 row projection: all {len(proj_errs)} cases agree with the "
        f"plain version; max |err| {max(proj_errs)}")
    t = max(proj_timed, key=lambda p: p["shape"][0])
    log(f"[kernels] chgnet bf16 row projection plan at {t['shape']}: "
        f"{json.dumps(t['plan'])} (L2 -> shared {t['plan']['l2_bytes']} bytes a call)")
    return errs, timed, max(proj_errs), proj_timed


def so2_case(torch, gen, e, l_max, c):
    """Random eSCN SO(2) inputs on the card: h (E, S, C) in the e3nn order,
    the model's m_idx and weights [W0, W1r, W1i, ...] at the init's
    1/sqrt(d) scale."""
    from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout

    lay = CoeffLayout(l_max)
    m_idx = {m: (lay.plus_idx[m], lay.minus_idx[m]) for m in range(l_max + 1)}
    h = torch.randn((e, (l_max + 1) ** 2, c), generator=gen, device="cuda")
    weights = []
    for m in range(l_max + 1):
        d = (l_max + 1 - m) * c
        weights += [torch.randn((d, d), generator=gen, device="cuda") / d ** 0.5
                    for _ in range(1 if m == 0 else 2)]
    return h, weights, m_idx


def check_so2(torch, h, weights, m_idx, c):
    """The kernel, reading and writing the e3nn order through its row table
    with the weights packed once (as ``fused_so2_conv`` calls it from the
    model), vs the plain version on the packed rows, within
    ``so2_conv_error_bound``; then the backward's route, the kernel on the
    transposed weight set and the swapped packed buffers, vs the plain VJP's
    input cotangent (``_so2_vjp``) on a random g, within the same bound of
    that set. Returns (max |err|, max |err| / bound) over both."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    perm, inv, segments = K.packed_m_layout(m_idx)
    packed = K.pack_so2_weights(weights, segments, c)
    perm_t = torch.as_tensor(perm, device="cuda").long()
    inv_t = torch.as_tensor(inv, device="cuda").long()
    g = torch.randn(h.shape, generator=torch.Generator(device="cuda").manual_seed(h.shape[0]),
                    device="cuda").to(h.dtype)
    wt = dispatch._so2_transposed_weights(weights, segments)
    checks = []
    got = K.so2_conv_cuda(h, weights, segments, c, perm, packed=packed)
    hp = h[:, perm_t]
    checks.append(("forward", got, K.so2_conv_reference(hp, weights, segments, c)[:, inv_t],
                   K.so2_conv_error_bound(hp, weights, segments, c)[:, inv_t]))
    got = K.so2_conv_cuda(g, wt, segments, c, perm, packed=packed.transposed())
    want = dispatch._so2_vjp(h, weights, g, perm_t, inv_t, segments, c, True,
                             [False] * len(weights))[0]
    checks.append(("backward", got, want,
                   K.so2_conv_error_bound(g[:, perm_t], wt, segments, c)[:, inv_t]))
    torch.cuda.synchronize()
    err_max, ratio = 0.0, 0.0
    for route, got, want, tol in checks:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"so2_conv {route} shape/dtype {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        err = (got.float() - want.float()).abs()
        if not bool((err <= tol + 1e-30).all()) or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"so2_conv {route} disagrees with its plain version: "
                                 f"max |err| {float(err.max())}, max tolerance "
                                 f"{float(tol.max())}")
        if err.numel():
            err_max = max(err_max, float(err.max()))
            ratio = max(ratio, float((err / (tol + 1e-30)).max()))
    return err_max, ratio


def time_so2(torch, h, weights, m_idx, c, iters=20):
    """Kernel, plain and library times of one SO(2) convolution. The kernel
    is timed on weights packed beforehand, as the model calls it (the
    packing, once per layer, is timed alone: ``pack_ms``, both directions),
    and on the backward's route (the transposed set, ``backward_ms``); at
    the main shape (``iters`` >= 20) also the kernel alone (``kernel_ms``,
    profiler) and the host µs a call (``host_us``). The plain version is
    the dispatcher's ``kernels=False`` path (the reference
    on the packed rows, permuted in and out); the library call is the five
    cuBLAS float32 products on operands already packed in the complex-pair
    form ([f+ | f-] and [[Wr, Wi], [-Wi, Wr]] built beforehand): the GEMM
    work alone. ``bound_ms`` is the kernel's route, 3xTF32: three TF32
    products per float32 product at the tensor cores' rate;
    ``bound_ms_fp32_cores`` the same work as float32 FMAs; in bf16 the
    bound is the operations at 989 TFLOP/s and the library call the five
    cuBLAS bf16 products."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    perm, _, segments = K.packed_m_layout(m_idx)
    e = h.shape[0]
    packed = K.pack_so2_weights(weights, segments, c)
    ms = cuda_ms(torch, lambda: K.so2_conv_cuda(h, weights, segments, c, perm,
                                                packed=packed), iters=iters)
    # the kernel alone (profiler) and the host µs a call, at the main shape
    alone = (split(torch, lambda: K.so2_conv_cuda(h, weights, segments, c, perm,
                                                 packed=packed), "so2_conv")
             if iters >= 20 else {})
    wt = dispatch._so2_transposed_weights(weights, segments)
    back = packed.transposed()
    backward_ms = cuda_ms(torch, lambda: K.so2_conv_cuda(h, wt, segments, c, perm,
                                                         packed=back), iters=iters)
    pack_ms = cuda_ms(torch, lambda: K.pack_so2_weights(weights, segments, c), iters=iters)
    with torch.no_grad():
        plain_ms = cuda_ms(torch, lambda: K.fused_so2_conv(h, weights, m_idx, c,
                                                           kernels=False), iters=iters)
    hp = h[:, torch.as_tensor(perm, device="cuda").long()]
    operands, wi = [], 0
    for m, start, nl in segments:
        d = nl * c
        if m == 0:
            operands.append((hp[:, start:start + nl].reshape(e, d).contiguous(), weights[wi]))
            wi += 1
        else:
            wr, wim = weights[wi], weights[wi + 1]
            wi += 2
            b = torch.cat([torch.cat([wr, wim], 1), torch.cat([-wim, wr], 1)], 0)
            operands.append((hp[:, start:start + 2 * nl].reshape(e, 2 * d).contiguous(), b))
    library_ms = cuda_ms(torch, lambda: [torch.matmul(a, b) for a, b in operands],
                         iters=iters)
    del operands, hp
    widths = [nl * c * (1 if m == 0 else 2) for m, _, nl in segments]
    ops = 2 * e * sum(w * w for w in widths)
    # h read once, the output written once, the weights read once
    es = h.element_size()
    nbytes = 2 * h.numel() * es + sum(w.numel() for w in weights) * es
    if h.dtype == torch.bfloat16:  # the launch plan and what it brings from L2
        plan = K.so2_bf16_plan(e, segments, c)
        first = K.so2_bf16_l2_bytes(e, widths, 192, 128)
        plan.update(l2_bytes=plan["l2_bytes_a"] + plan["l2_bytes_b"],
                    l2_bytes_first_design=first[0] + first[1])
    out = {"e": e, "s": h.shape[1], "channels": c, "dtype": str(h.dtype).split(".")[-1],
           **({"plan": plan} if h.dtype == torch.bfloat16 else {}),
           "widths": widths, "ms": ms, "kernel_ms": alone.get("kernel_ms"),
           "host_us": alone.get("host_us"), "backward_ms": backward_ms, "pack_ms": pack_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "ops": ops, "bytes": nbytes}
    if h.dtype == torch.bfloat16:
        bound_ms, bound_by = bound(nbytes, ops, H100_BF16_FLOPS)
        return dict(out, library="five cuBLAS bf16 products (fp32 accumulation) on "
                                 "pre-packed [f+|f-] and [[Wr,Wi],[-Wi,Wr]]",
                    bound_ms=bound_ms, bound_by=bound_by,
                    bound_route="bf16 tensor cores (ops / 989e12)")
    bound_ms, bound_by = bound(nbytes, 3 * ops, H100_TF32_FLOPS)
    fp32_ms, fp32_by = bound(nbytes, ops)
    return dict(out, library="five cuBLAS float32 products on pre-packed [f+|f-] and "
                             "[[Wr,Wi],[-Wi,Wr]]",
                bound_ms=bound_ms, bound_by=bound_by,
                bound_route="3xTF32 tensor cores (3 x ops / 495e12)",
                bound_ms_fp32_cores=fp32_ms, bound_by_fp32_cores=fp32_by)


def phase_so2_kernels(torch):
    """The SO(2) kernel at the eSCN path's chunk shape, then the small and
    ragged cases; and the segment sum at eSCN's row width."""
    from distmlip_tpu_torch.tools.workload import ESCN_KW

    gen = torch.Generator(device="cuda").manual_seed(97531)
    c, l_max, chunk = ESCN_KW["channels"], ESCN_KW["l_max"], ESCN_KW["edge_chunk"]
    h, weights, m_idx = so2_case(torch, gen, chunk, l_max, c)
    found = [check_so2(torch, h, weights, m_idx, c)]
    headline = time_so2(torch, h, weights, m_idx, c)
    log(f"[kernels] so2_conv {[chunk, (l_max + 1) ** 2, c]}: {json.dumps(headline)}")
    del h, weights
    torch.cuda.empty_cache()
    cases = []
    for e in (1, 37, 1003):
        for lm in (1, 2, 4, 6):
            for cc in (8, 16, 128, 7):
                if cc == 7 and lm not in (1, 4):
                    continue
                sub = so2_case(torch, gen, e, lm, cc)
                found.append(check_so2(torch, *sub, cc))
                t = time_so2(torch, *sub, cc, iters=5)
                cases.append({k: t[k] for k in ("e", "s", "channels", "ms", "backward_ms",
                                                "bound_ms", "bound_by", "plain_ms",
                                                "library_ms")})
    for t in cases:
        log(f"[kernels] so2_conv case {json.dumps(t)}")
    err, ratio = max(f[0] for f in found), max(f[1] for f in found)
    log(f"[kernels] so2_conv: all {len(found)} cases agree with the plain version, "
        f"forward and backward route; max |err| {err}, max |err| / tolerance {ratio}")
    seg = slice_case(torch, gen, chunk, ((l_max + 1) ** 2, c))
    seg_err = check_segment_sum(torch, *seg)
    seg_time = time_segment_sum(torch, *seg)
    log(f"[kernels] segment_sum at eSCN's row width: {json.dumps(seg_time)} "
        f"(max |err| {seg_err})")
    return err, headline, seg_time


def phase_so2_kernels_bf16(torch):
    """``[kernels] so2_conv bf16``: B3's bf16 kernel at the eSCN path's chunk
    shape (32768, 25, 128), forward and the backward's route, then E of 1,
    37 and 1003 at l_max 1, 2, 4, 6 and C 8, 16, 128 and 7 (the TMA rows,
    the 16-byte and the element copies), each against its plain bf16
    version within ``so2_conv_error_bound``'s bf16 form; times against the
    bf16 cuBLAS products and the bf16 tensor-core bound."""
    from distmlip_tpu_torch.tools.workload import ESCN_KW

    gen = torch.Generator(device="cuda").manual_seed(86420)
    c, l_max, chunk = ESCN_KW["channels"], ESCN_KW["l_max"], ESCN_KW["edge_chunk"]
    h, weights, m_idx = so2_case(torch, gen, chunk, l_max, c)
    h, weights = h.bfloat16(), [w.bfloat16() for w in weights]
    found = [check_so2(torch, h, weights, m_idx, c)]
    headline = time_so2(torch, h, weights, m_idx, c)
    log(f"[kernels] so2_conv bf16 {[chunk, (l_max + 1) ** 2, c]}: {json.dumps(headline)}")
    plan = headline["plan"]
    # the rate at which the kernel alone filled shared memory from L2
    rate = (f"{plan['l2_bytes'] / headline['kernel_ms'] / 1e9:.3f} TB/s"
            if headline["kernel_ms"] else "not measured")
    log(f"[kernels] so2_conv bf16 plan: {plan['tile_rows']} x {plan['tile_cols']} tiles, "
        f"{plan['tiles']} tiles on {plan['blocks']} blocks; L2 -> shared "
        f"{plan['l2_bytes']} bytes a call (A {plan['l2_bytes_a']}, B {plan['l2_bytes_b']}; "
        f"the first design's 192 x 128 tiles: {plan['l2_bytes_first_design']}), "
        f"{rate} over the kernel alone")
    del h, weights
    torch.cuda.empty_cache()
    for e in (1, 37, 1003):
        for lm in (1, 2, 4, 6):
            for cc in (8, 16, 128, 7):
                if cc == 7 and lm not in (1, 4):
                    continue
                h, weights, mi = so2_case(torch, gen, e, lm, cc)
                found.append(check_so2(torch, h.bfloat16(), [w.bfloat16() for w in weights],
                                       mi, cc))
    err, ratio = max(f[0] for f in found), max(f[1] for f in found)
    log(f"[kernels] so2_conv bf16: all {len(found)} cases agree with the plain version, "
        f"forward and backward route; max |err| {err}, max |err| / tolerance {ratio}")
    return err, headline


def check_result(res, n_atoms):
    import numpy as np

    if not (np.isfinite(res["energy"]) and res["forces"].shape == (n_atoms, 3)
            and res["stress"].shape == (3, 3)
            and np.isfinite(res["forces"]).all() and np.isfinite(res["stress"]).all()):
        raise AssertionError("non-finite or misshapen outputs")
    if "magmoms" in res and not (res["magmoms"].shape == (n_atoms,)
                                 and np.isfinite(res["magmoms"]).all()):
        raise AssertionError("non-finite or misshapen magmoms")


def drive(torch, pot, atoms, rng, calculate=None):
    """One calculate plus STEPS MD-like moves through ``pot`` (or through
    ``calculate``, an entry point over it such as ``UMAPredictor``'s), with
    every launch count, and the chunk counts of the edge aggregations' plain
    backward (``kernels.recompute_chunks``), set to 0 just before; the
    launches are read just after. Returns the geometries, results, per-step
    seconds, launches and peak memory."""
    from distmlip_tpu_torch.kernels import launch_counts, recompute_chunks

    geometries, results, step_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    recompute_chunks.clear()
    for step in range(1 + STEPS):
        if step:
            atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        geometries.append(atoms.positions.copy())
        t = time.perf_counter()
        res = (calculate or pot.calculate)(atoms)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        results.append(res)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for res in results:
        check_result(res, len(atoms))
    if pot.rebuild_count != 1:
        raise AssertionError(f"graph rebuilt after step 1 ({pot.rebuild_count} builds)")
    return geometries, results, step_s, launches, peak


def compare_with_plain(torch, ref_pot, atoms, geometries, results, tag):
    """The same geometries through a ``kernels=False`` potential on the
    card, which must launch nothing; returns the worst deltas and the
    reference path's step times and peak memory."""
    import numpy as np

    from distmlip_tpu_torch.kernels import launch_counts

    before = dict(launch_counts)
    worst = {"rel_dE": 0.0, "max_dF": 0.0, "max_dS": 0.0}
    if "magmoms" in results[0]:
        worst["max_dm"] = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for pos, res in zip(geometries, results):
        atoms.positions = pos.copy()
        t = time.perf_counter()
        ref = ref_pot.calculate(atoms)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        worst["rel_dE"] = max(worst["rel_dE"],
                              abs(res["energy"] - ref["energy"]) / abs(ref["energy"]))
        worst["max_dF"] = max(worst["max_dF"],
                              float(np.abs(res["forces"] - ref["forces"]).max()))
        worst["max_dS"] = max(worst["max_dS"],
                              float(np.abs(res["stress"] - ref["stress"]).max()))
        if "max_dm" in worst:
            worst["max_dm"] = max(worst["max_dm"],
                                  float(np.abs(res["magmoms"] - ref["magmoms"]).max()))
    peak = torch.cuda.max_memory_allocated()
    if dict(launch_counts) != before:
        raise AssertionError("the kernels=False reference launched a kernel")
    log(f"[{tag}] kernels vs plain on the card over {len(geometries)} geometries: "
        f"{json.dumps(worst)}")
    if not (worst["rel_dE"] < 1e-5 and worst["max_dF"] < 1e-4 and worst["max_dS"] < 1e-4
            and worst.get("max_dm", 0.0) < 1e-4):
        raise AssertionError(f"{tag}: main path disagrees with its plain reference")
    return worst, step_s, peak


def summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results, launches,
              expected):
    steady, ref_steady = step_s[1:], ref_step_s[1:]
    return {
        "n_atoms": len(atoms), "n_edges": stats["n_edges"], "e_cap": stats["e_cap"],
        "n_cap": stats["n_cap"],
        "first_calculate_ms": step_s[0] * 1e3,
        "step_ms": [x * 1e3 for x in steady],
        "atoms_per_s": len(atoms) / (sum(steady) / len(steady)),
        "max_memory_allocated_bytes": peak,
        "plain": {"first_calculate_ms": ref_step_s[0] * 1e3,
                  "step_ms": [x * 1e3 for x in ref_steady],
                  "atoms_per_s": len(atoms) / (sum(ref_steady) / len(ref_steady)),
                  "max_memory_allocated_bytes": ref_peak},
        "energy": results[-1]["energy"],
        "launches": launches, "launches_expected": expected,
    }


def phase_main_path(torch):
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    t0 = time.perf_counter()
    model = MACE(MACEConfig(**MACE_KW))
    params = model.init(0)
    atoms, rng = bench_atoms()
    pot = DistPotential(model, params, device="cuda", skin=0.5, compute_stress=True)
    log(f"[main] model + params + potential built in {time.perf_counter() - t0:.2f} s")

    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    stats = pot.last_stats
    K = chunk_layout(stats["e_cap"], MACE_KW["edge_chunk"])[2]
    n_calc = 1 + STEPS
    per_calc = MACE_KW["num_interactions"] * 2 * K
    expected = {k: 0 for k in launches}
    expected["segment_sum"] = n_calc * per_calc
    log(f"[main] segment_sum launches: {n_calc} calculates x "
        f"{MACE_KW['num_interactions']} interactions x (K={K} forward chunks + "
        f"K={K} backward recomputes of the checkpointed chunk bodies) = "
        f"{expected['segment_sum']}; counted {launches['segment_sum']} "
        f"(e_cap {stats['e_cap']}, edge_chunk {MACE_KW['edge_chunk']})")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} differ from the "
                             f"derivation {expected}")

    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False)
    _, ref_step_s, ref_peak = compare_with_plain(torch, ref_pot, atoms, geometries,
                                                 results, "main")
    summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results,
                        launches, expected)
    summary["edge_chunks"] = K
    log(f"[main] {json.dumps(summary)}")
    return launches


def zbl_energy(torch, model, pot):
    """The ZBL pair term of ``pot``'s cached P = 1 graph at its build
    positions, in eV (``models/pair.py`` ``zbl_edge_energy``, half per
    directed edge), on the card's plain path."""
    from distmlip_tpu_torch.models.pair import zbl_edge_energy
    from distmlip_tpu_torch.parallel import local_graph_from_stacked

    graph = pot._cache[0]
    lg = local_graph_from_stacked(graph, kernels=False)
    vec = lg.edge_vectors(graph.positions[0])
    d = torch.linalg.norm(torch.where(lg.edge_mask[:, None], vec, torch.ones_like(vec)), dim=-1)
    z = torch.as_tensor(model.cfg.atomic_numbers, device=d.device)[lg.species]
    e = zbl_edge_energy(z[lg.edge_src], z[lg.edge_dst], d, p=model.cfg.cutoff_p)
    return float(0.5 * torch.where(lg.edge_mask, e, torch.zeros_like(e)).sum())


def phase_main_zbl(torch):
    """``[main-zbl]``: MACE at MACE_KW with ``zbl=True`` (MACE-MP-0b's ZBL
    pair term under the learned potential; ``atomic_numbers`` the identity,
    since the species index is the atomic number here, where the config's
    default would read index i as Z = i + 1) on the 2048-atom crystal, as
    ``[main]``: one calculate plus STEPS moves, launches derived, against
    ``kernels=False`` on the card at the repo's bar. The pair term's edge
    sum is one segment sum of width 1 per calculate (the kernel's narrow
    mapping: a warp per dst row). Si's nearest neighbours there (2.76 Å) lie
    beyond twice silicon's covalent radius (2.22 Å), where the pair term is
    exactly 0; so the width-1 call alone at that graph's own dst ids and
    mask (kernel against plain, its time beside the plain version's,
    ``index_add_`` and its bytes bound), then a small MACE on 32 Si packed
    closer, where the term is not 0, on the card against ``kernels=False``
    and the CPU."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    model = MACE(MACEConfig(**MACE_KW, zbl=True,
                            atomic_numbers=tuple(range(MACE_KW["num_species"]))))
    params = model.init(0)
    atoms, rng = bench_atoms()
    pot = DistPotential(model, params, device="cuda", skin=0.5)
    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    stats = pot.last_stats
    K = chunk_layout(stats["e_cap"], MACE_KW["edge_chunk"])[2]
    n_calc = 1 + STEPS
    expected = {k: 0 for k in launches}
    expected["segment_sum"] = n_calc * (MACE_KW["num_interactions"] * 2 * K + 1)
    log(f"[main-zbl] segment_sum launches: {n_calc} calculates x ({MACE_KW['num_interactions']}"
        f" interactions x 2K (K={K}) + 1 width-1 ZBL edge sum) = {expected['segment_sum']}; "
        f"counted {launches['segment_sum']}")
    if launches != expected:
        raise AssertionError(f"[main-zbl] kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    e_zbl = zbl_energy(torch, model, pot)
    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False)
    _, ref_step_s, ref_peak = compare_with_plain(torch, ref_pot, atoms, geometries,
                                                 results, "main-zbl")
    # the width-1 call alone, at the crystal's graph's own ids and mask
    lg = local_graph_from_stacked(pot._cache[0])
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = torch.randn((lg.e_cap, 1), generator=gen, device="cuda")
    err = check_segment_sum(torch, data, lg.edge_dst, lg.edge_mask, lg.n_cap)
    width1 = time_segment_sum(torch, data, lg.edge_dst, lg.edge_mask, lg.n_cap)
    width1["max_abs_err"] = err
    log(f"[main-zbl] width-1 segment sum at the graph's rows: {json.dumps(width1)}")
    del lg, data, ref_pot
    # where the pair term is not 0: 32 Si at a = 3.1 Å (nearest neighbours
    # ~2.19 Å, rattled by 0.1 Å) through a small MACE with zbl=True, on the
    # card against kernels=False and against the CPU (the 2048-atom crystal
    # compressed that far drives the random full-width weights to ~1e5 eV,
    # where float32 forces leave the absolute bar)
    small = MACE(MACEConfig(num_species=MACE_KW["num_species"], channels=16, l_max=2, a_lmax=2,
                            hidden_lmax=1, correlation=2, cutoff=4.0, edge_chunk=128,
                            zbl=True, atomic_numbers=tuple(range(MACE_KW["num_species"]))))
    small_params = small.init(0)
    close = small_structure(3.1, 0.1, 1)
    close.numbers[:] = 14
    outs = {}
    for name, kw in (("kernels", dict(device="cuda")), ("plain", dict(device="cuda", kernels=False)),
                     ("cpu", dict(device="cpu"))):
        p = DistPotential(small, small_params, skin=0.5, **kw)
        outs[name] = p.calculate(close)
        check_result(outs[name], len(close))
        if name == "kernels":
            e_zbl_close = zbl_energy(torch, small, p)
    d_close = {k: worst_deltas([outs["kernels"]], [outs[k]]) for k in ("plain", "cpu")}
    log(f"[main-zbl] 32 Si at a = 3.1 Å (ZBL {e_zbl_close:.6f} eV of "
        f"{outs['kernels']['energy']:.6f} eV): card kernels vs {json.dumps(d_close)}; "
        f"energies {json.dumps({k: v['energy'] for k, v in outs.items()})}, threads "
        f"{torch.get_num_threads()}")
    if not (all(within_bar(d) for d in d_close.values()) and e_zbl_close > 0.0):
        raise AssertionError("[main-zbl] the close-packed structure disagrees with its plain "
                             "references, or its ZBL term is 0")
    summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results, launches,
                        expected)
    summary.update(edge_chunks=K, zbl_energy=e_zbl, close_zbl_energy=e_zbl_close,
                   close_energy=outs["kernels"]["energy"], close_vs=d_close)
    log(f"[main-zbl] {json.dumps(summary)}")
    del pot
    return launches, width1


def phase_tensornet(torch):
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import recompute_chunks
    from distmlip_tpu_torch.kernels.dispatch import DEFAULT_BWD_CHUNK
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    t0 = time.perf_counter()
    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    params = model.init(0)
    atoms, rng = bench_atoms(TENSORNET_REPS)
    pot = DistPotential(model, params, device="cuda", skin=0.5)
    log(f"[main-tensornet] model + params + potential built in "
        f"{time.perf_counter() - t0:.2f} s")

    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    chunks = dict(recompute_chunks)  # reset by drive; read just after it
    n_calc, layers = 1 + STEPS, TENSORNET_KW["num_layers"]
    expected = {k: 0 for k in launches}
    expected["tensornet_embed_aggregate"] = n_calc
    expected["tensornet_interaction_aggregate"] = n_calc * layers
    expected["tensornet_interaction_backward"] = n_calc * layers
    # the embed's backward is still the plain chunked recompute; the
    # interaction's backward is the kernel, with no recompute chunk
    e_cap = pot.last_stats["e_cap"]
    chunks_expected = {"tensornet_embed_aggregate": n_calc * -(-e_cap // DEFAULT_BWD_CHUNK)}
    log(f"[main-tensornet] edge-aggregate launches: {n_calc} calculates x (1 embed + "
        f"{layers} interactions forward + {layers} interaction backwards) = "
        f"{n_calc * (1 + 2 * layers)}; counted {launches}. Plain backward recompute chunks: "
        f"{n_calc} x ceil({e_cap} / {DEFAULT_BWD_CHUNK}) for the embed, none for the "
        f"interaction; counted {chunks}")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    if chunks != chunks_expected:
        raise AssertionError(f"plain backward chunks {chunks} differ from the derivation "
                             f"{chunks_expected}")

    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False)
    _, ref_step_s, ref_peak = compare_with_plain(torch, ref_pot, atoms, geometries,
                                                 results, "main-tensornet")
    summary = summarize(atoms, pot.last_stats, step_s, peak, ref_step_s, ref_peak,
                        results, launches, expected)
    log(f"[main-tensornet] {json.dumps(summary)}")
    return launches


def phase_chgnet(torch):
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, bench_atoms

    t0 = time.perf_counter()
    model = CHGNet(CHGNetConfig(**CHGNET_KW))
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    # readout terms off their defaults, so a dropped one would show
    params["species_ref"]["w"] = torch.randn((CHGNET_KW["num_species"], 1), generator=gen)
    params["data_std"] = torch.tensor(1.3)
    atoms, rng = bench_atoms(CHGNET_REPS)
    pot = DistPotential(model, params, device="cuda", skin=0.5, compute_magmom=True)
    log(f"[main-chgnet] model + params + potential built in "
        f"{time.perf_counter() - t0:.2f} s")

    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    n_calc, blocks = 1 + STEPS, CHGNET_KW["num_blocks"]
    expected = {k: 0 for k in launches}
    expected["chgnet_atom_conv_aggregate"] = n_calc * blocks
    expected["chgnet_line_aggregate"] = n_calc * (blocks - 1)
    # row projections: the atom conv gathers v_post at src and dst (one
    # tensor, halo.py overlapped_edge_sum): one pass; the line conv gathers
    # b at both ends (one pass) and v at the centers (one more)
    expected["chgnet_row_projection"] = n_calc * (blocks * 1 + (blocks - 1) * 2)
    log(f"[main-chgnet] edge-aggregate launches: {n_calc} calculates x ({blocks} atom "
        f"convs + {blocks - 1} line convs) = {n_calc * blocks} + "
        f"{n_calc * (blocks - 1)} forward launches, none in the backward; row projections "
        f"{n_calc} x ({blocks} x 1 + {blocks - 1} x 2) = "
        f"{expected['chgnet_row_projection']}; counted {launches}")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} differ from the "
                             f"derivation {expected}")

    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False,
                            compute_magmom=True)
    _, ref_step_s, ref_peak = compare_with_plain(torch, ref_pot, atoms, geometries,
                                                 results, "main-chgnet")
    stats = pot.last_stats
    summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results,
                        launches, expected)
    summary.update({k: stats[k] for k in ("b_cap", "n_bonds", "l_cap", "n_lines")})
    log(f"[main-chgnet] {json.dumps(summary)}")
    return launches


def phase_escn(torch):
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import ESCN, ESCNConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import ESCN_INFO, ESCN_KW, bench_atoms

    t0 = time.perf_counter()
    model = ESCN(ESCNConfig(**ESCN_KW))
    params = model.init(0)
    # the readout's reference energies off their zero default, so a dropped
    # term would show
    params["species_ref"]["w"] = torch.randn((ESCN_KW["num_species"],),
                                             generator=torch.Generator().manual_seed(0))
    atoms, rng = bench_atoms()
    atoms.info = dict(ESCN_INFO)
    pot = DistPotential(model, params, device="cuda", skin=0.5)
    log(f"[main-escn] model + params + potential built in "
        f"{time.perf_counter() - t0:.2f} s")

    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    stats = pot.last_stats
    K = chunk_layout(stats["e_cap"], ESCN_KW["edge_chunk"])[2]
    n_calc, layers = 1 + STEPS, ESCN_KW["num_layers"]
    expected = {k: 0 for k in launches}
    expected["so2_conv"] = n_calc * layers * 3 * K
    expected["segment_sum"] = n_calc * (1 + layers) * 2 * K
    log(f"[main-escn] launches: {n_calc} calculates x (K={K} forward chunks + K={K} "
        f"backward recomputes of the checkpointed chunk bodies + K={K} input cotangents "
        f"of so2_conv's backward) x {layers} layers for so2_conv = "
        f"{expected['so2_conv']}; {n_calc} x 2K x (1 edge-degree pass + {layers} layers) "
        f"for segment_sum = {expected['segment_sum']}; counted {launches} "
        f"(e_cap {stats['e_cap']}, edge_chunk {ESCN_KW['edge_chunk']})")
    if launches != expected:
        raise AssertionError(f"kernel launch counts {launches} differ from the "
                             f"derivation {expected}")

    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False)
    _, ref_step_s, ref_peak = compare_with_plain(torch, ref_pot, atoms, geometries,
                                                 results, "main-escn")
    summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results,
                        launches, expected)
    summary["edge_chunks"] = K
    summary["rebuilds"] = pot.rebuild_count
    log(f"[main-escn] {json.dumps(summary)}")
    return launches


def result_deltas(n, a_list, b_list):
    """The worst of each difference of results ``a_list`` from ``b_list``
    (one per geometry) on ``n`` atoms: dE per atom, rel dE, and max |dF|,
    |dS| (and |dm|) over the largest of ``b``'s."""
    import numpy as np

    pairs = list(zip(a_list, b_list))
    d = {"dE_per_atom": max(abs(a["energy"] - b["energy"]) / n for a, b in pairs),
         "rel_dE": max(abs(a["energy"] - b["energy"]) / abs(b["energy"]) for a, b in pairs),
         "dF_rel": max(float(np.abs(a["forces"] - b["forces"]).max()
                             / np.abs(b["forces"]).max()) for a, b in pairs),
         "dS_rel": max(float(np.abs(a["stress"] - b["stress"]).max()
                             / np.abs(b["stress"]).max()) for a, b in pairs)}
    if "magmoms" in b_list[0]:
        d["dm_rel"] = max(float(np.abs(a["magmoms"] - b["magmoms"]).max()
                                / np.abs(b["magmoms"]).max()) for a, b in pairs)
    return d


def bf16_within_bars(tag, vs_plain, vs32, plain_vs32):
    """The bf16 bars (module docstring, phase 12): both routes within rel dE
    < 2e-2 and max |dF| < 0.3 max |F| of float32, the kernels' route within
    rel dE < 1e-3 and max |dF| < 0.1 max |F| (max |dm| < 0.05 max |m|) of
    the plain one and no further from float32 than it (x 1.25 + 0.005)."""
    if not (vs32["rel_dE"] < 2e-2 and vs32["dF_rel"] < 0.3
            and plain_vs32["rel_dE"] < 2e-2 and plain_vs32["dF_rel"] < 0.3):
        raise AssertionError(f"[{tag}] bf16 departs from the port's float32 past bf16's "
                             f"noise: kernels {vs32}, plain {plain_vs32}")
    if not (vs_plain["rel_dE"] < 1e-3 and vs_plain["dF_rel"] < 0.1
            and vs_plain.get("dm_rel", 0.0) < 0.05
            and vs32["dF_rel"] <= 1.25 * plain_vs32["dF_rel"] + 0.005):
        raise AssertionError(f"[{tag}] the bf16 kernels' route departs from the plain "
                             f"route: {vs_plain}; from float32 {vs32} against {plain_vs32}")


def phase_main_bf16(torch, family):
    """``[main-bf16]`` (MACE at MACE_BF16_KW, bench.py's configuration) or
    ``[main-escn-bf16]`` (eSCN at ESCN_BF16_KW, example 05's, with ESCN_INFO)
    on the 2048-atom crystal, or ``[main-tensornet-bf16]`` (TensorNet at
    TENSORNET_BF16_KW) or ``[main-chgnet-bf16]`` (CHGNet at CHGNET_BF16_KW
    with magmoms, ``[main-chgnet]``'s readout terms) on the 16384-atom one:
    ``drive``'s 4 calculates with the launch counts derived as the float32
    paths' but on the bf16 kernels (TensorNet: the embed's plain backward
    chunks too, keyed by its message; CHGNet: every conv's, ceil(e_cap /
    32768) a atom conv and ceil(l_cap / 32768) a line conv); the same
    geometries through ``kernels=False`` (bf16) and the port's float32 on
    the card. Both bf16 routes within rel dE < 2e-2 and max |dF| < 0.3 max
    |F| of float32 (bf16's own distance at these widths, a sanity bar), the
    kernels' route within rel dE < 1e-3 and max |dF| < 0.1 max |F| (and max
    |dm| < 0.05 max |m|) of the plain one and no further from float32 than
    it (x 1.25 + 0.005 max |F|); step ms and peak beside float32's."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts, recompute_chunks
    from distmlip_tpu_torch.kernels.dispatch import DEFAULT_BWD_CHUNK
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import (CHGNET_BF16_KW, CHGNET_KW, ESCN_BF16_KW,
                                                   ESCN_INFO, ESCN_KW, MACE_BF16_KW, MACE_KW,
                                                   TENSORNET_BF16_KW, TENSORNET_KW,
                                                   bench_atoms)

    tag, cls, cfg, kw16, kw32 = {
        "mace": ("main-bf16", MACE, MACEConfig, MACE_BF16_KW, MACE_KW),
        "escn": ("main-escn-bf16", ESCN, ESCNConfig, ESCN_BF16_KW, ESCN_KW),
        "tensornet": ("main-tensornet-bf16", TensorNet, TensorNetConfig, TENSORNET_BF16_KW,
                      TENSORNET_KW),
        "chgnet": ("main-chgnet-bf16", CHGNet, CHGNetConfig, CHGNET_BF16_KW,
                   CHGNET_KW)}[family]
    model = cls(cfg(**kw16))
    params = model.init(0)
    atoms, rng = bench_atoms({"tensornet": TENSORNET_REPS, "chgnet": CHGNET_REPS}.get(family, 8))
    pot_kw = {}
    if family == "escn":
        params["species_ref"]["w"] = torch.randn((kw16["num_species"],),
                                                 generator=torch.Generator().manual_seed(0))
        atoms.info = dict(ESCN_INFO)
    elif family == "chgnet":  # [main-chgnet]'s readout terms, off their defaults
        params["species_ref"]["w"] = torch.randn((kw16["num_species"], 1),
                                                 generator=torch.Generator().manual_seed(0))
        params["data_std"] = torch.tensor(1.3)
        pot_kw = {"compute_magmom": True}
    pot = DistPotential(model, params, device="cuda", skin=0.5, **pot_kw)
    geometries, results, step_s, launches, peak = drive(torch, pot, atoms, rng)
    chunks = dict(recompute_chunks)  # reset by drive; read just after it
    stats = pot.last_stats
    n_calc = 1 + STEPS
    expected = {k: 0 for k in launches}
    chunks_expected = {}  # MACE and eSCN run no edge aggregation
    if family == "tensornet":
        K = None
        layers = kw16["num_layers"]
        expected["tensornet_embed_aggregate_bf16"] = n_calc
        expected["tensornet_interaction_aggregate_bf16"] = n_calc * layers
        expected["tensornet_interaction_backward_bf16"] = n_calc * layers
        # the embed's backward is still the plain chunked recompute
        chunks_expected = {"tensornet_embed_aggregate":
                           n_calc * -(-stats["e_cap"] // DEFAULT_BWD_CHUNK)}
        log(f"[{tag}] first calculate (host graph build and the first bf16 TensorNet "
            f"calculate of the process): {step_s[0] * 1e3:.1f} ms")
    elif family == "chgnet":
        K = None
        blocks = kw16["num_blocks"]
        expected["chgnet_atom_conv_aggregate_bf16"] = n_calc * blocks
        expected["chgnet_line_aggregate_bf16"] = n_calc * (blocks - 1)
        expected["chgnet_row_projection_bf16"] = n_calc * (blocks + 2 * (blocks - 1))
        # no backward kernel: each conv's backward is the plain chunked
        # recompute over its edges (lines)
        chunks_expected = {
            "chgnet_atom_conv_aggregate":
                n_calc * blocks * -(-stats["e_cap"] // DEFAULT_BWD_CHUNK),
            "chgnet_line_aggregate":
                n_calc * (blocks - 1) * -(-stats["l_cap"] // DEFAULT_BWD_CHUNK)}
    else:
        K = chunk_layout(stats["e_cap"], kw16["edge_chunk"])[2]
    if family == "mace":
        expected["segment_sum_bf16"] = n_calc * kw16["num_interactions"] * 2 * K
    elif family == "escn":
        expected["so2_conv_bf16"] = n_calc * kw16["num_layers"] * 3 * K
        expected["segment_sum_bf16"] = n_calc * (1 + kw16["num_layers"]) * 2 * K
    log(f"[{tag}] launches derived as the float32 path's, on the bf16 kernels (K={K}): "
        f"{json.dumps({k: v for k, v in expected.items() if v})}; counted {launches}; "
        f"plain backward chunks {chunks}")
    if launches != expected or chunks != chunks_expected:
        raise AssertionError(f"[{tag}] kernel launch counts {launches} or plain backward "
                             f"chunks {chunks} differ from the derivation {expected}, "
                             f"{chunks_expected}")
    def run(p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, secs = [], []
        for pos in geometries:
            atoms.positions = pos.copy()
            t = time.perf_counter()
            res.append(p.calculate(atoms))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return res, secs, torch.cuda.max_memory_allocated()

    before = dict(launch_counts)
    plain, ref_step_s, ref_peak = run(DistPotential(model, params, device="cuda", skin=0.5,
                                                    kernels=False, **pot_kw))
    if dict(launch_counts) != before:
        raise AssertionError(f"[{tag}] the kernels=False reference launched a kernel")
    f32, f32_s, f32_peak = run(DistPotential(cls(cfg(**kw32)), params, device="cuda",
                                             skin=0.5, **pot_kw))
    # bf16 against bf16: the two routes round the segment sums' fp32 values
    # at other ulps where they straddle a rounding boundary, and the model
    # carries those flips on; the measure of that noise is how far each
    # route lies from the float32 result
    vs_plain, vs32, plain_vs32 = (result_deltas(len(atoms), results, plain),
                                  result_deltas(len(atoms), results, f32),
                                  result_deltas(len(atoms), plain, f32))
    summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results, launches,
                        expected)
    summary.update(edge_chunks=K, recompute_chunks=chunks, vs_plain=vs_plain, vs_float32=vs32,
                   plain_vs_float32=plain_vs32, float32={
                       "first_calculate_ms": f32_s[0] * 1e3,
                       "step_ms": [x * 1e3 for x in f32_s[1:]],
                       "atoms_per_s": len(atoms) / (sum(f32_s[1:]) / len(f32_s[1:])),
                       "max_memory_allocated_bytes": f32_peak})
    log(f"[{tag}] {json.dumps(summary)}")
    # both routes within bf16's own distance from float32 at these widths
    # (PERF.md §6: the JAX package's bf16 path is as far from its
    # float32 at MACE-MP-0-medium widths), and the kernels' route no further
    # from float32 than the plain route (25% and 0.5% of max |F| of slack)
    bf16_within_bars(tag, vs_plain, vs32, plain_vs32)
    return launches


def phase_segment_sum_escn_md(torch):
    """``[kernels] segment_sum escn_md``: B1 at ESCNMD's edge-scan rows,
    (32768, (lmax+1)^2, C) = (32768, 9, 128) at the UMA-S widths, in float32
    and bf16 (1152 bf16 columns: the row kernel), on one chunk's dst-sorted
    ids at the ``[uma]`` graph's mean edges a dst row (bench.py's crystal at
    the cutoff + 0.5 Å skin), each against its plain version."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.neighbors import neighbor_list
    from distmlip_tpu_torch.tools.workload import UMA_KW, bench_atoms

    t0 = time.perf_counter()
    atoms, _ = bench_atoms()
    nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, UMA_KW["cutoff"] + 0.5)
    per_row = round(len(nl.src) / len(atoms))
    gen = torch.Generator(device="cuda").manual_seed(8642)
    rows = ((UMA_KW["lmax"] + 1) ** 2, UMA_KW["sphere_channels"])
    data, ids, mask, n = slice_case(torch, gen, UMA_KW["edge_chunk"], rows, per_row=per_row)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        d = data.to(dtype)
        err = check_segment_sum(torch, d, ids, mask, n)
        t = {**time_segment_sum(torch, d, ids, mask, n), "max_abs_err": err,
             "edges_per_row": per_row}
        if dtype == torch.bfloat16:
            t = with_plan(t, K.segment_sum_bf16_plan(d, ids))
        out[t["dtype"]] = t
        log(f"[kernels] segment_sum escn_md {t['dtype']} {t['shape']}: {json.dumps(t)}")
    log(f"[kernels] segment_sum escn_md: both dtypes agree with the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    return out


def upstream_dicts():
    """``tests/torch_upstream_dicts.py`` of this checkout, loaded by its
    path: ``tests/`` has no ``__init__.py``, and a regular ``tests``
    package installed on the machine would win over it as an import."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_upstream_dicts.py")
    spec = importlib.util.spec_from_file_location("torch_upstream_dicts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def uma_params(torch):
    """UMA-S parameters as a user gets them from a checkpoint: a synthetic
    fairchem-named state dict at ``UMA_KW``'s widths (32 experts stacked on
    each SO(2) weight; ``tests/torch_upstream_dicts.py``, numpy seed 0)
    through the port's ``from_torch`` onto ``ESCNMD(UMA_KW).init(0)``, with
    zero unmapped tensors; ``species_ref`` (not in a fairchem checkpoint)
    off its zero default, so a dropped term would show."""
    import numpy as np

    from distmlip_tpu_torch.models import ESCNMD, ESCNMDConfig
    from distmlip_tpu_torch.models.convert import from_torch
    from distmlip_tpu_torch.tools.workload import UMA_KW

    t0 = time.perf_counter()
    model = ESCNMD(ESCNMDConfig(**UMA_KW))
    sd = upstream_dicts().escn_state_dict(model.cfg, np.random.default_rng(0))
    t1 = time.perf_counter()
    params, report = from_torch("escn", sd, model.init(0), model=model)
    if report["unused_torch"] or report["mapped"] != len(sd):
        raise AssertionError(f"[uma] conversion left tensors unmapped: {report}")
    n_values = sum(int(np.prod(np.shape(v))) for v in sd.values())
    params["species_ref"]["w"] = torch.randn((UMA_KW["max_num_elements"],),
                                             generator=torch.Generator().manual_seed(0))
    log(f"[uma] {len(sd)} fairchem-named tensors ({n_values} values) built in "
        f"{t1 - t0:.2f} s, converted by from_torch in {time.perf_counter() - t1:.2f} s, "
        f"0 unmapped")
    return params


def phase_uma(torch):
    """``[uma]`` and ``[uma-bf16]``: ESCNMD at the UMA-S widths (``UMA_KW``)
    with converted parameters (``uma_params``), driven through
    ``UMAPredictor(task_name="omat", device="cuda", skin=0.5)`` with charge
    1 and spin 1 on the 2048-atom crystal: ``drive``'s 4 calculates, B1's
    launches against (1 edge-degree pass + num_layers) x 2K per calculate
    (K edge chunks forward and K recomputes of the checkpointed chunk bodies
    in the backward; the SO(2) and FFN products are plain matrix products,
    as outside Pallas in the JAX package), then the same geometries through
    a ``kernels=False`` predictor on the card: float32 within the repo's
    bar; bf16 (``UMA_BF16_KW``) within the bf16 bars against its plain
    route and the float32 results. Returns both runs' launches."""
    from distmlip_tpu_torch.calculators import UMAPredictor
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import ESCNMD, ESCNMDConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import UMA_BF16_KW, UMA_INFO, UMA_KW, bench_atoms

    params = uma_params(torch)
    launched, f32 = {}, None
    for tag, kw in (("uma", UMA_KW), ("uma-bf16", UMA_BF16_KW)):
        t0 = time.perf_counter()
        model = ESCNMD(ESCNMDConfig(**kw))
        atoms, rng = bench_atoms()
        atoms.info = dict(UMA_INFO)
        pred = UMAPredictor(model, params, task_name="omat", device="cuda", skin=0.5)
        geometries, results, step_s, launches, peak = drive(torch, pred.potential, atoms, rng,
                                                            calculate=pred.calculate)
        stats = pred.potential.last_stats
        K = chunk_layout(stats["e_cap"], kw["edge_chunk"])[2]
        n_calc, layers = 1 + STEPS, kw["num_layers"]
        key = "segment_sum_bf16" if kw.get("dtype") == "bfloat16" else "segment_sum"
        expected = {k: 0 for k in launches}
        expected[key] = n_calc * (1 + layers) * 2 * K
        log(f"[{tag}] launches: {n_calc} calculates x (1 edge-degree pass + {layers} layers) "
            f"x (K={K} forward chunks + K={K} backward recomputes of the checkpointed chunk "
            f"bodies) for {key} = {expected[key]}; counted "
            f"{ {k: v for k, v in launches.items() if v} } (e_cap {stats['e_cap']}, edge_chunk "
            f"{kw['edge_chunk']}; task omat -> dataset {pred.dataset_id})")
        if launches != expected:
            raise AssertionError(f"[{tag}] kernel launch counts {launches} differ from the "
                                 f"derivation {expected}")
        ref = UMAPredictor(model, params, task_name="omat", device="cuda", skin=0.5,
                           kernels=False)
        if key == "segment_sum":
            _, ref_step_s, ref_peak = compare_with_plain(torch, ref, atoms, geometries,
                                                         results, tag)
            f32 = (geometries, results, step_s, peak)
            extra = {}
        else:
            if any(not (a == b).all() for a, b in zip(geometries, f32[0])):
                raise AssertionError(f"[{tag}] geometries differ from [uma]'s")
            before = dict(launch_counts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            plain, ref_step_s = [], []
            for pos in geometries:
                atoms.positions = pos.copy()
                t = time.perf_counter()
                plain.append(ref.calculate(atoms))
                torch.cuda.synchronize()
                ref_step_s.append(time.perf_counter() - t)
            ref_peak = torch.cuda.max_memory_allocated()
            if dict(launch_counts) != before:
                raise AssertionError(f"[{tag}] the kernels=False reference launched a kernel")
            n = len(atoms)
            vs_plain, vs32, plain_vs32 = (result_deltas(n, results, plain),
                                          result_deltas(n, results, f32[1]),
                                          result_deltas(n, plain, f32[1]))
            bf16_within_bars(tag, vs_plain, vs32, plain_vs32)
            extra = {"vs_plain": vs_plain, "vs_float32": vs32, "plain_vs_float32": plain_vs32,
                     "float32": {"step_ms": [x * 1e3 for x in f32[2][1:]],
                                 "max_memory_allocated_bytes": f32[3]}}
        summary = summarize(atoms, stats, step_s, peak, ref_step_s, ref_peak, results, launches,
                            expected)
        summary.update(edge_chunks=K, peak_gb=peak / 1e9, rebuilds=pred.potential.rebuild_count,
                       phase_s=time.perf_counter() - t0, **extra)
        log(f"[{tag}] {json.dumps(summary)}")
        launched[tag] = launches
    return launched


CONVERT_REPS = 4  # bench.py's crystal at 256 atoms: full widths, fewer atoms


def phase_convert(torch):
    """``[convert]``: the MACE-MP-0-medium, TensorNet-MatPES and CHGNet-MPtrj
    synthetic upstream dicts (``tests/torch_upstream_dicts.py``, numpy seed
    0) through the port's ``from_torch`` with ``model=`` (constants checked),
    zero unmapped tensors; each converted model evaluated once on the card
    (kernels; CHGNet with magmoms) on the 256-atom crystal, launches counted
    against the per-calculate derivation of its main path, and against a
    ``kernels=False`` potential at the repo's float32 bar. Returns the
    launches of the three calculates together."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts, recompute_chunks
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, MACE, MACEConfig, TensorNet,
                                           TensorNetConfig)
    from distmlip_tpu_torch.models.convert import from_torch
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, TENSORNET_KW, bench_atoms

    upstream = upstream_dicts()

    # MACE-MP-0-medium (tests/test_convert.py:183-194)
    mp0 = dict(num_species=89, channels=128, l_max=3, a_lmax=3, hidden_lmax=1, correlation=3,
               num_interactions=2, num_bessel=8, radial_mlp=64, cutoff=6.0, cutoff_p=5,
               avg_num_neighbors=35.0)
    cases = (
        ("mace", MACE(MACEConfig(**mp0)), lambda m, rng: upstream.mace_state_dict(m, rng), {}),
        ("tensornet", TensorNet(TensorNetConfig(**TENSORNET_KW)),
         lambda m, rng: upstream.tensornet_state_dict(m.cfg, rng), {}),
        ("chgnet", CHGNet(CHGNetConfig(**CHGNET_KW)),
         lambda m, rng: upstream.chgnet_state_dict(m.cfg, rng), {"compute_magmom": True}))
    total = {k: 0 for k in launch_counts}
    for family, model, build_dict, pot_kw in cases:
        t0 = time.perf_counter()
        sd = build_dict(model, np.random.default_rng(0))
        params, report = from_torch(family, sd, model.init(0), model=model)
        if report["unused_torch"] or report["mapped"] != len(sd):
            raise AssertionError(f"[convert] {family}: tensors unmapped: {report}")
        t_conv = time.perf_counter() - t0
        atoms, _ = bench_atoms(CONVERT_REPS)
        pot = DistPotential(model, params, device="cuda", **pot_kw)
        torch.cuda.synchronize()
        for k in launch_counts:
            launch_counts[k] = 0
        recompute_chunks.clear()
        t1 = time.perf_counter()
        res = pot.calculate(atoms)
        torch.cuda.synchronize()
        calc_s = time.perf_counter() - t1
        launches = dict(launch_counts)
        check_result(res, len(atoms))
        stats = pot.last_stats
        expected = {k: 0 for k in launches}
        if family == "mace":
            K = chunk_layout(stats["e_cap"], model.cfg.edge_chunk)[2]
            expected["segment_sum"] = mp0["num_interactions"] * 2 * K
        elif family == "tensornet":
            expected["tensornet_embed_aggregate"] = 1
            expected["tensornet_interaction_aggregate"] = TENSORNET_KW["num_layers"]
            expected["tensornet_interaction_backward"] = TENSORNET_KW["num_layers"]
        else:
            blocks = CHGNET_KW["num_blocks"]
            expected["chgnet_atom_conv_aggregate"] = blocks
            expected["chgnet_line_aggregate"] = blocks - 1
            expected["chgnet_row_projection"] = blocks + 2 * (blocks - 1)
        if launches != expected:
            raise AssertionError(f"[convert] {family}: kernel launch counts {launches} differ "
                                 f"from the derivation {expected}")
        ref = DistPotential(model, params, device="cuda", kernels=False, **pot_kw)
        worst, _, _ = compare_with_plain(torch, ref, atoms, [atoms.positions.copy()], [res],
                                         f"convert-{family}")
        log(f"[convert] {family}: {len(sd)} tensors, 0 unmapped, converted in {t_conv:.2f} s; "
            f"{json.dumps({'n_atoms': len(atoms), 'e_cap': stats['e_cap'], 'energy': res['energy'], 'max_abs_force': float(np.abs(res['forces']).max()), 'calculate_s': calc_s, 'launches': {k: v for k, v in launches.items() if v}, 'vs_plain': worst, 'phase_s': time.perf_counter() - t0})}")
        for k, v in launches.items():
            total[k] += v
    return total


def small_structure(a=4.0, noise=0.05, n_species=3):
    import numpy as np

    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * a, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, noise, (32, 3))
    return Atoms(numbers=rng.integers(0, n_species, 32), positions=cart, cell=lat)


def phase_small_reference(torch, model, tag, atoms=None, **kw):
    """A 32-atom structure: the port on the card (kernels) vs on the CPU
    (plain versions), same params; ``kw`` goes to both potentials."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential

    atoms = small_structure() if atoms is None else atoms
    params = model.init(0)
    gpu = DistPotential(model, params, device="cuda", **kw).calculate(atoms)
    cpu = DistPotential(model, params, device="cpu", **kw).calculate(atoms)
    check_result(gpu, 32)
    d = {"rel_dE": abs(gpu["energy"] - cpu["energy"]) / abs(cpu["energy"]),
         "max_dF": float(np.abs(gpu["forces"] - cpu["forces"]).max()),
         "max_dS": float(np.abs(gpu["stress"] - cpu["stress"]).max())}
    if "magmoms" in cpu:
        d["max_dm"] = float(np.abs(gpu["magmoms"] - cpu["magmoms"]).max())
    log(f"[{tag}] card (kernels) vs CPU (plain), 32 atoms: {json.dumps(d)}")
    if not (d["rel_dE"] < 1e-5 and d["max_dF"] < 1e-4 and d["max_dS"] < 1e-4
            and d.get("max_dm", 0.0) < 1e-4):
        raise AssertionError(f"{tag}: card disagrees with CPU")


# ---------------------------------------------------------------------------
# the end of the main path: MolecularDynamics and Relaxer
# ---------------------------------------------------------------------------

MD_KW = dict(ensemble="nvt_bussi", timestep=2.0, temperature=600.0, seed=0)
MD_STEPS = 60
# random MACE-MP-0-medium weights are not a stable potential: they pull
# the 2048-atom crystal together and heat it, and at the example's 2 fs its
# 60 steps end in non-finite forces. 60 steps of 0.35 fs (21 fs) still fire
# the skin twice, before the forces grow large.
MACE_MD_TIMESTEP = 0.35
MD_TENSORNET_STEPS = 40
RELAX_STEPS = 30
# random CHGNet weights push little (|F| max 0.026 eV/Å, |stress| max 6e-4
# eV/Å^3 on the relax structure), under the Relaxer's default fmax 0.05 and
# smax 0.005: tighter tolerances let the relaxation take all its steps
RELAX_TOL = dict(fmax=1e-4, smax=1e-5)
PAIR_BAND = 1e-4  # Å below r_build: the float32 and float64 searches may differ inside


class Probe:
    """Stands between a driver and its ``DistPotential``: notes what each
    calculate did (a skin-cache hit, a device refresh, an adopted
    background build or a host rebuild) and whether a background build was
    in flight as it started, its seconds, timings and e_cap, and keeps
    every result on the host;
    checks that energy, forces, stress and positions are finite. The
    refreshed graph of the last calculate stays in ``pending`` until the
    caller takes it (after its own timing)."""

    def __init__(self, pot):
        self.pot = pot
        self.calls = []
        self.pending = None

    def calculate(self, atoms):
        import numpy as np

        pot = self.pot
        on_device, builds = pot.rebuild_on_device_count, pot.rebuild_count
        hits, in_flight = pot.prefetch_hits, pot._prefetch is not None
        t = time.perf_counter()
        res = pot.calculate(atoms)
        seconds = time.perf_counter() - t
        kind = ("refresh" if pot.rebuild_on_device_count > on_device
                else "adopted" if pot.prefetch_hits > hits
                else "host" if pot.rebuild_count > builds else "hit")
        check_result(res, len(atoms))
        if not np.isfinite(atoms.positions).all():
            raise AssertionError("non-finite positions")
        self.calls.append({"kind": kind, "s": seconds, "e_cap": pot.last_stats["e_cap"],
                           "build_in_flight": in_flight,
                           "positions": atoms.positions.copy(), "cell": atoms.cell.copy(),
                           "result": res, **pot.last_timings})
        if kind == "refresh":
            self.pending = pot._cache[:2]
        return res

    def take_pending(self):
        """The last refresh's edges on the host (global src, dst, offset),
        then the device graph is let go."""
        graph, host = self.pending
        self.pending = None
        mask = graph.edge_mask[0].cpu().numpy()
        ids = host.global_ids[0]
        self.calls[-1]["edges"] = (ids[graph.edge_src[0].cpu().numpy()[mask]],
                                   ids[graph.edge_dst[0].cpu().numpy()[mask]],
                                   graph.edge_offset[0].cpu().numpy()[mask].round().astype(int))


def pair_set_check(call, pbc, r_build):
    """The refreshed graph's pairs closer than r_build - PAIR_BAND against a
    float64 host search's at the same positions; returns the number of pairs
    within PAIR_BAND of r_build in either list."""
    import numpy as np

    from distmlip_tpu_torch.neighbors import neighbor_list_numpy

    pos, cell = call["positions"], call["cell"]
    nl = neighbor_list_numpy(pos, cell, pbc, r_build)

    def near(src, dst, off):
        d = np.linalg.norm(pos[src] + off @ cell - pos[dst], axis=1)
        keep = d < r_build - PAIR_BAND
        pairs = set(zip(src[keep].tolist(), dst[keep].tolist(), map(tuple, off[keep].tolist())))
        return pairs, int(np.sum(np.abs(d - r_build) < PAIR_BAND))

    got, band_got = near(*call["edges"])
    want, band_want = near(nl.src, nl.dst, nl.offsets.astype(int))
    if got != want:
        raise AssertionError(f"refreshed graph's pairs differ from the host build's: "
                             f"{len(got - want)} extra, {len(want - got)} missing")
    return max(band_got, band_want)


def fresh_host_check(fresh, atoms, calls, tag, bf16=False):
    """Each given frame through ``fresh`` (a skin=0 potential: a host-built
    graph at every call), held to the float32 bar; at ``bf16`` to the bf16
    bar (rel dE < 1e-3, max |dF| and |dS| < 0.1, max |dm| < 0.05 of the
    largest): the two graphs order and pad their edges differently, so
    their fp32 sums round to bf16 at other ulps."""
    import numpy as np

    worst = {"rel_dE": 0.0, "max_dF": 0.0, "max_dS": 0.0}
    scale = {"max_dF": 0.0, "max_dS": 0.0, "max_dm": 0.0}
    for call in calls:
        atoms.positions, atoms.cell = call["positions"].copy(), call["cell"].copy()
        ref, res = fresh.calculate(atoms), call["result"]
        scale["max_dF"] = max(scale["max_dF"], float(np.abs(ref["forces"]).max()))
        scale["max_dS"] = max(scale["max_dS"], float(np.abs(ref["stress"]).max()))
        if "magmoms" in ref:
            scale["max_dm"] = max(scale["max_dm"], float(np.abs(ref["magmoms"]).max()))
        worst["rel_dE"] = max(worst["rel_dE"],
                              abs(res["energy"] - ref["energy"]) / abs(ref["energy"]))
        worst["max_dF"] = max(worst["max_dF"], float(np.abs(res["forces"] - ref["forces"]).max()))
        worst["max_dS"] = max(worst["max_dS"], float(np.abs(res["stress"] - ref["stress"]).max()))
        if "magmoms" in ref:
            worst["max_dm"] = max(worst.get("max_dm", 0.0),
                                  float(np.abs(res["magmoms"] - ref["magmoms"]).max()))
    log(f"[{tag}] against a fresh host-built graph (skin=0) at {len(calls)} frames: "
        f"{json.dumps(worst)}")
    if bf16:
        ok = (worst["rel_dE"] < 1e-3 and worst["max_dF"] < 0.1 * scale["max_dF"]
              and worst["max_dS"] < 0.1 * scale["max_dS"]
              and worst.get("max_dm", 0.0) <= 0.05 * scale["max_dm"])
        worst["scales"] = scale
    else:
        ok = (worst["rel_dE"] < 1e-5 and worst["max_dF"] < 1e-4 and worst["max_dS"] < 1e-4
              and worst.get("max_dm", 0.0) < 1e-4)
    if not ok:
        raise AssertionError(f"{tag}: disagrees with a fresh host-built graph")
    return worst


def median(xs):
    return statistics.median(xs) if xs else None


def run_md(torch, pot, atoms, steps, tag, **kw):
    """Maxwell-Boltzmann velocities at 600 K from the structure's seeded
    generator, then ``examples/01_static_and_md.py``'s loop: MD_KW (``kw``
    overriding) for ``steps`` steps. Every launch count is set to 0 just before the driver
    is made (its constructor makes the first calculate) and read just after
    the last step. Returns the probe, per-step seconds, launches and peak
    memory."""
    import numpy as np

    from distmlip_tpu_torch.calculators import MolecularDynamics
    from distmlip_tpu_torch.kernels import launch_counts

    atoms, rng = atoms
    atoms.set_maxwell_boltzmann_velocities(MD_KW["temperature"], rng=rng)
    probe = Probe(pot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    md = MolecularDynamics(atoms, probe, **{**MD_KW, **kw})
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        md.step()
        step_s.append(time.perf_counter() - t)
        if probe.pending is not None:
            probe.take_pending()
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(atoms.velocities).all():
        raise AssertionError(f"{tag}: non-finite velocities")
    if (pot.device_rebuild and pot.rebuild_count - 1 - pot.rebuild_on_device_count
            != pot.rebuild_overflow_count):
        raise AssertionError(f"{tag}: a host rebuild after the first that is not an overflow "
                             f"({pot.rebuild_count} builds, {pot.rebuild_on_device_count} on "
                             f"the device, {pot.rebuild_overflow_count} overflows)")
    return probe, step_s, launches, peak


def md_summary(pot, probe, step_s, peak, launches, expected):
    """Step times by what the skin cache did (the constructor's calculate
    apart), refresh and host-build times, counters, displacements, memory."""
    import numpy as np

    kinds = [c["kind"] for c in probe.calls[1:]]
    by = {k: [s * 1e3 for s, kk in zip(step_s, kinds) if kk == k]
          for k in ("hit", "refresh", "adopted", "host")}
    # hits while a background build ran (its OpenMP threads beside the
    # step's launches) against hits without one
    flight = [c["build_in_flight"] for c in probe.calls[1:]]
    hit_ms = {w: [s * 1e3 for s, k, f in zip(step_s, kinds, flight) if k == "hit" and f == w]
              for w in (True, False)}
    pos = [c["positions"] for c in probe.calls]
    disp = [float(np.sqrt(((b - a) ** 2).sum(axis=1)).max()) for a, b in zip(pos, pos[1:])]
    return {
        "n_atoms": len(pos[0]), "steps": len(step_s), "e_cap": pot.last_stats["e_cap"],
        "n_edges": pot.last_stats["n_edges"],
        "first_calculate_ms": probe.calls[0]["s"] * 1e3,
        "first_host_build_s": probe.calls[0]["neighbor_s"],
        "step_ms_median": {k: median(v) for k, v in by.items()},
        "steps_by_kind": {k: len(v) for k, v in by.items()},
        "atoms_per_s": len(pos[0]) * len(step_s) / sum(step_s),
        "refresh_ms": [c["rebuild_s"] * 1e3 for c in probe.calls if c["kind"] == "refresh"],
        "host_rebuild_s": [c["neighbor_s"] for c in probe.calls[1:] if c["kind"] == "host"],
        "prefetch_hits": pot.prefetch_hits,
        "prefetch_skipped_hbm": pot.prefetch_skipped_hbm,
        "prefetch_wait_s": [c["prefetch_wait_s"] for c in probe.calls[1:]
                            if c["kind"] == "adopted"],
        "hit_ms_median_build_in_flight": median(hit_ms[True]),
        "hit_ms_median_no_build": median(hit_ms[False]),
        "hits_build_in_flight": len(hit_ms[True]),
        "rebuild_count": pot.rebuild_count,
        "rebuild_on_device_count": pot.rebuild_on_device_count,
        "rebuild_overflow_count": pot.rebuild_overflow_count,
        "max_displacement_per_step": {"max": max(disp), "median": median(disp)},
        "max_memory_allocated_bytes": peak,
        "launches": launches, "launches_expected": expected,
    }


def check_md(tag, probe, atoms, fresh, r_build):
    """At least 2 device refreshes; at each refresh frame and the last
    frame the result against a fresh host-built graph; at each refresh frame
    the pair set against a float64 host search."""
    refreshes = [c for c in probe.calls if c["kind"] == "refresh"]
    if len(refreshes) < 2:
        raise AssertionError(f"{tag}: {len(refreshes)} device refreshes, fewer than 2")
    band = [pair_set_check(c, atoms.pbc, r_build) for c in refreshes]
    log(f"[{tag}] pair sets of {len(refreshes)} refreshed graphs equal the host search's "
        f"below r_build - {PAIR_BAND} Å; pairs within {PAIR_BAND} Å of r_build = {r_build}: "
        f"{band}")
    frames = refreshes + ([probe.calls[-1]] if probe.calls[-1] is not refreshes[-1] else [])
    return fresh_host_check(fresh, atoms, frames, tag), band


def phase_md(torch):
    """``[md]``: MACE at MACE_KW on the 2048-atom crystal, 60 nvt_bussi
    steps of MACE_MD_TIMESTEP."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    model = MACE(MACEConfig(**MACE_KW))
    params = model.init(0)
    pot = DistPotential(model, params, device="cuda", skin=0.5)
    structure = bench_atoms()
    atoms = structure[0]
    probe, step_s, launches, peak = run_md(torch, pot, structure, MD_STEPS, "md",
                                           timestep=MACE_MD_TIMESTEP)
    per_calc = [MACE_KW["num_interactions"] * 2 * chunk_layout(c["e_cap"], MACE_KW["edge_chunk"])[2]
                for c in probe.calls]
    expected = {k: 0 for k in launches}
    expected["segment_sum"] = sum(per_calc)
    log(f"[md] segment_sum launches: {len(probe.calls)} calculates ({MD_STEPS} steps + the "
        f"constructor's) x {MACE_KW['num_interactions']} interactions x 2K (K edge chunks "
        f"of each calculate's e_cap) = {expected['segment_sum']}; counted {launches}")
    if launches != expected:
        raise AssertionError(f"[md] kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    summary = md_summary(pot, probe, step_s, peak, launches, expected)
    fresh = DistPotential(model, params, device="cuda", skin=0.0)
    summary["vs_fresh_host_graph"], summary["pairs_in_band"] = check_md(
        "md", probe, atoms, fresh, MACE_KW["cutoff"] + 0.5)
    log(f"[md] {json.dumps(summary)}")
    return launches


MD_BF16_STEPS = 20


def phase_md_bf16(torch):
    """``[md-bf16]``: MACE at MACE_BF16_KW on the 2048-atom crystal,
    MD_BF16_STEPS nvt_bussi steps of MACE_MD_TIMESTEP: the bf16 segment sum
    on every calculate, the trajectory finite."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_BF16_KW, bench_atoms

    model = MACE(MACEConfig(**MACE_BF16_KW))
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5)
    probe, step_s, launches, peak = run_md(torch, pot, bench_atoms(), MD_BF16_STEPS, "md-bf16",
                                           timestep=MACE_MD_TIMESTEP)
    expected = {k: 0 for k in launches}
    expected["segment_sum_bf16"] = sum(
        MACE_BF16_KW["num_interactions"] * 2 * chunk_layout(c["e_cap"], MACE_BF16_KW["edge_chunk"])[2]
        for c in probe.calls)
    if launches != expected:
        raise AssertionError(f"[md-bf16] kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    log(f"[md-bf16] {json.dumps(md_summary(pot, probe, step_s, peak, launches, expected))}")
    return launches


def phase_md_tensornet_bf16(torch):
    """``[md-tensornet-bf16]``: TensorNet at TENSORNET_BF16_KW on the
    16384-atom crystal, MD_BF16_STEPS nvt_bussi steps with the device
    refresh (``device_rebuild="auto"``): the three bf16 kernels on every
    calculate, at least one refresh, each refreshed graph's pairs against a
    float64 host search, step ms by outcome."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_BF16_KW, bench_atoms

    model = TensorNet(TensorNetConfig(**TENSORNET_BF16_KW))
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5, device_rebuild="auto")
    structure = bench_atoms(TENSORNET_REPS)
    probe, step_s, launches, peak = run_md(torch, pot, structure, MD_BF16_STEPS,
                                           "md-tensornet-bf16")
    n_calc, layers = len(probe.calls), TENSORNET_BF16_KW["num_layers"]
    expected = {k: 0 for k in launches}
    expected["tensornet_embed_aggregate_bf16"] = n_calc
    expected["tensornet_interaction_aggregate_bf16"] = n_calc * layers
    expected["tensornet_interaction_backward_bf16"] = n_calc * layers
    if launches != expected:
        raise AssertionError(f"[md-tensornet-bf16] kernel launch counts {launches} differ "
                             f"from the derivation {expected}")
    refreshes = [c for c in probe.calls if c["kind"] == "refresh"]
    if not refreshes:
        raise AssertionError("[md-tensornet-bf16] no device refresh")
    summary = md_summary(pot, probe, step_s, peak, launches, expected)
    summary["pairs_in_band"] = [pair_set_check(c, structure[0].pbc,
                                               TENSORNET_BF16_KW["cutoff"] + 0.5)
                                for c in refreshes]
    log(f"[md-tensornet-bf16] {json.dumps(summary)}")
    return launches


def phase_md_tensornet(torch):
    """``[md-tensornet]``: TensorNet at TENSORNET_KW on the 16384-atom
    crystal, 40 nvt_bussi steps with the device refresh, then the same 40
    from the same seed with ``device_rebuild=False``."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    params = model.init(0)
    layers = TENSORNET_KW["num_layers"]
    out = {}
    for device_rebuild in (True, False):
        tag = "md-tensornet" if device_rebuild else "md-tensornet host-rebuild"
        pot = DistPotential(model, params, device="cuda", skin=0.5,
                            device_rebuild=device_rebuild)
        structure = bench_atoms(TENSORNET_REPS)
        probe, step_s, launches, peak = run_md(torch, pot, structure, MD_TENSORNET_STEPS, tag)
        n_calc = len(probe.calls)
        expected = {k: 0 for k in launches}
        expected["tensornet_embed_aggregate"] = n_calc
        expected["tensornet_interaction_aggregate"] = n_calc * layers
        expected["tensornet_interaction_backward"] = n_calc * layers
        log(f"[{tag}] edge-aggregate launches: {n_calc} calculates x (1 embed + {layers} "
            f"interactions + {layers} interaction backwards); counted {launches}")
        if launches != expected:
            raise AssertionError(f"[{tag}] kernel launch counts {launches} differ from the "
                                 f"derivation {expected}")
        summary = md_summary(pot, probe, step_s, peak, launches, expected)
        if device_rebuild:
            fresh = DistPotential(model, params, device="cuda", skin=0.0)
            summary["vs_fresh_host_graph"], summary["pairs_in_band"] = check_md(
                tag, probe, structure[0], fresh, TENSORNET_KW["cutoff"] + 0.5)
            del fresh
        elif pot.rebuild_on_device_count:
            raise AssertionError(f"[{tag}] refreshed on the device with device_rebuild=False")
        log(f"[{tag}] {json.dumps(summary)}")
        out[device_rebuild] = launches
        del pot, probe
        torch.cuda.empty_cache()
    return out[True]


def phase_relax_chgnet(torch, bf16=False):
    """``[relax-chgnet]``: CHGNet at CHGNET_KW with magmoms on
    ``examples/02_relax_chgnet.py``'s structure (864 Li, cell x 1.02, 0.08 Å
    noise, seed 1): FIRE with the cell relaxed, 30 steps. Every step
    changes the cell, so every calculate is a host rebuild. ``bf16``:
    ``[relax-chgnet-bf16]``, the same at CHGNET_BF16_KW, launches on the
    bf16 kernels, the last frame against a fresh graph at the bf16 bar."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential, Relaxer
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.tools.kernel_ab import relax_structure
    from distmlip_tpu_torch.tools.workload import CHGNET_BF16_KW, CHGNET_KW

    tag, suffix = ("relax-chgnet-bf16", "_bf16") if bf16 else ("relax-chgnet", "")
    atoms = relax_structure()
    model = CHGNet(CHGNetConfig(**(CHGNET_BF16_KW if bf16 else CHGNET_KW)))
    params = model.init(0)
    pot = DistPotential(model, params, device="cuda", skin=0.4, compute_magmom=True)
    probe = Probe(pot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    t = time.perf_counter()
    out = Relaxer(probe, optimizer="fire", relax_cell=True, **RELAX_TOL).relax(
        atoms, steps=RELAX_STEPS)
    wall = time.perf_counter() - t
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_calc, blocks = len(probe.calls), CHGNET_KW["num_blocks"]
    if n_calc != out.nsteps + (0 if out.converged else 1):
        raise AssertionError(f"[{tag}] {n_calc} calculates for {out.nsteps} steps")
    expected = {k: 0 for k in launches}
    expected["chgnet_atom_conv_aggregate" + suffix] = n_calc * blocks
    expected["chgnet_line_aggregate" + suffix] = n_calc * (blocks - 1)
    expected["chgnet_row_projection" + suffix] = n_calc * (blocks + 2 * (blocks - 1))
    log(f"[{tag}] launches: {n_calc} calculates x ({blocks} atom convs + {blocks - 1} "
        f"line convs + {blocks + 2 * (blocks - 1)} row projections); counted {launches}")
    if launches != expected:
        raise AssertionError(f"[{tag}] kernel launch counts {launches} differ from "
                             f"the derivation {expected}")
    if pot.rebuild_on_device_count or pot.rebuild_count != n_calc:
        raise AssertionError(f"[{tag}] {pot.rebuild_count} builds for {n_calc} "
                             f"calculates, {pot.rebuild_on_device_count} on the device: every "
                             f"calculate of a cell relaxation is a host rebuild")
    fresh = DistPotential(model, params, device="cuda", skin=0.0, compute_magmom=True)
    worst = fresh_host_check(fresh, atoms.copy(), [probe.calls[-1]], tag, bf16)
    ms = [c["s"] * 1e3 for c in probe.calls[1:]]
    summary = {
        "n_atoms": len(atoms), "converged": out.converged, "nsteps": out.nsteps,
        "energy": out.energy, "fmax": float(np.abs(out.forces).max()),
        "volume_ratio": abs(np.linalg.det(out.atoms.cell)) / abs(np.linalg.det(atoms.cell)),
        "wall_s": wall, "calculate_ms_median": median(ms), "calculate_ms_max": max(ms),
        "host_build_s_median": median([c["neighbor_s"] for c in probe.calls]),
        "atoms_per_s": len(atoms) * len(ms) / (sum(ms) / 1e3),
        "rebuild_count": pot.rebuild_count,
        "rebuild_on_device_count": pot.rebuild_on_device_count,
        "rebuild_overflow_count": pot.rebuild_overflow_count,
        "max_displacement_per_step": max(
            float(np.sqrt(((b["positions"] - a["positions"]) ** 2).sum(axis=1)).max())
            for a, b in zip(probe.calls, probe.calls[1:])),
        "max_memory_allocated_bytes": peak, "vs_fresh_host_graph": worst,
        "launches": launches, "launches_expected": expected,
    }
    log(f"[{tag}] {json.dumps(summary)}")
    return launches


# ---------------------------------------------------------------------------
# the host graph build: the native search and partitioner against numpy
# ---------------------------------------------------------------------------

HOST_GRAPH_WARM = 5  # warm calls timed (median) after the first of each


def host_cpu() -> str:
    """The host's CPU as ``/proc/cpuinfo`` names it (vendor, family, model,
    model name, MHz, AVX-512), and the cores this process may use."""
    import os

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("vendor_id", "cpu family", "model", "model name", "cpu MHz"):
                    fields.setdefault(key, value.strip())
                elif key == "flags":
                    fields.setdefault("avx512f", "avx512f" in value.split())
    except OSError:
        pass
    return f"{json.dumps(fields)}, {len(os.sched_getaffinity(0))} cores usable"


def timed_calls(fn, warm=HOST_GRAPH_WARM):
    """(first call's s, median of ``warm`` more calls' s, last result)."""
    t = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t
    ts = []
    for _ in range(warm):
        t = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t)
    return first, statistics.median(ts), out


def same_edge_sets(got, want):
    """The two searches' edges as sorted sets: (src, dst, offset) and bond
    flags equal, distances within 1e-10 Å; shifts equal, wrapped positions
    within 1e-12 Å. Returns the largest distance difference."""
    import numpy as np

    a, b = got.sorted_copy(), want.sorted_copy()
    if a.num_edges != b.num_edges:
        raise AssertionError(f"native found {a.num_edges} edges, numpy {b.num_edges}")
    for name in ("src", "dst", "offsets", "bond_mask", "shift"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"native and numpy searches differ in {name}")
    dd = float(np.abs(a.distances - b.distances).max()) if a.num_edges else 0.0
    dw = float(np.abs(a.wrapped_cart - b.wrapped_cart).max())
    if dd > 1e-10 or dw > 1e-12:
        raise AssertionError(f"native and numpy distances differ by {dd}, wrapped "
                             f"positions by {dw}")
    return dd


def same_plans(a, b):
    """Every ``PartitionPlan`` field equal, array for array."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            ok = len(x) == len(y) and all(u.dtype == v.dtype and np.array_equal(u, v)
                                          for u, v in zip(x, y))
        elif isinstance(x, np.ndarray):
            ok = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            ok = x == y
        if not ok:
            raise AssertionError(f"native and numpy plans differ in {f.name}")


def phase_host_graph(torch):
    """``[host-graph]``: on the card's host, the native FPIS search
    (``neighbors/native.py``, built here by g++: its first call apart)
    against ``neighbor_list_numpy`` on bench.py's 16,384-atom Si crystal at
    TensorNet's build cutoff (5.5 Å) and at CHGNet's (6.5 Å, bonds 3.5 Å),
    and on ``[relax-chgnet]``'s 864 Li at its build cutoffs (6.4 / 3.4 Å):
    the sorted edge sets equal, distances within 1e-10 Å. Then
    ``build_plan(impl="native")`` against ``impl="numpy"`` at P = 2 and 4,
    with and without bonds, on the 16,384 atoms: every plan field equal.
    Times: the first call and the median of HOST_GRAPH_WARM warm calls of
    each, on the threads the knob resolves to (all cores by default)."""
    from distmlip_tpu_torch.neighbors import native, neighbor_list, neighbor_list_numpy
    from distmlip_tpu_torch.partition import build_plan
    from distmlip_tpu_torch.tools.kernel_ab import relax_structure
    from distmlip_tpu_torch.tools.workload import bench_atoms

    t_phase = time.perf_counter()
    log(f"[host-graph] host CPU: {host_cpu()}; native threads "
        f"{native.resolve_num_threads() or 'all (OpenMP default)'}")
    build_s = native.build()
    log(f"[host-graph] g++ build of {native.library_path()}: {build_s:.2f} s")
    si, li = bench_atoms(TENSORNET_REPS)[0], relax_structure()
    nls = {}
    for tag, atoms, r, bond_r in (("si16384", si, 5.5, 0.0), ("si16384", si, 6.5, 3.5),
                                  ("li864", li, 6.4, 3.4)):
        args = (atoms.positions, atoms.cell, atoms.pbc, r)
        nat = timed_calls(lambda: neighbor_list(*args, bond_r=bond_r))
        ref = timed_calls(lambda: neighbor_list_numpy(*args, bond_r=bond_r))
        dd = same_edge_sets(nat[2], ref[2])
        row = {"structure": tag, "n_atoms": len(atoms), "r": r, "bond_r": bond_r,
               "n_edges": nat[2].num_edges, "n_bonds": int(nat[2].bond_mask.sum()),
               "native_first_ms": nat[0] * 1e3, "native_ms": nat[1] * 1e3,
               "numpy_first_ms": ref[0] * 1e3, "numpy_ms": ref[1] * 1e3,
               "speedup": ref[1] / nat[1], "max_distance_diff": dd}
        log(f"[host-graph] search {json.dumps(row)}")
        if tag == "si16384":
            nls[bond_r > 0] = nat[2]
    for bonds in (False, True):
        nl = nls[bonds]
        r, bond_r = (6.5, 3.5) if bonds else (5.5, 0.0)
        for P in (2, 4):
            plan = lambda impl: build_plan(nl, si.cell, si.pbc, P, r, bond_r, bonds, impl=impl)
            nat, ref = timed_calls(lambda: plan("native")), timed_calls(lambda: plan("numpy"))
            same_plans(nat[2], ref[2])
            row = {"P": P, "bonds": bonds, "n_edges": nl.num_edges,
                   "halo_rows": [int(m[-1] - m[1 + P]) for m in nat[2].node_markers],
                   "native_first_ms": nat[0] * 1e3, "native_ms": nat[1] * 1e3,
                   "numpy_first_ms": ref[0] * 1e3, "numpy_ms": ref[1] * 1e3,
                   "speedup": ref[1] / nat[1]}
            log(f"[host-graph] plan {json.dumps(row)}")
    log(f"[host-graph] native searches and plans equal numpy's; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# slab graph parallelism: P partitions as one flattened graph on one card
# ---------------------------------------------------------------------------

PARALLEL_CALCS = 6  # per potential: the first calculate (host build) + 5 warm ones
PARALLEL_MD_STEPS = 20


def parallel_geometries(atoms, rng):
    """The structure, then PARALLEL_CALCS - 1 MD-like moves of 0.01 Å (inside
    the 0.5 Å skin: every calculate after the first is a cache hit)."""
    pos = [atoms.positions.copy()]
    for _ in range(PARALLEL_CALCS - 1):
        pos.append(pos[-1] + rng.normal(0, 0.01, pos[-1].shape))
    return pos


def run_calcs(torch, pot, atoms, geometries):
    """``pot`` over the geometries: results, seconds per calculate, peak
    memory from just before."""
    results, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for pos in geometries:
        atoms.positions = pos.copy()
        t = time.perf_counter()
        res = pot.calculate(atoms)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        check_result(res, len(atoms))
        results.append(res)
    if pot.rebuild_count != 1:
        raise AssertionError(f"graph rebuilt after the first calculate ({pot.rebuild_count} "
                             f"builds)")
    return results, step_s, torch.cuda.max_memory_allocated()


def worst_deltas(results, refs, border=None):
    """The largest differences over paired results (geometries, or the
    structures of a batch): rel dE, max |dF| (and on the ``border`` atoms
    alone, when given), max |dS|, max |dm| with magmoms."""
    import numpy as np

    d = {"rel_dE": 0.0, "max_dF": 0.0, "max_dS": 0.0}
    if border is not None:
        d["max_dF_border"] = 0.0
    if "magmoms" in refs[0]:
        d["max_dm"] = 0.0
    for res, ref in zip(results, refs):
        df = np.abs(res["forces"] - ref["forces"])
        d["rel_dE"] = max(d["rel_dE"], abs(res["energy"] - ref["energy"]) / abs(ref["energy"]))
        d["max_dF"] = max(d["max_dF"], float(df.max()))
        if border is not None:
            d["max_dF_border"] = max(d["max_dF_border"], float(df[border].max()))
        d["max_dS"] = max(d["max_dS"], float(np.abs(res["stress"] - ref["stress"]).max()))
        if "max_dm" in d:
            d["max_dm"] = max(d["max_dm"],
                              float(np.abs(res["magmoms"] - ref["magmoms"]).max()))
    return d


def within_bar(d):
    return (d["rel_dE"] < 1e-5 and d["max_dF"] < 1e-4 and d["max_dS"] < 1e-4
            and d.get("max_dm", 0.0) < 1e-4)


def phase_parallel(torch, tag, model, params, atoms, rng, parts, per_calc, pot_kw,
                   segment_check=None):
    """``[parallel-*]``: the structure through ``DistPotential(num_partitions=P)``
    for each P in ``parts``, the P partitions as one flattened graph on the
    card, against P = 1 (kernels on) and against P with ``kernels=False``, on
    the same PARALLEL_CALCS geometries. Every launch count is set to 0 just
    before P's potential is made and read after its last calculate, and must
    equal ``per_calc(P, stats)`` per calculate. Prints the plan (slab axis
    and width, owned and halo rows per partition, e_split / e_cap, shifts,
    halo copies), step ms (median of the warm calculates) at P and P = 1,
    peak memory and the deltas. ``segment_check(lg)`` then holds the kernels
    against their plain versions on the flattened graph's segments (not
    counted). Returns the launches summed over ``parts`` and the segment
    checks' worst errors by kernel."""
    import numpy as np

    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.parallel import local_graph_from_stacked

    geometries = parallel_geometries(atoms, rng)
    pot = DistPotential(model, params, device="cuda", skin=0.5, **pot_kw)
    ref1, s1, peak1 = run_calcs(torch, pot, atoms, geometries)
    del pot
    torch.cuda.empty_cache()
    total, seg_errs = {}, {}
    for P in parts:
        for k in launch_counts:
            launch_counts[k] = 0
        pot = DistPotential(model, params, device="cuda", skin=0.5, num_partitions=P,
                            **pot_kw)
        res, sP, peakP = run_calcs(torch, pot, atoms, geometries)
        launches = dict(launch_counts)
        stats = dict(pot.last_stats)
        graph, host = pot._cache[:2]
        per = per_calc(P, stats)
        expected = {k: len(geometries) * per.get(k, 0) for k in launches}
        log(f"[{tag}] P={P}: launches per calculate {json.dumps(per)} x {len(geometries)} "
            f"calculates; counted {launches}")
        if launches != expected:
            raise AssertionError(f"[{tag}] P={P}: kernel launch counts {launches} differ "
                                 f"from the derivation {expected}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        border = np.nonzero(host.plan.nodes_to_partition >= 0)[0]
        plan = {k: stats[k] for k in ("axis", "owned_per_part", "halo_per_part",
                                      "edges_per_part", "frontier_per_part", "e_split",
                                      "e_cap", "n_cap", "shifts", "halo_copies",
                                      "bond_halo_copies")}
        plan["slab_width_A"] = float(geometry.plane_spacings(atoms.cell)[stats["axis"]] / P)
        plan["border_atoms"] = int(len(border))
        log(f"[{tag}] P={P} plan: {json.dumps(plan)}")
        if segment_check is not None:
            for name, err in segment_check(local_graph_from_stacked(graph)).items():
                seg_errs[name] = max(seg_errs.get(name, 0.0), err)
        del pot, graph, host
        torch.cuda.empty_cache()
        before = dict(launch_counts)
        plain = DistPotential(model, params, device="cuda", skin=0.5, num_partitions=P,
                              kernels=False, **pot_kw)
        refp, sp, peakp = run_calcs(torch, plain, atoms, geometries)
        if dict(launch_counts) != before:
            raise AssertionError(f"[{tag}] the kernels=False reference launched a kernel")
        del plain
        torch.cuda.empty_cache()
        vs_p1, vs_plain = worst_deltas(res, ref1, border), worst_deltas(res, refp, border)
        summary = {
            "n_atoms": len(atoms), "num_partitions": P,
            "step_ms_median": statistics.median(sP[1:]) * 1e3,
            "step_ms": [x * 1e3 for x in sP[1:]], "first_calculate_ms": sP[0] * 1e3,
            "p1_step_ms_median": statistics.median(s1[1:]) * 1e3,
            "plain_step_ms_median": statistics.median(sp[1:]) * 1e3,
            "max_memory_allocated_bytes": peakP, "p1_max_memory_allocated_bytes": peak1,
            "plain_max_memory_allocated_bytes": peakp,
            "vs_p1": vs_p1, "vs_plain": vs_plain, "energy": res[-1]["energy"],
            "launches": launches, "launches_expected": expected,
        }
        log(f"[{tag}] P={P}: {json.dumps(summary)}")
        if not (within_bar(vs_p1) and within_bar(vs_plain)):
            raise AssertionError(f"[{tag}] P={P} disagrees with P=1 or with its plain "
                                 f"reference")
    if segment_check is not None:
        log(f"[{tag}] kernels on the flattened graphs' segments agree with their plain "
            f"versions: max |err| {json.dumps(seg_errs)}")
    return total, seg_errs


def _segments(lg):
    """(name, edge-row slice) of the graph's sorted segments: interior and
    frontier of a flattened graph, or the one segment of an unsplit
    (packed) graph."""
    if not lg.has_frontier_split:
        return (("all", slice(None)),)
    s = lg.e_split
    return (("interior", slice(0, s)), ("frontier", slice(s, None)))


def _chunk_checks(torch, lg, chunk, width, seed):
    """B1 on the first edge chunk of each segment of the model's chunk
    layout (``chunk_layout`` with e_split), random rows of the model's width."""
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    split = lg.e_split if lg.has_frontier_split else None
    rows, valid, K, c = chunk_layout(lg.e_cap, chunk, split)
    rows = torch.as_tensor(rows, dtype=torch.long, device="cuda")
    valid = torch.as_tensor(valid, device="cuda")
    errs = []
    firsts = {0} if split is None else {0, int((rows < split).sum()) // c}
    for k in sorted(firsts):  # the first chunk of each segment
        sl = slice(k * c, (k + 1) * c)
        ids, mask = lg.edge_dst[rows[sl]], lg.edge_mask[rows[sl]] & valid[sl]
        data = torch.randn((c,) + width, generator=gen, device="cuda")
        errs.append(check_segment_sum(torch, data, ids, mask, lg.n_cap))
    return {"segment_sum": max(errs)}


def phase_parallel_tensornet(torch):
    """``[parallel-tensornet]``: TensorNet at TENSORNET_KW on the 16384-atom
    crystal at P = 2 and 4. Per calculate: the embed once per segment, each
    layer's interaction and its backward kernel once per segment."""
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    layers, c = TENSORNET_KW["num_layers"], TENSORNET_KW["units"]

    def per_calc(P, stats):
        return {"tensornet_embed_aggregate": 2, "tensornet_interaction_aggregate": 2 * layers,
                "tensornet_interaction_backward": 2 * layers}

    atoms, rng = bench_atoms(TENSORNET_REPS)
    return phase_parallel(torch, "parallel-tensornet", model, model.init(0), atoms, rng,
                          (2, 4), per_calc, {},
                          lambda lg: tensornet_segment_checks(torch, lg, c))


def tensornet_segment_checks(torch, lg, c, dtype=None):
    """The three TensorNet kernels against their plain versions on each
    sorted segment of ``lg`` at its real ids and masks, random rows of
    width ``c`` (in ``dtype``, float32 by default); returns the worst error
    by kernel (bf16 names carry ``_bf16``)."""
    gen = torch.Generator(device="cuda").manual_seed(97)
    dtype = dtype or torch.float32
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    errs = {}
    for _, sl in _segments(lg):
        ids, src, mask = lg.edge_dst[sl], lg.edge_src[sl], lg.edge_mask[sl]
        for which in ("embed", "interaction"):
            arrays = [x.to(dtype) if x.is_floating_point() else x
                      for x in edge_inputs(torch, gen, which, ids.shape[0], c, lg.n_cap, src)]
            name = f"tensornet_{which}_aggregate{suffix}"
            errs[name] = max(errs.get(name, 0.0),
                             check_edge_aggregate(torch, which, arrays, ids, mask, lg.n_cap))
        g = torch.randn((lg.n_cap, 3, 3, c), generator=gen, device="cuda").to(dtype)
        name = f"tensornet_interaction_backward{suffix}"
        errs[name] = max(errs.get(name, 0.0),
                         check_interaction_backward(torch, g, arrays, ids, mask))
        del arrays, g
    return errs


BF16_PARALLEL_CALCS = 3


def phase_parallel_bf16(torch, family):
    """``[parallel-tensornet-bf16]`` (TensorNet at TENSORNET_BF16_KW) or
    ``[parallel-chgnet-bf16]`` (CHGNet at CHGNET_BF16_KW with magmoms and
    ``[main-chgnet]``'s readout terms) on the 16384-atom crystal at P = 2
    (the two partitions as one flattened graph on the card) against P = 1
    and against P = 2 with ``kernels=False``, on the first
    BF16_PARALLEL_CALCS geometries of ``parallel_geometries``, at the bf16
    bar (rel dE < 1e-3, max |dF| < 0.1 max |F|, max |dS| < 0.1 max |S|,
    max |dm| < 0.05 max |m|: the bf16 routes round at other ulps,
    partitions split the sums). Launches per calculate at P = 2: TensorNet's
    embed, each layer's interaction and its backward once per segment;
    CHGNet's atom conv once per segment, the line conv once (one segment),
    the row projections as ``[parallel-chgnet]``'s. Then the bf16 kernels
    on the flattened graph's segments."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, TensorNet, TensorNetConfig
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.tools.workload import (CHGNET_BF16_KW, TENSORNET_BF16_KW,
                                                   bench_atoms)

    tag = f"parallel-{family}-bf16"
    pot_kw = {}
    if family == "tensornet":
        kw = TENSORNET_BF16_KW
        model = TensorNet(TensorNetConfig(**kw))
        params = model.init(0)
        layers = kw["num_layers"]
        per_calc = dict(tensornet_embed_aggregate_bf16=2,
                        tensornet_interaction_aggregate_bf16=2 * layers,
                        tensornet_interaction_backward_bf16=2 * layers)
        checks = tensornet_segment_checks
        reps = TENSORNET_REPS
    else:
        kw = CHGNET_BF16_KW
        model = CHGNet(CHGNetConfig(**kw))
        params = model.init(0)
        params["species_ref"]["w"] = torch.randn((kw["num_species"], 1),
                                                 generator=torch.Generator().manual_seed(0))
        params["data_std"] = torch.tensor(1.3)
        blocks = kw["num_blocks"]
        per_calc = dict(chgnet_atom_conv_aggregate_bf16=2 * blocks,
                        chgnet_line_aggregate_bf16=blocks - 1,
                        chgnet_row_projection_bf16=3 * blocks + 2 * (blocks - 1))
        checks = chgnet_segment_checks
        pot_kw = {"compute_magmom": True}
        reps = CHGNET_REPS
    c = kw["units"]
    atoms, rng = bench_atoms(reps)
    geometries = parallel_geometries(atoms, rng)[:BF16_PARALLEL_CALCS]
    ref1, s1, _ = run_calcs(torch, DistPotential(model, params, device="cuda", skin=0.5,
                                                 **pot_kw), atoms, geometries)
    torch.cuda.empty_cache()
    for k in launch_counts:
        launch_counts[k] = 0
    pot = DistPotential(model, params, device="cuda", skin=0.5, num_partitions=2, **pot_kw)
    res, s2, peak2 = run_calcs(torch, pot, atoms, geometries)
    launches = dict(launch_counts)
    n = len(geometries)
    expected = {k: n * per_calc.get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"[{tag}] kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    seg_errs = checks(torch, local_graph_from_stacked(pot._cache[0]), c, torch.bfloat16)
    stats = dict(pot.last_stats)
    del pot
    torch.cuda.empty_cache()
    before = dict(launch_counts)
    refp, sp, _ = run_calcs(torch, DistPotential(model, params, device="cuda", skin=0.5,
                                                 num_partitions=2, kernels=False, **pot_kw),
                            atoms, geometries)
    if dict(launch_counts) != before:
        raise AssertionError(f"[{tag}] the kernels=False reference launched")
    f_scale = max(float(abs(r["forces"]).max()) for r in ref1)
    s_scale = max(float(abs(r["stress"]).max()) for r in ref1)
    m_scale = max(float(abs(r["magmoms"]).max()) for r in ref1) if pot_kw else 0.0
    vs = {"p1": worst_deltas(res, ref1), "plain": worst_deltas(res, refp)}
    summary = {"n_atoms": len(atoms), "num_partitions": 2, "e_split": stats["e_split"],
               "e_cap": stats["e_cap"], "step_ms": [x * 1e3 for x in s2[1:]],
               "p1_step_ms": [x * 1e3 for x in s1[1:]],
               "plain_step_ms": [x * 1e3 for x in sp[1:]], "max_memory_allocated_bytes": peak2,
               "max_F": f_scale, "max_S": s_scale, "vs_p1": vs["p1"], "vs_plain": vs["plain"],
               "launches": launches, "segments_max_abs_err": seg_errs}
    if pot_kw:
        summary["max_m"] = m_scale
    log(f"[{tag}] {json.dumps(summary)}")
    for what, d in vs.items():
        if not (d["rel_dE"] < 1e-3 and d["max_dF"] < 0.1 * f_scale
                and d["max_dS"] < 0.1 * s_scale and d.get("max_dm", 0.0) <= 0.05 * m_scale):
            raise AssertionError(f"[{tag}] P = 2 departs from {what} past the bf16 bar: {d}")
    return launches, seg_errs


def phase_parallel_chgnet(torch):
    """``[parallel-chgnet]``: CHGNet at CHGNET_KW with magmoms on the
    16384-atom crystal at P = 2. Per calculate: each block's atom conv once
    per segment, each bond block's line conv once (the line graph is one
    segment); row projections: the interior reads v before the exchange at
    both ends (one pass), the frontier the exchanged v at src and v before
    it at dst (two), the line conv b and v (two)."""
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, bench_atoms

    model = CHGNet(CHGNetConfig(**CHGNET_KW))
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    params["species_ref"]["w"] = torch.randn((CHGNET_KW["num_species"], 1), generator=gen)
    params["data_std"] = torch.tensor(1.3)
    blocks, c = CHGNET_KW["num_blocks"], CHGNET_KW["units"]

    def per_calc(P, stats):
        return {"chgnet_atom_conv_aggregate": 2 * blocks, "chgnet_line_aggregate": blocks - 1,
                "chgnet_row_projection": 3 * blocks + 2 * (blocks - 1)}

    atoms, rng = bench_atoms(CHGNET_REPS)
    return phase_parallel(torch, "parallel-chgnet", model, params, atoms, rng, (2,),
                          per_calc, {"compute_magmom": True},
                          lambda lg: chgnet_segment_checks(torch, lg, c))


def chgnet_segment_checks(torch, lg, c, dtype=None):
    """Both CHGNet kernels (their row projections inside) against their
    plain versions at ``lg``'s real ids and masks: the atom conv on each
    sorted edge segment, the line conv on the line graph; random rows and
    weights at C = H = ``c`` (in ``dtype``, float32 by default). Returns
    the worst error by kernel (bf16 names carry ``_bf16``)."""
    cgen = torch.Generator(device="cuda").manual_seed(98)
    half = dtype == torch.bfloat16
    suffix = "_bf16" if half else ""
    n = lg.n_cap
    errs = {}
    atom, line = "chgnet_atom_conv_aggregate" + suffix, "chgnet_line_aggregate" + suffix
    for name, sl in _segments(lg):
        ids, src, mask = lg.edge_dst[sl], lg.edge_src[sl], lg.edge_mask[sl]
        arrays, weights = chgnet_inputs(torch, cgen, "atom", ids.shape[0], c, c, n, (src, ids))
        if name == "frontier":  # v after the exchange at src, before it at dst
            arrays[2] = torch.randn(arrays[0].shape, generator=cgen, device="cuda")
        if half:
            arrays, weights, *_ = bf16_case((arrays, weights, ids, mask, n))
        errs[atom] = max(errs.get(atom, 0.0),
                         check_chgnet(torch, "atom", arrays, weights, ids, mask, n)[0])
        del arrays
    arrays, weights = chgnet_inputs(torch, cgen, "line", lg.line_dst.shape[0], c, c,
                                    (lg.b_cap, n), (lg.line_src, lg.line_dst, lg.line_center))
    if half:
        arrays, weights, *_ = bf16_case((arrays, weights, None, None, None))
    errs[line] = check_chgnet(torch, "line", arrays, weights, lg.line_dst, lg.line_mask,
                              lg.b_cap)[0]
    return errs


def phase_parallel_mace(torch):
    """``[parallel-mace]``: MACE at MACE_KW on the 2048-atom crystal at
    P = 2. Per calculate: each interaction's segment sum once per edge chunk
    forward and once in the backward's recompute, K chunks of the split
    layout (each segment chunked on its own)."""
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    model = MACE(MACEConfig(**MACE_KW))

    def per_calc(P, stats):
        K = chunk_layout(P * stats["e_cap"], MACE_KW["edge_chunk"], P * stats["e_split"])[2]
        return {"segment_sum": MACE_KW["num_interactions"] * 2 * K}

    atoms, rng = bench_atoms()
    return phase_parallel(torch, "parallel-mace", model, model.init(0), atoms, rng, (2,),
                          per_calc, {},
                          lambda lg: _chunk_checks(torch, lg, MACE_KW["edge_chunk"],
                                                   (40, MACE_KW["channels"]), 99))


def phase_parallel_escn(torch):
    """``[parallel-escn]``: eSCN at ESCN_KW with ESCN_INFO on the 2048-atom
    crystal at P = 2. Per calculate and edge chunk of the split layout: each
    layer's SO(2) kernel forward, in the checkpoint recompute and for its
    input cotangent; the segment sum of the edge-degree pass and of each
    layer forward and in the recompute. The MOLE gate pools every
    partition's owned atoms (``psum`` is the identity on the flattened
    graph)."""
    from distmlip_tpu_torch.models import ESCN, ESCNConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import ESCN_INFO, ESCN_KW, bench_atoms

    model = ESCN(ESCNConfig(**ESCN_KW))
    params = model.init(0)
    params["species_ref"]["w"] = torch.randn((ESCN_KW["num_species"],),
                                             generator=torch.Generator().manual_seed(0))
    layers = ESCN_KW["num_layers"]

    def per_calc(P, stats):
        K = chunk_layout(P * stats["e_cap"], ESCN_KW["edge_chunk"], P * stats["e_split"])[2]
        return {"so2_conv": layers * 3 * K, "segment_sum": (1 + layers) * 2 * K}

    atoms, rng = bench_atoms()
    atoms.info = dict(ESCN_INFO)
    return phase_parallel(torch, "parallel-escn", model, params, atoms, rng, (2,),
                          per_calc, {},
                          lambda lg: _chunk_checks(torch, lg, ESCN_KW["edge_chunk"],
                                                   (25, ESCN_KW["channels"]), 100))


def phase_parallel_md(torch):
    """``[parallel-md]``: PARALLEL_MD_STEPS nvt_bussi steps (MD_KW) of
    TensorNet at TENSORNET_KW on the 16384-atom crystal at P = 2 (the
    default ``async_rebuild``: skin invalidations adopt a graph the worker
    built in the background), then the same steps from the same seed at
    P = 2 with ``async_rebuild=False`` (every invalidation rebuilt on the
    host in the step) and at P = 1 (device refreshes). The drivers run
    unchanged on a P > 1 potential; per-step energies and the last
    positions and forces agree at the float32 bar. Prints the prefetch
    hits, the adopted steps' wait and ms against hits, and hit ms with a
    background build in flight against hits without one."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    params = model.init(0)
    layers = TENSORNET_KW["num_layers"]
    runs = {}
    for P, async_rebuild in ((2, True), (2, False), (1, True)):
        tag = f"parallel-md P={P}" + ("" if async_rebuild else " async_rebuild=False")
        pot = DistPotential(model, params, device="cuda", skin=0.5, num_partitions=P,
                            async_rebuild=async_rebuild)
        structure = bench_atoms(TENSORNET_REPS)
        probe, step_s, launches, peak = run_md(torch, pot, structure, PARALLEL_MD_STEPS, tag)
        n_calc, segs = len(probe.calls), 2 if P > 1 else 1
        expected = {k: 0 for k in launches}
        expected["tensornet_embed_aggregate"] = n_calc * segs
        expected["tensornet_interaction_aggregate"] = n_calc * layers * segs
        expected["tensornet_interaction_backward"] = n_calc * layers * segs
        if launches != expected:
            raise AssertionError(f"[{tag}] kernel launch counts {launches} differ from the "
                                 f"derivation {expected}")
        if P > 1 and pot.rebuild_on_device_count:
            raise AssertionError(f"[{tag}] refreshed a P>1 graph on the device")
        if P > 1 and async_rebuild and not pot.prefetch_hits:
            raise AssertionError(f"[{tag}] no invalidation adopted a background build")
        summary = md_summary(pot, probe, step_s, peak, launches, expected)
        log(f"[{tag}] {json.dumps(summary)}")
        runs[(P, async_rebuild)] = (
            structure[0].positions.copy(),
            np.array([c["result"]["energy"] for c in probe.calls]),
            probe.calls[-1]["result"]["forces"], launches)
        pot.close()
        del pot, probe
        torch.cuda.empty_cache()

    def deltas(a, b):
        (xa, ea, fa, _), (xb, eb, fb, _) = runs[a], runs[b]
        return {"max_dx_A": float(np.abs(xa - xb).max()),
                "max_rel_dE": float((np.abs(ea - eb) / np.abs(eb)).max()),
                "max_dF_last": float(np.abs(fa - fb).max())}

    for other, what in (((1, True), "P=2 vs P=1"), ((2, False), "P=2 vs P=2 async_rebuild=False")):
        d = deltas((2, True), other)
        log(f"[parallel-md] {what} over {PARALLEL_MD_STEPS} steps: {json.dumps(d)}")
        if not (d["max_dx_A"] < 1e-4 and d["max_rel_dE"] < 1e-5 and d["max_dF_last"] < 1e-4):
            raise AssertionError(f"[parallel-md] {what}: the trajectories depart")
    return runs[(2, True)][3]


# ---------------------------------------------------------------------------
# batched engine and serving (block-diagonally packed graphs)
# ---------------------------------------------------------------------------

BATCH_STEPS = 3             # 0.01 Å moves after the warm calculate (bench.py:359-367)
BATCHED_MD_STEPS = 40
BATCHED_RELAX_STEPS = 30
SERVE_REQUESTS = 24
# the engine routes a structure to the fallback lane when n_atoms >
# max_batch_atoms, so the 2048-atom structure needs a ceiling below 2048
SERVE_MAX_BATCH_ATOMS = 1024


def batched_family(torch, family):
    """(model, params, potential kwargs, per-calculate launches from the
    packed graph's stats, the kernels-vs-plain checks on a packed graph's
    LocalGraph, atoms.info) of one family at its full published width."""
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import (CHGNET_KW, ESCN_INFO, ESCN_KW, MACE_KW,
                                                   TENSORNET_KW)

    gen = torch.Generator().manual_seed(0)
    if family == "mace":
        model = MACE(MACEConfig(**MACE_KW))
        return (model, model.init(0), {},
                lambda st: {"segment_sum": MACE_KW["num_interactions"] * 2
                            * chunk_layout(st["e_cap"], MACE_KW["edge_chunk"])[2]},
                lambda lg: _chunk_checks(torch, lg, MACE_KW["edge_chunk"],
                                         (40, MACE_KW["channels"]), 99), {})
    if family == "tensornet":
        model, layers = TensorNet(TensorNetConfig(**TENSORNET_KW)), TENSORNET_KW["num_layers"]
        return (model, model.init(0), {},
                lambda st: {"tensornet_embed_aggregate": 1,
                            "tensornet_interaction_aggregate": layers,
                            "tensornet_interaction_backward": layers},
                lambda lg: tensornet_segment_checks(torch, lg, TENSORNET_KW["units"]), {})
    if family == "chgnet":
        model, blocks = CHGNet(CHGNetConfig(**CHGNET_KW)), CHGNET_KW["num_blocks"]
        params = model.init(0)
        params["species_ref"]["w"] = torch.randn((CHGNET_KW["num_species"], 1), generator=gen)
        params["data_std"] = torch.tensor(1.3)
        return (model, params, {"compute_magmom": True},
                lambda st: {"chgnet_atom_conv_aggregate": blocks,
                            "chgnet_line_aggregate": blocks - 1,
                            "chgnet_row_projection": blocks + 2 * (blocks - 1)},
                lambda lg: chgnet_segment_checks(torch, lg, CHGNET_KW["units"]), {})
    model, layers = ESCN(ESCNConfig(**ESCN_KW)), ESCN_KW["num_layers"]
    experts = ESCN_KW["num_experts"]
    params = model.init(0)
    params["species_ref"]["w"] = torch.randn((ESCN_KW["num_species"],), generator=gen)

    def escn_per_calc(st):
        # 8 experts on a packed graph: the per-structure MOLE gate mixes the
        # outputs of one SO(2) kernel call per expert (forward, checkpoint
        # recompute, input cotangent) in every layer and edge chunk
        K = chunk_layout(st["e_cap"], ESCN_KW["edge_chunk"])[2]
        return {"so2_conv": layers * 3 * K * experts, "segment_sum": (1 + layers) * 2 * K}

    def escn_checks(lg):
        # B1 on the first edge chunk, B3 at the packed graph's chunk rows
        out = _chunk_checks(torch, lg, ESCN_KW["edge_chunk"], (25, ESCN_KW["channels"]), 100)
        rows = chunk_layout(lg.e_cap, ESCN_KW["edge_chunk"])[3]
        case = so2_case(torch, torch.Generator(device="cuda").manual_seed(101), rows,
                        ESCN_KW["l_max"], ESCN_KW["channels"])
        out["so2_conv"] = check_so2(torch, *case, ESCN_KW["channels"])[0]
        return out

    return model, params, {}, escn_per_calc, escn_checks, dict(ESCN_INFO)


def phase_batched(torch, family):
    """``[batched-<family>]``: ``BatchedPotential(device="cuda", skin=0.5)`` at
    B = 1 and B = 8 on the 32-atom pool, then the mixed batch (32, 108, 256
    atoms and a lone atom; 4 structures in 4 slots): one warm calculate and
    BATCH_STEPS moves of 0.01 Å, each launch count set to 0 just before and
    held to the per-calculate derivation; then the kernels against their
    plain versions on the packed graph's own arrays, and each structure at
    the last geometry against ``DistPotential`` on it alone and against a
    ``kernels=False`` ``BatchedPotential``. Returns the launches summed over
    the three runs and the packed kernel checks' worst errors."""
    from distmlip_tpu_torch.calculators import BatchedPotential, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.tools.workload import batched_pool, mixed_batch

    t_phase = time.perf_counter()
    tag = f"batched-{family}"
    model, params, kw, per_calc, kernel_check, info = batched_family(torch, family)
    pool, rng = batched_pool(8)
    total, errs, runs = {k: 0 for k in launch_counts}, {}, {}
    for name, structs in (("B1", pool[:1]), ("B8", pool), ("mixed", mixed_batch())):
        for a in structs:
            a.info = dict(info)
        pot = BatchedPotential(model, params, device="cuda", skin=0.5, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in launch_counts:
            launch_counts[k] = 0
        results, step_s, stats = [], [], []
        for step in range(1 + BATCH_STEPS):
            if step:
                for a in structs:
                    a.positions += rng.normal(0, 0.01, a.positions.shape)
            t = time.perf_counter()
            res = pot.calculate(structs)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            results.append(res)
            stats.append(dict(pot.last_stats))
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        expected = {k: sum(per_calc(st).get(k, 0) for st in stats) for k in launches}
        log(f"[{tag}] {name}: launches per calculate {json.dumps(per_calc(stats[-1]))} x "
            f"{len(stats)} calculates; counted {launches}")
        if launches != expected:
            raise AssertionError(f"[{tag}] {name}: kernel launch counts {launches} differ "
                                 f"from the derivation {expected}")
        if pot.rebuild_count != 1:
            raise AssertionError(f"[{tag}] {name}: packed graph rebuilt after the first "
                                 f"calculate ({pot.rebuild_count} builds)")
        for res in results:
            for r, a in zip(res, structs):
                check_result(r, len(a))
        for k, v in launches.items():
            total[k] += v
        for k, v in kernel_check(local_graph_from_stacked(pot._cache[0])).items():
            errs[k] = max(errs.get(k, 0.0), v)
        single = DistPotential(model, params, device="cuda", **kw)
        vs_single = worst_deltas(results[-1], [single.calculate(a) for a in structs])
        del single
        plain = BatchedPotential(model, params, device="cuda", kernels=False, **kw)
        before = dict(launch_counts)
        vs_plain = worst_deltas(results[-1], plain.calculate(structs))
        if dict(launch_counts) != before:
            raise AssertionError(f"[{tag}] the kernels=False reference launched a kernel")
        del plain
        st = stats[-1]
        steady = statistics.median(step_s[1:])
        runs[name] = {
            "structures": len(structs), "n_atoms": [len(a) for a in structs],
            "bucket_key": st["bucket_key"], "padding_waste_frac": st["padding_waste_frac"],
            "batch_occupancy": st["batch_occupancy"], "compile_count": pot.compile_count,
            "first_calculate_ms": step_s[0] * 1e3, "step_ms": [x * 1e3 for x in step_s[1:]],
            "step_ms_median": steady * 1e3, "structures_per_s": len(structs) / steady,
            "max_memory_allocated_bytes": peak,
            "first_calculate_peak_bytes": stats[0]["batch_peak_bytes"],
            "vs_single": vs_single, "vs_plain": vs_plain, "launches": launches,
        }
        log(f"[{tag}] {name}: {json.dumps(runs[name])}")
        if not (within_bar(vs_single) and within_bar(vs_plain)):
            raise AssertionError(f"[{tag}] {name}: the batch disagrees with DistPotential or "
                                 f"with its plain reference")
        del pot
        torch.cuda.empty_cache()
    log(f"[{tag}] kernels on the packed graphs agree with their plain versions: max |err| "
        f"{json.dumps(errs)}; phase {time.perf_counter() - t_phase:.1f} s")
    return total, errs


def phase_batched_bf16(torch, family):
    """``[batched-mace-bf16]`` / ``[batched-tensornet-bf16]`` /
    ``[batched-chgnet-bf16]``: ``BatchedPotential`` over MACE at
    MACE_BF16_KW, TensorNet at TENSORNET_BF16_KW or CHGNet at CHGNET_BF16_KW
    (with magmoms and ``[main-chgnet]``'s readout terms) at B = 1 and 8 on
    the 32-atom pool, one warm calculate and BATCH_STEPS moves, launches of
    the bf16 kernels derived per calculate; each structure at the last
    geometry against ``DistPotential`` on it alone and against
    ``kernels=False`` within rel dE < 1e-3, max |dF| < 0.1 of the largest
    force and max |dm| < 0.05 of the largest magmom."""
    from distmlip_tpu_torch.calculators import BatchedPotential, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, MACE, MACEConfig, TensorNet,
                                           TensorNetConfig)
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import (CHGNET_BF16_KW, MACE_BF16_KW,
                                                   TENSORNET_BF16_KW, batched_pool)

    tag = f"batched-{family}-bf16"
    pot_kw = {}
    if family == "mace":
        model = MACE(MACEConfig(**MACE_BF16_KW))
        params = model.init(0)

        def per_calc(st):
            return {"segment_sum_bf16": MACE_BF16_KW["num_interactions"] * 2 * chunk_layout(
                st["e_cap"], MACE_BF16_KW["edge_chunk"])[2]}
    elif family == "tensornet":
        model = TensorNet(TensorNetConfig(**TENSORNET_BF16_KW))
        params = model.init(0)
        layers = TENSORNET_BF16_KW["num_layers"]

        def per_calc(st):
            return {"tensornet_embed_aggregate_bf16": 1,
                    "tensornet_interaction_aggregate_bf16": layers,
                    "tensornet_interaction_backward_bf16": layers}
    else:
        model = CHGNet(CHGNetConfig(**CHGNET_BF16_KW))
        params = model.init(0)
        params["species_ref"]["w"] = torch.randn((CHGNET_BF16_KW["num_species"], 1),
                                                 generator=torch.Generator().manual_seed(0))
        params["data_std"] = torch.tensor(1.3)
        blocks = CHGNET_BF16_KW["num_blocks"]
        pot_kw = {"compute_magmom": True}

        def per_calc(st):
            return {"chgnet_atom_conv_aggregate_bf16": blocks,
                    "chgnet_line_aggregate_bf16": blocks - 1,
                    "chgnet_row_projection_bf16": blocks + 2 * (blocks - 1)}
    pool, rng = batched_pool(8)
    total = {k: 0 for k in launch_counts}
    for name, structs in (("B1", pool[:1]), ("B8", pool)):
        pot = BatchedPotential(model, params, device="cuda", skin=0.5, **pot_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in launch_counts:
            launch_counts[k] = 0
        results, step_s, stats = [], [], []
        for step in range(1 + BATCH_STEPS):
            if step:
                for a in structs:
                    a.positions += rng.normal(0, 0.01, a.positions.shape)
            t = time.perf_counter()
            results.append(pot.calculate(structs))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            stats.append(dict(pot.last_stats))
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        expected = {k: sum(per_calc(st).get(k, 0) for st in stats) for k in launches}
        if launches != expected or pot.rebuild_count != 1:
            raise AssertionError(f"[{tag}] {name}: launches {launches} against "
                                 f"{expected}, {pot.rebuild_count} builds")
        for res in results:
            for r, a in zip(res, structs):
                check_result(r, len(a))
        for k, v in launches.items():
            total[k] += v
        single = DistPotential(model, params, device="cuda", **pot_kw)
        refs = {"single": [single.calculate(a) for a in structs]}
        before = dict(launch_counts)
        refs["plain"] = BatchedPotential(model, params, device="cuda", kernels=False,
                                         **pot_kw).calculate(structs)
        if dict(launch_counts) != before:
            raise AssertionError(f"[{tag}] the kernels=False reference launched")
        steady = statistics.median(step_s[1:])
        run = {"structures": len(structs), "bucket_key": stats[-1]["bucket_key"],
               "compile_count": pot.compile_count, "first_calculate_ms": step_s[0] * 1e3,
               "step_ms": [x * 1e3 for x in step_s[1:]], "step_ms_median": steady * 1e3,
               "structures_per_s": len(structs) / steady, "max_memory_allocated_bytes": peak,
               "launches": launches}
        for what, ref in refs.items():
            d = worst_deltas(results[-1], ref)
            f_scale = max(float(abs(r["forces"]).max()) for r in ref)
            m_scale = max(float(abs(r["magmoms"]).max()) for r in ref) if pot_kw else 0.0
            run[f"vs_{what}"] = dict(d, max_F=f_scale)
            # bf16 against bf16 in other chunk layouts: the JAX package's
            # bf16 bar (its float32 one measures this noise in [main-bf16])
            if not (d["rel_dE"] < 1e-3 and d["max_dF"] < 0.1 * f_scale
                    and d.get("max_dm", 0.0) <= 0.05 * m_scale):
                raise AssertionError(f"[{tag}] {name}: the batch departs from "
                                     f"{what} past the bf16 bar: {d}")
        log(f"[{tag}] {name}: {json.dumps(run)}")
        del pot, single
        torch.cuda.empty_cache()
    return total


def phase_batched_md(torch):
    """``[batched-md]``: ``BatchedMD`` with TensorNet at TENSORNET_KW on the
    8 x 32-atom pool, ``nvt_berendsen`` at targets alternating 300 / 600 K
    (Maxwell-Boltzmann velocities at the targets), BATCHED_MD_STEPS steps of
    2 fs, ``skin=0.5`` and ``device_rebuild="auto"``. Launch counts from just
    before the driver is made (its first calculate) to just after the last
    step: per calculate 1 embed + L interactions + L backwards. Fails without
    an in-place packed refresh, on a host repack that is not an overflow,
    and where a refreshed frame (or the last) disagrees with a fresh host
    pack beyond the float32 bar."""
    import numpy as np

    from distmlip_tpu_torch.calculators import Atoms, BatchedMD, BatchedPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, batched_pool

    t_phase = time.perf_counter()
    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    params = model.init(0)
    pool, rng = batched_pool(8, seed=2)
    temps = [300.0, 600.0] * 4
    for a, t in zip(pool, temps):
        a.set_maxwell_boltzmann_velocities(t, rng=rng)
    pot = BatchedPotential(model, params, device="cuda", skin=0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    md = BatchedMD(pool, pot, ensemble="nvt_berendsen", timestep=2.0, temperature=temps)
    step_s, kinds, refresh_ms, frames = [], [], [], []
    for _ in range(BATCHED_MD_STEPS):
        t = time.perf_counter()
        md.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        st = pot.last_stats
        kind = ("refresh" if st["rebuild_on_device"] else
                "host" if st["rebuild_count"] else "hit")
        kinds.append(kind)
        if kind == "refresh":
            refresh_ms.append(pot.last_timings["rebuild_s"] * 1e3)
            frames.append(([a.positions.copy() for a in md.atoms_list], md.results))
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    frames.append(([a.positions.copy() for a in md.atoms_list], md.results))
    n_calc, layers = 1 + BATCHED_MD_STEPS, TENSORNET_KW["num_layers"]
    expected = {k: 0 for k in launches}
    expected.update(tensornet_embed_aggregate=n_calc,
                    tensornet_interaction_aggregate=n_calc * layers,
                    tensornet_interaction_backward=n_calc * layers)
    log(f"[batched-md] launches: {n_calc} calculates x (1 embed + {layers} interactions + "
        f"{layers} backwards); counted {launches}")
    if launches != expected:
        raise AssertionError(f"[batched-md] kernel launch counts {launches} differ from the "
                             f"derivation {expected}")
    if pot.rebuild_on_device_count < 1:
        raise AssertionError("[batched-md] no in-place packed refresh happened")
    if pot.rebuild_count - 1 - pot.rebuild_on_device_count != pot.rebuild_overflow_count:
        raise AssertionError(f"[batched-md] a host repack after the first that is not an "
                             f"overflow ({pot.rebuild_count} builds, "
                             f"{pot.rebuild_on_device_count} on the device)")
    if not all(np.isfinite(a.velocities).all() for a in md.atoms_list):
        raise AssertionError("[batched-md] non-finite velocities")
    fresh = BatchedPotential(model, params, device="cuda", skin=0.0)
    worst = {}
    for positions, results in frames:
        structs = [Atoms(numbers=a.numbers, positions=p, cell=a.cell)
                   for a, p in zip(md.atoms_list, positions)]
        for k, v in worst_deltas(results, fresh.calculate(structs)).items():
            worst[k] = max(worst.get(k, 0.0), v)
    by = {k: [s * 1e3 for s, kk in zip(step_s, kinds) if kk == k]
          for k in ("hit", "refresh", "host")}
    summary = {
        "structures": len(pool), "n_atoms": int(sum(len(a) for a in pool)),
        "steps": BATCHED_MD_STEPS, "step_ms_median": {k: median(v) for k, v in by.items()},
        "steps_by_kind": {k: len(v) for k, v in by.items()}, "refresh_ms": refresh_ms,
        "structures_per_s": len(pool) * len(step_s) / sum(step_s),
        "rebuild_count": pot.rebuild_count,
        "rebuild_on_device_count": pot.rebuild_on_device_count,
        "rebuild_overflow_count": pot.rebuild_overflow_count,
        "temperatures_K": [float(x) for x in md.temperatures()],
        "max_memory_allocated_bytes": peak, "vs_fresh_host_pack": worst,
        "frames_checked": len(frames), "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[batched-md] {json.dumps(summary)}")
    if not within_bar(worst):
        raise AssertionError("[batched-md] a refreshed frame disagrees with a fresh host pack")
    return launches


def phase_batched_relax(torch):
    """``[batched-relax]``: ``BatchedRelaxer`` (FIRE, fmax 0.05 eV/Å, at most
    BATCHED_RELAX_STEPS steps) with CHGNet at CHGNET_KW (magmoms on) on 8
    32-atom structures rattled by a further 0.05 Å. Launches per calculate
    as in ``[batched-chgnet]``; the bond graph is repacked on the host when
    the skin budget is spent. Each calculate after such a repack, and the
    last, is held against a fresh ``skin=0`` pack of its geometries at the
    float32 bar."""
    import numpy as np

    from distmlip_tpu_torch.calculators import BatchedPotential, BatchedRelaxer
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.tools.workload import batched_pool

    t_phase = time.perf_counter()
    model, params, kw, per_calc, _, _ = batched_family(torch, "chgnet")
    pool, rng = batched_pool(8, seed=3)
    for a in pool:
        a.positions += rng.normal(0, 0.05, a.positions.shape)
    pot = BatchedPotential(model, params, device="cuda", skin=0.5, **kw)
    calls, frames, calculate = [], [], pot.calculate

    def timed(structs):
        t = time.perf_counter()
        out = calculate(structs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t, dict(pot.last_stats)))
        if len(calls) > 1 and pot.last_stats["rebuild_count"]:
            frames.append(([a.copy() for a in structs], out))
        return out

    pot.calculate = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    out = BatchedRelaxer(pot, optimizer="fire", fmax=0.05).relax(pool,
                                                                 steps=BATCHED_RELAX_STEPS)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    expected = {k: sum(per_calc(st).get(k, 0) for _, st in calls) for k in launches}
    log(f"[batched-relax] launches: {len(calls)} calculates x {json.dumps(per_calc({}))}; "
        f"counted {launches}")
    if launches != expected:
        raise AssertionError(f"[batched-relax] kernel launch counts {launches} differ from "
                             f"the derivation {expected}")
    for r in out:
        if not (np.isfinite(r.energy) and np.isfinite(r.forces).all()
                and np.isfinite(r.atoms.positions).all()):
            raise AssertionError("[batched-relax] non-finite result")
    frames.append(([r.atoms for r in out],
                   [{"energy": r.energy, "forces": r.forces, "stress": r.stress} for r in out]))
    fresh = BatchedPotential(model, params, device="cuda", skin=0.0, **kw)
    worst = {}
    for structs, results in frames:
        refs = fresh.calculate(structs)
        if "magmoms" not in results[0]:  # a RelaxResult carries no magmoms
            refs = [{k: v for k, v in r.items() if k != "magmoms"} for r in refs]
        for k, v in worst_deltas(results, refs).items():
            worst[k] = max(worst.get(k, 0.0), v)
    summary = {
        "structures": len(pool), "calculates": len(calls),
        "nsteps": [r.nsteps for r in out], "converged": [bool(r.converged) for r in out],
        "fmax_final": [float(np.abs(r.forces).max()) for r in out],
        "step_ms_median": median([s * 1e3 for s, _ in calls[1:]]),
        "first_calculate_ms": calls[0][0] * 1e3,
        "host_repacks": sum(st["rebuild_count"] for _, st in calls),
        "max_memory_allocated_bytes": peak, "vs_fresh_pack": worst,
        "frames_checked": len(frames), "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[batched-relax] {json.dumps(summary)}")
    if not within_bar(worst):
        raise AssertionError("[batched-relax] a relax frame disagrees with a fresh pack")
    return launches


def phase_serve(torch):
    """``[serve]``: ``ServeEngine(BatchedPotential(MACE), fallback=DistPotential(
    MACE), max_batch=B, max_wait_s=0.005, admission="block",
    max_batch_atoms=SERVE_MAX_BATCH_ATOMS)`` at B = 1 and 8 (MACE at MACE_KW,
    skin 0.5): ``run_open_loop`` of SERVE_REQUESTS burst requests over the 8
    structure pool, once to warm and once measured (bench.py:415-426), then
    ``run_closed_loop`` with 4 clients; then one round of the pool, the mixed
    batch, the 2048-atom crystal (the fallback lane) and a NaN-position
    request (its own Future fails, no other). Every result of the measured
    open loop and of that round is held against ``DistPotential`` on the
    same structure. Launch counts from just before
    the engine is made to just after ``drain()``, each calculate of either
    lane giving 2 interactions x 2K segment sums for its e_cap."""
    from distmlip_tpu_torch.calculators import BatchedPotential, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.serve import ServeEngine, run_closed_loop, run_open_loop
    from distmlip_tpu_torch.tools.workload import (MACE_KW, batched_pool, bench_atoms,
                                                   mixed_batch)

    t_phase = time.perf_counter()
    model, params, _, _, _, _ = batched_family(torch, "mace")
    pool, _ = batched_pool(8, seed=4)
    big = bench_atoms()[0]
    extra = mixed_batch(5) + [big]
    nan = pool[0].copy()
    nan.positions[3, 1] = float("nan")
    total = {k: 0 for k in launch_counts}
    summaries = {}
    for B in (1, 8):
        e_caps = []

        def recorded(p):
            calculate = p.calculate

            def call(x):
                out = calculate(x)
                e_caps.append(p.last_stats["e_cap"])
                return out
            p.calculate = call
            return p

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in launch_counts:
            launch_counts[k] = 0
        pot = recorded(BatchedPotential(model, params, device="cuda", skin=0.5))
        fallback = recorded(DistPotential(model, params, device="cuda", skin=0.5))
        engine = ServeEngine(pot, fallback=fallback, max_batch=B, max_wait_s=0.005,
                             admission="block", max_batch_atoms=SERVE_MAX_BATCH_ATOMS)
        run_open_loop(engine, pool, SERVE_REQUESTS, rate_hz=0.0)   # warm
        submit, served = engine.submit, []

        def keep(a, **kw):  # the measured open loop's futures, to check
            fut = submit(a, **kw)
            served.append((a, fut))
            return fut
        engine.submit = keep
        open_rep = run_open_loop(engine, pool, SERVE_REQUESTS, rate_hz=0.0)
        engine.submit = submit
        closed_rep = run_closed_loop(engine, pool, SERVE_REQUESTS, concurrency=4)
        structs = pool + extra
        futs = [engine.submit(a) for a in structs]
        bad = engine.submit(nan)
        results = [f.result(timeout=600) for f in futs]
        try:
            bad.result(timeout=600)
            raise AssertionError("[serve] the NaN request returned a result")
        except ValueError as e:
            if "non-finite" not in str(e):
                raise
        if not engine.drain(timeout=600):
            raise AssertionError("[serve] drain() timed out")
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        snap = engine.stats.snapshot()
        compiles = engine.compile_count
        engine.close()
        if engine.queue_depth or engine.scheduler_alive:
            raise AssertionError("[serve] close() left work or the scheduler behind")
        per = MACE_KW["num_interactions"] * 2
        expected = {k: 0 for k in launches}
        expected["segment_sum"] = sum(per * chunk_layout(e, MACE_KW["edge_chunk"])[2]
                                      for e in e_caps)
        log(f"[serve] B={B}: {len(e_caps)} calculates of the two lanes x "
            f"{MACE_KW['num_interactions']} interactions x 2K (K edge chunks of each "
            f"calculate's e_cap) = {expected['segment_sum']}; counted {launches}")
        if launches != expected:
            raise AssertionError(f"[serve] B={B}: kernel launch counts {launches} differ "
                                 f"from the derivation {expected}")
        if snap["fallback_requests"] != 1 or snap["failed"] != 1:
            raise AssertionError(f"[serve] B={B}: expected 1 fallback and 1 failed request, "
                                 f"got {snap['fallback_requests']} and {snap['failed']}")
        for r, a in zip(results, structs):
            check_result(r, len(a))
        single = DistPotential(model, params, device="cuda")
        refs = [single.calculate(a) for a in structs]
        vs_single = worst_deltas(results, refs)
        by_id = {id(a): r for a, r in zip(structs, refs)}
        vs_open = worst_deltas([f.result() for _, f in served], [by_id[id(a)] for a, _ in served])
        del single
        buckets = snap["buckets"].values()
        occupancy = (sum(b["mean_batch_occupancy"] * b["batches"] for b in buckets)
                     / max(sum(b["batches"] for b in buckets), 1))
        summaries[B] = {
            "max_batch": B, "open_loop": open_rep.summary(), "closed_loop": closed_rep.summary(),
            "mean_batch_occupancy": occupancy, "batches": snap["batches"],
            "compile_count": compiles, "fallback_requests": snap["fallback_requests"],
            "failed": snap["failed"], "completed": snap["completed"],
            "max_memory_allocated_bytes": peak, "vs_single": vs_single,
            "open_loop_vs_single": vs_open, "open_loop_checked": len(served),
            "launches": launches,
        }
        log(f"[serve] B={B}: {json.dumps(summaries[B])}")
        if len(served) != SERVE_REQUESTS or not (within_bar(vs_single) and within_bar(vs_open)):
            raise AssertionError(f"[serve] B={B}: a served result disagrees with "
                                 f"DistPotential")
        for k, v in launches.items():
            total[k] += v
        del pot, fallback, engine
        torch.cuda.empty_cache()
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# DeviceMD (the device-resident MD loop) and EnsemblePotential
# ---------------------------------------------------------------------------

DEVICE_MD_STEPS = 40
DEVICE_MD_FIRST = 5   # steps of the first chunk: memory and agreement read after it
SYNC_WORDS = "synchroniz"  # in torch's sync-debug warning


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def count_chunk_syncs(torch, md):
    """Wraps ``md``'s two chunk steppers so that each call runs under
    ``torch.cuda.set_sync_debug_mode("warn")``, and counts every
    synchronizing CUDA call inside it (the loop's own reads and any inside
    the kernel wrappers) by the Python line that made it. Returns the tally:
    ``chunks``, ``syncs`` and ``sites``."""
    import collections
    import os
    import warnings

    tally = {"chunks": 0, "syncs": 0, "sites": collections.Counter()}

    def wrap(fn):
        def counted(*args, **kw):
            tally["chunks"] += 1
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    for w in caught:
                        if SYNC_WORDS in str(w.message):
                            tally["syncs"] += 1
                            tally["sites"][f"{os.path.basename(w.filename)}:{w.lineno}"] += 1
        return counted

    md._device_chunk = wrap(md._device_chunk)
    md._host_chunk = wrap(md._host_chunk)
    return tally


def run_device_md(torch, pot, structure, tag, timestep):
    """``DeviceMD`` (NVE) over ``pot`` from Maxwell-Boltzmann velocities at
    MD_KW's 600 K drawn from the structure's seeded generator (as
    ``run_md``): a chunk of DEVICE_MD_FIRST steps, then one of the rest of
    DEVICE_MD_STEPS. Every launch count is set to 0 just before the first
    chunk and read just after the last; the syncs inside the chunks are
    counted (``count_chunk_syncs``). Fails on a non-finite state, on more
    host reads than one a step plus one a refresh and one a chunk (the host
    stepper's uncommitted trial step), and on device memory that grows from
    the first chunk to the second. Returns the driver, the positions after
    the first chunk and a summary."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DeviceMD
    from distmlip_tpu_torch.kernels import launch_counts

    atoms, rng = structure
    atoms.set_maxwell_boltzmann_velocities(MD_KW["temperature"], rng=rng)
    md = DeviceMD(pot, atoms, timestep=timestep)
    tally = count_chunk_syncs(torch, md)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    chunks = []
    for n in (DEVICE_MD_FIRST, DEVICE_MD_STEPS - DEVICE_MD_FIRST):
        done, reads, refreshes = md.steps_done, md.host_reads, md.rebuilds_on_device
        t = time.perf_counter()
        md.run(n)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        chunks.append({"steps": md.steps_done - done, "ms_per_step": seconds * 1e3 / n,
                       "host_reads": md.host_reads - reads,
                       "refreshes": md.rebuilds_on_device - refreshes,
                       "allocated_bytes": torch.cuda.memory_allocated(),
                       "peak_bytes": torch.cuda.max_memory_allocated()})
        torch.cuda.reset_peak_memory_stats()
        if not chunks[1:]:
            pos_first = atoms.positions.copy()
    launches = dict(launch_counts)
    if not (np.isfinite(atoms.positions).all() and np.isfinite(atoms.velocities).all()
            and np.isfinite(md.results["energy"])) or md.steps_done != DEVICE_MD_STEPS:
        raise AssertionError(f"[{tag}] {md.steps_done} steps, or a non-finite state")
    steps = md.steps_done
    summary = {
        "n_atoms": len(atoms), "steps": steps, "device_rebuild": md.device_rebuild,
        "ms_per_step": sum(c["ms_per_step"] * c["steps"] for c in chunks) / steps,
        "chunks": chunks, "chunk_calls": tally["chunks"],
        "force_evaluations": steps + tally["chunks"],
        "host_reads": md.host_reads, "host_reads_per_step": md.host_reads / steps,
        "syncs": tally["syncs"], "syncs_per_step": tally["syncs"] / steps,
        "sync_sites": dict(tally["sites"].most_common()),
        "rebuilds": md.rebuilds, "rebuilds_on_device": md.rebuilds_on_device,
        "rebuild_overflows": md.rebuild_overflows,
        "energy": md.results["energy"], "kinetic": md.results["kinetic"],
        "launches": launches,
    }
    if md.host_reads > steps + md.rebuilds_on_device + tally["chunks"]:
        raise AssertionError(f"[{tag}] {md.host_reads} host reads in {steps} steps")
    first, rest = chunks
    if (rest["allocated_bytes"] > first["allocated_bytes"] + (64 << 20)
            or rest["peak_bytes"] > 1.05 * first["peak_bytes"] + (64 << 20)):
        raise AssertionError(f"[{tag}] device memory grew from step {DEVICE_MD_FIRST} to "
                             f"{steps}: {first} -> {rest}")
    return md, pos_first, summary


def device_md_phase(torch, tag, model, params, structure_fn, timestep, expected_for,
                    min_refreshes=0):
    """The runs of ``[device-md]`` and ``[device-md-mace]``: ``DeviceMD``
    with the in-loop refresh, ``DeviceMD`` with the host rebuild
    (``device_rebuild=False`` on the potential; DeviceMD's "auto" takes it),
    ``MolecularDynamics`` (NVE) from the same start, all at skin 0.5 on the
    card, then the first DEVICE_MD_FIRST steps with ``kernels=False`` (the
    positions within 1e-4 Å). ``expected_for(evaluations, launches, e_cap)``
    derives the launches; the derivation holds without overflows, which
    would change the caps. The in-loop run must refresh ``min_refreshes``
    times or more. Returns the DeviceMD runs' launches."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DeviceMD, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts

    t_phase = time.perf_counter()
    total = {k: 0 for k in launch_counts}
    report = {}
    for name, device_rebuild in (("in-loop refresh", "auto"), ("host rebuild", False)):
        pot = DistPotential(model, params, device="cuda", skin=0.5,
                            device_rebuild=device_rebuild)
        md, pos_first, summary = run_device_md(torch, pot, structure_fn(), tag, timestep)
        e_cap = pot._cache[0].e_cap
        expected = expected_for(summary["force_evaluations"], summary["launches"], e_cap)
        log(f"[{tag}] {name}: launches over {summary['force_evaluations']} force "
            f"evaluations ({summary['steps']} steps + {summary['chunk_calls']} chunk starts) "
            f"= {nonzero(expected)}; counted {nonzero(summary['launches'])}")
        if md.rebuild_overflows or summary["launches"] != expected:
            raise AssertionError(f"[{tag}] {name}: launches {summary['launches']} differ "
                                 f"from the derivation {expected}, or a capacity overflowed "
                                 f"({md.rebuild_overflows})")
        if md.device_rebuild != (device_rebuild == "auto") or (
                md.device_rebuild and md.rebuilds_on_device < min_refreshes):
            raise AssertionError(f"[{tag}] {name}: device_rebuild {md.device_rebuild}, "
                                 f"{md.rebuilds_on_device} in-loop refreshes")
        summary["e_cap"] = e_cap
        report[name] = summary
        for k, v in summary["launches"].items():
            total[k] += v
        if name == "in-loop refresh":
            kernel_first, kernel_last = pos_first, md.atoms.positions.copy()
        log(f"[{tag}] {name}: {json.dumps(summary)}")
        del md, pot
        torch.cuda.empty_cache()

    pot = DistPotential(model, params, device="cuda", skin=0.5)
    probe, step_s, launches, peak = run_md(torch, pot, structure_fn(), DEVICE_MD_STEPS,
                                           f"{tag} MolecularDynamics", ensemble="nve",
                                           timestep=timestep)
    expected = expected_for(len(probe.calls), launches, pot._cache[0].e_cap)
    if launches != expected:
        raise AssertionError(f"[{tag}] MolecularDynamics launches {launches} differ from "
                             f"the derivation {expected}")
    host_md = md_summary(pot, probe, step_s, peak, launches, expected)
    host_md["ms_per_step"] = sum(step_s) * 1e3 / len(step_s)
    # float64 host integrator against the float32 device one: reported only
    host_md["max_dx_vs_device_md_after_40"] = float(
        np.abs(probe.calls[-1]["positions"] - kernel_last).max())
    log(f"[{tag}] MolecularDynamics: {json.dumps(host_md)}")
    del pot, probe
    torch.cuda.empty_cache()

    atoms, rng = structure_fn()
    atoms.set_maxwell_boltzmann_velocities(MD_KW["temperature"], rng=rng)
    before = dict(launch_counts)
    t = time.perf_counter()
    DeviceMD(DistPotential(model, params, device="cuda", skin=0.5, kernels=False), atoms,
             timestep=timestep).run(DEVICE_MD_FIRST)
    plain_ms = (time.perf_counter() - t) * 1e3 / DEVICE_MD_FIRST
    dx = float(np.abs(atoms.positions - kernel_first).max())
    if dict(launch_counts) != before:
        raise AssertionError(f"[{tag}] the kernels=False run launched a kernel")
    log(f"[{tag}] first {DEVICE_MD_FIRST} steps, kernels vs plain on the card: max |dx| "
        f"{dx:.3e} Å (bar 1e-4); plain {plain_ms:.1f} ms a step")
    if not dx < 1e-4:
        raise AssertionError(f"[{tag}] kernels and plain positions differ by {dx} Å")
    # all 40 steps, and the second chunk's alone (no host build, no first call)
    steps_ms = {k: [v["ms_per_step"], v["chunks"][1]["ms_per_step"]] for k, v in report.items()}
    steps_ms["MolecularDynamics"] = [host_md["ms_per_step"],
                                     sum(step_s[DEVICE_MD_FIRST:]) * 1e3 / len(step_s[DEVICE_MD_FIRST:])]
    log(f"[{tag}] ms a step (all steps, steps {DEVICE_MD_FIRST + 1}-{DEVICE_MD_STEPS}): "
        f"{json.dumps(steps_ms)}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_device_md(torch):
    """``[device-md]``: TensorNet at TENSORNET_KW on the 16,384-atom
    crystal, DEVICE_MD_STEPS NVE steps of 2 fs (``device_md_phase``); at
    least one in-loop refresh. Launches derived: 1 embed + L interactions +
    L interaction backwards per force evaluation (one a step, one at each
    chunk's start)."""
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    layers = TENSORNET_KW["num_layers"]

    def expected_for(evaluations, launches, e_cap):
        want = {k: 0 for k in launches}
        want.update(tensornet_embed_aggregate=evaluations,
                    tensornet_interaction_aggregate=layers * evaluations,
                    tensornet_interaction_backward=layers * evaluations)
        return want

    return device_md_phase(torch, "device-md", model, model.init(0),
                           lambda: bench_atoms(TENSORNET_REPS), MD_KW["timestep"],
                           expected_for, min_refreshes=1)


def phase_device_md_mace(torch):
    """``[device-md-mace]``: MACE at MACE_KW on the 2048-atom crystal, the
    same runs at MACE_MD_TIMESTEP. Launches derived: num_interactions x 2K
    segment sums per force evaluation (K edge chunks of e_cap, forward and
    the checkpointed recompute)."""
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    model = MACE(MACEConfig(**MACE_KW))

    def expected_for(evaluations, launches, e_cap):
        want = {k: 0 for k in launches}
        want["segment_sum"] = evaluations * MACE_KW["num_interactions"] * 2 * chunk_layout(
            e_cap, MACE_KW["edge_chunk"])[2]
        return want

    return device_md_phase(torch, "device-md-mace", model, model.init(0), bench_atoms,
                           MACE_MD_TIMESTEP, expected_for)


ENSEMBLE_CALCS = 3  # per route: the first calculate (host build) and 2 moves of 0.01 Å


def ensemble_bar(tag, got, want):
    """Energy, forces, and the stress and magmoms where both have them, at
    the float32 bar of PERF.md §2; returns the deltas."""
    import numpy as np

    d = {"rel_dE": abs(got["energy"] - want["energy"]) / abs(want["energy"]),
         "max_dF": float(np.abs(got["forces"] - want["forces"]).max())}
    for key, k in (("max_dS", "stress"), ("max_dm", "magmoms")):
        if k in got and k in want:
            d[key] = float(np.abs(got[k] - want[k]).max())
    if not all(v < (1e-5 if k == "rel_dE" else 1e-4) for k, v in d.items()):
        raise AssertionError(f"[ensemble] {tag}: {d}")
    return d


def ensemble_member(res, m):
    """Member ``m`` of an ensemble result (no per-member stress: the result
    surface keeps the mean)."""
    out = {"energy": res["energies"][m], "forces": res["forces_all"][m]}
    if "magmoms_all" in res:
        out["magmoms"] = res["magmoms_all"][m]
    return out


def ensemble_family(torch, tag, model, members, structure, per_calc, **kw):
    """``EnsemblePotential`` over ``members`` on the card, stacked then
    sequential, ENSEMBLE_CALCS calculates each at the same geometries (the
    launch counts set to 0 before each route's first, read after its last,
    against ``per_calc(e_cap)`` x members x calculates); each member of the
    stacked route's last result against a lone ``DistPotential`` on its
    parameters (and the mean stress against the lone stresses' mean), and
    against the sequential route's. Returns the launches of both routes."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential, EnsemblePotential
    from distmlip_tpu_torch.kernels import launch_counts

    atoms, rng = structure
    geometries = [atoms.positions.copy()]
    for _ in range(ENSEMBLE_CALCS - 1):
        geometries.append(geometries[-1] + rng.normal(0, 0.01, atoms.positions.shape))
    total = {k: 0 for k in launch_counts}
    routes, last = {}, {}
    for stacked in (True, False):
        name = "stacked" if stacked else "sequential"
        ens = EnsemblePotential(model, members, stacked=stacked, device="cuda", skin=0.5, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in launch_counts:
            launch_counts[k] = 0
        ms = []
        for pos in geometries:
            atoms.positions = pos.copy()
            t = time.perf_counter()
            res = ens.calculate(atoms)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            check_result(res, len(atoms))
            if not (np.isfinite(res["forces_var"]).all() and res["energy_var"] > 0):
                raise AssertionError(f"[ensemble] {tag} {name}: variances")
        launches = dict(launch_counts)
        e_cap = ens.last_stats["e_cap"]
        expected = {k: 0 for k in launches}
        for k, v in per_calc(e_cap).items():
            expected[k] = v * len(members) * ENSEMBLE_CALCS
        log(f"[ensemble] {tag} {name}: launches {ENSEMBLE_CALCS} calculates x "
            f"{len(members)} members x {per_calc(e_cap)} = {nonzero(expected)}; counted "
            f"{nonzero(launches)}")
        if launches != expected:
            raise AssertionError(f"[ensemble] {tag} {name}: launches {launches} differ from "
                                 f"the derivation {expected}")
        routes[name] = {"calculate_ms": ms,
                        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                        "rebuild_count": sum(m.rebuild_count for m in ens.members),
                        "e_cap": e_cap}
        last[name] = res
        for k, v in launches.items():
            total[k] += v
        del ens
        torch.cuda.empty_cache()

    before = dict(launch_counts)
    vs_lone, vs_seq, lone_stress = [], [], []
    for m, params in enumerate(members):
        lone = DistPotential(model, params, device="cuda", skin=0.5, **kw).calculate(atoms)
        lone_stress.append(lone["stress"])
        vs_lone.append(ensemble_bar(f"{tag} member {m} vs lone", ensemble_member(
            last["stacked"], m), lone))
        vs_seq.append(ensemble_bar(f"{tag} member {m} stacked vs sequential", ensemble_member(
            last["stacked"], m), ensemble_member(last["sequential"], m)))
        torch.cuda.empty_cache()
    for k in launch_counts:  # the lone potentials' launches are not the ensemble's
        launch_counts[k] = before[k]
    stress = {"max_dS_mean_vs_lone": float(np.abs(
        last["stacked"]["stress"] - np.mean(lone_stress, axis=0)).max())}
    if not stress["max_dS_mean_vs_lone"] < 1e-4:
        raise AssertionError(f"[ensemble] {tag}: mean stress {stress}")
    summary = {"n_atoms": len(atoms), "members": len(members), **routes,
               "vs_lone": vs_lone, "stacked_vs_sequential": vs_seq,
               "means": ensemble_bar(f"{tag} means", last["stacked"], last["sequential"]),
               **stress, "energy_var": last["stacked"]["energy_var"],
               "forces_var_max": float(last["stacked"]["forces_var"].max())}
    log(f"[ensemble] {tag}: {json.dumps(summary)}")
    return total


def phase_ensemble(torch):
    """``[ensemble]``: 3 MACE members at MACE_KW (weights from seeds 0, 1,
    2) on the 2048-atom crystal, then 2 CHGNet members at CHGNET_KW with
    magmoms (seeds 0 and 1, readout terms off their defaults) on the
    16,384-atom crystal (``ensemble_family``). Launches derived per member
    and calculate as ``[main]``'s and ``[main-chgnet]``'s."""
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, MACE_KW, bench_atoms

    t_phase = time.perf_counter()
    model = MACE(MACEConfig(**MACE_KW))
    total = ensemble_family(
        torch, "mace", model, [model.init(s) for s in range(3)], bench_atoms(),
        lambda e_cap: {"segment_sum": MACE_KW["num_interactions"] * 2 * chunk_layout(
            e_cap, MACE_KW["edge_chunk"])[2]})
    model = CHGNet(CHGNetConfig(**CHGNET_KW))
    members = []
    for s in range(2):
        params = model.init(s)
        gen = torch.Generator().manual_seed(s)
        params["species_ref"]["w"] = torch.randn((CHGNET_KW["num_species"], 1), generator=gen)
        params["data_std"] = torch.tensor(1.3)
        members.append(params)
    blocks = CHGNET_KW["num_blocks"]
    launched = ensemble_family(
        torch, "chgnet", model, members, bench_atoms(CHGNET_REPS),
        lambda e_cap: {"chgnet_atom_conv_aggregate": blocks,
                       "chgnet_line_aggregate": blocks - 1,
                       "chgnet_row_projection": blocks + 2 * (blocks - 1)},
        compute_magmom=True)
    for k, v in launched.items():
        total[k] += v
    log(f"[ensemble] {time.perf_counter() - t_phase:.1f} s")
    return total

TRAIN_STEPS = 3   # timed optimizer steps after a warm one (bench.py's BENCH_TRAIN_STEPS)
TRAIN_LR = 1e-3   # Adam, as bench.py's train phase


def train_setup(torch, family):
    """(model, student params, teacher params, atoms.info, TrainConfig
    kwargs, loader kwargs) of one training phase at its full published width: the student
    from seed 0, the teacher from seed 1 (CHGNet's and eSCN's readout terms
    off their defaults, as ``batched_family``)."""
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)
    from distmlip_tpu_torch.tools.workload import (CHGNET_KW, ESCN_INFO, ESCN_KW,
                                                   MACE_BF16_KW, MACE_KW, TENSORNET_KW)

    info, cfg, lk = {}, {}, {}
    if family == "mace":
        model = MACE(MACEConfig(**MACE_KW))
    elif family == "mace-bf16":
        model, cfg = MACE(MACEConfig(**MACE_BF16_KW)), {"precision": "bf16"}
    elif family == "tensornet":
        model = TensorNet(TensorNetConfig(**TENSORNET_KW))
    elif family == "chgnet":
        model = CHGNet(CHGNetConfig(**CHGNET_KW))
        lk = {"use_bond_graph": True, "bond_cutoff": CHGNET_KW["bond_cutoff"]}
    else:
        model, info = ESCN(ESCNConfig(**ESCN_KW)), dict(ESCN_INFO)
    params = []
    for seed in (0, 1):
        p = model.init(seed)
        gen = torch.Generator().manual_seed(seed)
        if family == "chgnet":
            p["species_ref"]["w"] = torch.randn((CHGNET_KW["num_species"], 1), generator=gen)
            p["data_std"] = torch.tensor(1.3)
        elif family == "escn":
            p["species_ref"]["w"] = torch.randn((ESCN_KW["num_species"],), generator=gen)
        params.append(p)
    return model, params[0], params[1], info, cfg, lk


class RoleCounter:
    """Launch counts by the part of a train step that made them, from
    snapshots of ``launch_counts`` around each outermost
    ``torch.autograd.grad`` call (one made inside a backward, as the
    chunked recompute's, belongs to the call around it):
    ``forward`` (before a force gradient: the energy forward),
    ``force_backward`` (inside ``grad(..., create_graph=True)``: the force
    program's backward with its graph kept, B3's input cotangent and the
    checkpointed chunks' recompute) and ``parameter_backward`` (inside the
    parameter gradient: the double backward, B3's launch on the transposed
    weight set and its own backward)."""

    ROLES = ("forward", "force_backward", "parameter_backward")

    def __init__(self, torch, counts):
        self.torch, self.counts = torch, counts
        self.roles = {r: {k: 0 for k in counts} for r in self.ROLES}

    def _add(self, role, since):
        for k, v in self.counts.items():
            self.roles[role][k] += v - since[k]

    def __enter__(self):
        real = self.torch.autograd.grad
        self._last = dict(self.counts)
        self._depth = 0

        def grad(*a, **k):
            if self._depth:  # a grad inside a backward (the chunked recompute)
                return real(*a, **k)
            self._add("forward", self._last)
            before = dict(self.counts)
            self._depth += 1
            try:
                out = real(*a, **k)
            finally:
                self._depth -= 1
            self._add("force_backward" if k.get("create_graph") else "parameter_backward",
                      before)
            self._last = dict(self.counts)
            return out

        self._patch = mock.patch.object(self.torch.autograd, "grad", grad)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        self._add("forward", self._last)  # nothing should land here
        return False

    def nonzero(self):
        return {r: nonzero(c) for r, c in self.roles.items()}


def first_step(torch, model, params, batch, kernels, cfg):
    """The first optimizer step's loss terms and accumulated parameter
    gradient (before the update) from a fresh master copy of ``params`` on
    the card: the packed loss over each micro-batch of ``batch`` and its
    parameter gradient, summed in fp32 and averaged, as the step does."""
    import functools

    from distmlip_tpu_torch.train import init_train_state, make_packed_loss_fn
    from distmlip_tpu_torch.train.step import param_leaves

    state = init_train_state(functools.partial(torch.optim.SGD, lr=0.0), params,
                             config=cfg, device="cuda")
    loss_fn = make_packed_loss_fn(model.energy_fn, config=cfg, kernels=kernels)
    leaves = param_leaves(state.params)
    g_sum = [torch.zeros_like(p) for p in leaves]
    comps_sum = None
    for graph, tgt in zip(batch.graphs, batch.targets):
        loss, comps = loss_fn(state.params, graph, tgt)
        for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if g is not None:
                acc.add_(g.float())
        comps_sum = comps if comps_sum is None else {
            k: comps_sum[k] + v for k, v in comps.items()}
    n = len(batch.graphs)
    vec = torch.cat([g.reshape(-1) for g in g_sum]) / n
    return {k: float(v) / n for k, v in comps_sum.items()}, vec.double().cpu()


def train_expected(family, model, e_cap, passes):
    """Launches by role over ``passes`` micro-batch passes at edge
    capacity ``e_cap``, derived from the code: MACE's B1 runs
    num_interactions x K in the forward, again in the force backward
    (remat's recompute of each checkpointed chunk) and again in the
    parameter backward (the recompute once more); TensorNet launches its
    embed and L interactions forward, the interaction's backward kernel in
    the parameter backward (the forward Function's backward runs there
    outside grad mode) and nothing in the force backward (the chunked
    plain recompute); CHGNet launches its convs and row projections
    forward only; eSCN's B3 runs L x K x experts forward, twice that in
    the force backward (recompute and input cotangent) and three times in
    the parameter backward (the transposed launch's own backward, the
    input cotangent again, the recompute again), and its B1 (1 + L) x K in
    each."""
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    cfg, n = model.cfg, passes
    if family in ("mace", "mace-bf16"):
        per = cfg.num_interactions * chunk_layout(e_cap, cfg.edge_chunk)[2] * n
        b1 = "segment_sum_bf16" if family == "mace-bf16" else "segment_sum"
        return {r: {b1: per} for r in RoleCounter.ROLES}
    if family == "tensornet":
        L = cfg.num_layers
        return {"forward": {"tensornet_embed_aggregate": n,
                            "tensornet_interaction_aggregate": L * n},
                "force_backward": {},
                "parameter_backward": {"tensornet_interaction_backward": L * n}}
    if family == "chgnet":
        b = cfg.num_blocks
        return {"forward": {"chgnet_atom_conv_aggregate": b * n,
                            "chgnet_line_aggregate": (b - 1) * n,
                            "chgnet_row_projection": (b + 2 * (b - 1)) * n},
                "force_backward": {}, "parameter_backward": {}}
    K = chunk_layout(e_cap, cfg.edge_chunk)[2]
    so2, b1 = cfg.num_layers * K * cfg.num_experts * n, (1 + cfg.num_layers) * K * n
    return {"forward": {"so2_conv": so2, "segment_sum": b1},
            "force_backward": {"so2_conv": 2 * so2, "segment_sum": b1},
            "parameter_backward": {"so2_conv": 3 * so2, "segment_sum": b1}}


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


# [train-bf16]'s first step, the bf16 kernel route against the plain bf16
# route at MACE_BF16_KW: five card runs measured the gradient 1.6e-3 to
# 2.7e-3 apart (rel L2) and the loss 5.3e-5 to 4.5e-4 apart (rel; the plain
# route's index_add_ atomics move it run to run); the bars are ~4x the
# largest of each
BF16_TRAIN_GRAD_TOL = 1e-2
BF16_TRAIN_LOSS_TOL = 2e-3


def train_parity(torch, tag, model, params, batch, cfg, ref=None):
    """The same first step with ``kernels=True`` and ``kernels=False`` from
    one copy of the state. float32: loss terms within rel 1e-5 and the
    gradient vector within rel L2 1e-4 (both routes float32; the kernels
    sum in another order). bf16 (``ref``: the float32 model of the same
    widths): the kernel route no further from float32 than the plain route
    is, x 1.25 + 1e-3, in the loss and in the gradient (each bf16 route
    rounds the same fp32 sums at other bf16 ulps, which their distances
    from float32 measure, as PERF.md §6's bf16 bars), and beside that the
    kernel route against the plain bf16 route directly: the gradient within
    rel L2 BF16_TRAIN_GRAD_TOL and the loss within rel BF16_TRAIN_LOSS_TOL
    (the distance to float32 alone, ~0.11, would hide an added error of a
    few per cent). Returns the deltas."""
    comps_k, g_k = first_step(torch, model, params, batch, True, cfg)
    comps_p, g_p = first_step(torch, model, params, batch, False, cfg)
    out = {"loss_kernels": comps_k["loss"], "loss_plain": comps_p["loss"],
           "grad_rel_l2": rel_l2(g_k, g_p),
           "grad_norm": float(g_p.norm())}
    if not (torch.isfinite(g_k).all() and torch.isfinite(g_p).all()):
        raise AssertionError(f"[{tag}] non-finite first-step gradient: {out}")
    if ref is None:
        for k in ("loss", "energy", "force", "stress"):
            out[f"rel_d{k}"] = abs(comps_k[k] - comps_p[k]) / max(abs(comps_p[k]), 1e-30)
        bad = [k for k in ("loss", "energy", "force", "stress")
               if abs(comps_k[k] - comps_p[k]) > 1e-5 * abs(comps_p[k])]
        if bad or not out["grad_rel_l2"] < 1e-4:
            raise AssertionError(f"[{tag}] kernels vs plain, first step: {out}")
        return out
    from distmlip_tpu_torch.train import TrainConfig

    comps_32, g_32 = first_step(torch, ref, params, batch, False, TrainConfig())
    out.update(loss_float32=comps_32["loss"], grad_kernels_vs_float32=rel_l2(g_k, g_32),
               grad_plain_vs_float32=rel_l2(g_p, g_32))
    dl_k = abs(comps_k["loss"] - comps_32["loss"])
    dl_p = abs(comps_p["loss"] - comps_32["loss"])
    out.update(loss_kernels_vs_float32=dl_k, loss_plain_vs_float32=dl_p,
               loss_rel_kernels_vs_plain=abs(comps_k["loss"] - comps_p["loss"])
               / abs(comps_p["loss"]))
    if not (dl_k <= 1.25 * dl_p + 1e-3 * abs(comps_32["loss"])
            and out["grad_kernels_vs_float32"]
            <= 1.25 * out["grad_plain_vs_float32"] + 1e-3
            and out["grad_rel_l2"] <= BF16_TRAIN_GRAD_TOL
            and out["loss_rel_kernels_vs_plain"] <= BF16_TRAIN_LOSS_TOL):
        raise AssertionError(f"[{tag}] bf16 kernels vs plain, first step: {out}")
    return out


def timed_training(torch, tag, model, student, samples, cutoff, B, A, cfg, lk):
    """A ``Trainer`` on the card at micro-batch B and accumulation A (Adam
    at TRAIN_LR, bench.py's ``hbm_budget_frac`` 0.95): its measured step
    peak (``est_peak_bytes``), one warm step, then TRAIN_STEPS steps with
    every launch count set to 0 just before and the peak reset, counted by
    role. Returns the summary and the launches."""
    import functools

    import numpy as np

    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.train import TrainConfig, Trainer
    from distmlip_tpu_torch.train.step import param_leaves

    t0 = time.perf_counter()
    trainer = Trainer(model.energy_fn, student,
                      functools.partial(torch.optim.Adam, lr=TRAIN_LR), samples, cutoff,
                      micro_batch_size=B, config=TrainConfig(accum_steps=A, **cfg),
                      hbm_budget_frac=0.95, device="cuda", loader_kwargs=lk)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.fit(steps=1)  # warm
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    with RoleCounter(torch, launch_counts) as roles:
        t0 = time.perf_counter()
        hist = trainer.fit(steps=TRAIN_STEPS)[-TRAIN_STEPS:]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    skipped = sum(int(h["skipped"]) for h in trainer.history)
    masters = {p.dtype for p in param_leaves(trainer.state.params)
               + param_leaves(trainer.state.ema_params)}
    summary = {
        "micro_batch": B, "accum": A, "steps": TRAIN_STEPS,
        "n_atoms_per_step": B * A * len(samples[0].forces),
        "step_ms": [h["step_s"] * 1e3 for h in hist],
        "step_ms_median": statistics.median(h["step_s"] * 1e3 for h in hist),
        "examples_per_s": A * B * TRAIN_STEPS / dt,
        "first_step_s": first_s, "trainer_setup_s": setup_s,
        "max_memory_allocated_bytes": peak, "est_peak_bytes": trainer.est_peak_bytes,
        "tier_peak_bytes": trainer.tier_peak_bytes, "skipped": skipped,
        "e_cap": trainer.loader.caps.as_dict()["edges"],
        "loss": [h["loss"] for h in hist], "loss_scale": hist[-1]["loss_scale"],
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in nonzero(launches).items()},
        "launches_by_role": roles.nonzero(),
        "master_dtypes": sorted(str(d) for d in masters),
    }
    trainer.close()
    if skipped or not all(np.isfinite(h["loss"]) for h in trainer.history):
        raise AssertionError(f"[{tag}] a skipped or non-finite step: {summary}")
    if masters != {torch.float32}:
        raise AssertionError(f"[{tag}] master weights not fp32: {masters}")
    log(f"[{tag}] B {B} x A {A}: {json.dumps(summary)}")
    return summary, launches, roles


RESUME_TOL = 1e-5  # absolute, on weights of O(0.1-1): float32 roundoff of one step, ~lr / 100


def train_resume(torch, tag, model, student, samples, cutoff, lk):
    """Checkpoint after step 2, restore into a fresh ``Trainer``, take step
    3, and hold it to the unbroken run's step 3: master and EMA weights
    within RESUME_TOL absolute (on the card ``index_add_`` adds with
    atomics, so the two agree to roundoff, not bit for bit: measured
    2.4-4.8e-7), the loss within rel 1e-5, and the step, loss scale, its
    good-step count and the loader cursor equal. An Adam step moves an
    element by about lr = 1e-3, so a restore that kept the fresh weights or
    lost the moments lands near lr away; a third trainer that takes its
    step without the restore shows the bar tells the two apart."""
    import functools
    import tempfile

    from distmlip_tpu_torch.train import TrainConfig, Trainer
    from distmlip_tpu_torch.train.step import param_leaves

    def make(directory):
        return Trainer(model.energy_fn, student,
                       functools.partial(torch.optim.Adam, lr=TRAIN_LR), samples, cutoff,
                       micro_batch_size=4, config=TrainConfig(), hbm_budget_frac=0.95,
                       checkpoint_dir=directory, device="cuda", loader_kwargs=lk)

    def max_diff(a, b, name):
        return max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(
            param_leaves(getattr(a.state, name)), param_leaves(getattr(b.state, name))))

    def scalars(t):
        return [int(t.state.step), float(t.state.loss_scale), int(t.state.good_steps)]

    with tempfile.TemporaryDirectory() as d:
        t1 = make(d)
        t1.fit(steps=2)
        path = t1.save_checkpoint()
        t1.train_step()
        t2 = make(d)
        restored = t2.restore(path)
        t2.train_step()
        t3 = make(d)
        t3.train_step()  # the control: step 3 without the restore
        l1, l2 = t1.history[-1]["loss"], t2.history[-1]["loss"]
        out = {"restored_step": restored,
               "max_param_diff": max_diff(t1, t2, "params"),
               "max_ema_diff": max_diff(t1, t2, "ema_params"),
               "max_param_diff_unrestored": max_diff(t1, t3, "params"),
               "loss_step3": [l1, l2], "loss_rel_diff": abs(l1 - l2) / abs(l1),
               "step_scale_good": [scalars(t1), scalars(t2)],
               "cursor": [t1.loader.state(), t2.loader.state()], "tol": RESUME_TOL}
        for t in (t1, t2, t3):
            t.close()
    if (restored != 2 or out["cursor"][0] != out["cursor"][1]
            or out["step_scale_good"][0] != out["step_scale_good"][1]
            or not out["max_param_diff"] <= RESUME_TOL
            or not out["max_ema_diff"] <= RESUME_TOL
            or not out["loss_rel_diff"] <= 1e-5
            or not out["max_param_diff_unrestored"] > 10 * RESUME_TOL):
        raise AssertionError(f"[{tag}] resume: {out}")
    log(f"[{tag}] resume after step 2: {json.dumps(out)}")
    return out


def phase_train(torch, family):
    """``[train]`` (MACE at MACE_KW), ``[train-tensornet]``,
    ``[train-chgnet]``, ``[train-escn]`` and ``[train-bf16]`` (MACE at
    MACE_BF16_KW, ``precision="bf16"``, loss scale 2^15): bench.py's train
    set (8 x 108-atom Si) labelled by a teacher of the same architecture
    (seed 1) through ``BatchedPotential``; the student from seed 0, Adam
    1e-3. The first step with kernels against ``kernels=False``
    (``train_parity``); ``timed_training`` at micro-batch 4 (and for
    MACE also accumulation 4 at micro-batch 1, as bench.py), its launches
    by role held to ``train_expected``; MACE also ``train_resume``.
    Returns the timed runs' launches, and their launches by role."""
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.tools.workload import MACE_KW, train_samples
    from distmlip_tpu_torch.train import PackedBatchLoader, TrainConfig

    import numpy as np

    t_phase = time.perf_counter()
    tag = {"mace": "train", "mace-bf16": "train-bf16"}.get(family, f"train-{family}")
    model, student, teacher, info, cfg, lk = train_setup(torch, family)
    cutoff = float(model.cfg.cutoff)
    t0 = time.perf_counter()
    samples = train_samples(model, teacher, info)
    log(f"[{tag}] labels: {len(samples)} x {len(samples[0].forces)} atoms in "
        f"{time.perf_counter() - t0:.1f} s; max |F| {max(float(np.abs(s.forces).max()) for s in samples):.4g}")
    loader = PackedBatchLoader(samples, cutoff, micro_batch_size=4, shuffle=False, prefetch=0,
                               **lk)
    batch = loader.next_batch().to("cuda")
    loader.close()
    ref = MACE(MACEConfig(**MACE_KW)) if family == "mace-bf16" else None
    parity = train_parity(torch, tag, model, student, batch, TrainConfig(**cfg), ref)
    log(f"[{tag}] first step, kernels vs plain: {json.dumps(parity)}")
    del batch
    torch.cuda.empty_cache()
    total = {}
    roles_total = {r: {k: 0 for k in launch_counts} for r in RoleCounter.ROLES}
    runs = [(4, 1), (1, 4)] if family == "mace" else [(4, 1)]
    for B, A in runs:
        summary, launches, roles = timed_training(torch, tag, model, student, samples, cutoff,
                                                  B, A, cfg, lk)
        want = train_expected(family, model, summary["e_cap"], TRAIN_STEPS * A)
        if roles.nonzero() != want:
            raise AssertionError(f"[{tag}] launches by role {roles.nonzero()} differ from "
                                 f"the derivation {want}")
        log(f"[{tag}] B {B} x A {A}: launches by role as derived: {json.dumps(want)}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for r, counts in roles.roles.items():
            for k, v in counts.items():
                roles_total[r][k] += v
        torch.cuda.empty_cache()
    if family == "mace":
        train_resume(torch, tag, model, student, samples, cutoff, lk)
    log(f"[{tag}] {time.perf_counter() - t_phase:.1f} s")
    return total, roles_total


# ---------------------------------------------------------------------------
# telemetry and observability: records, spans, metrics, attribution
# ---------------------------------------------------------------------------

TELEMETRY_MD_STEPS = 10    # MolecularDynamics steps of each [telemetry] run
TELEMETRY_TIMED = 12       # interleaved warm calculates with and without the hub
TELEMETRY_DMD_STEPS = 20   # DeviceMD steps of each [telemetry] run, two chunks
ATTRIBUTION_TOL = 0.02     # custom_kernel against step_profile's own-kernel time


def telemetry_hub(tag):
    """A hub with an AggregatingSink and a JsonlSink under build/telemetry/,
    and a list the records also land in."""
    import os

    from distmlip_tpu_torch.telemetry import (AggregatingSink, JsonlSink, Telemetry,
                                              TelemetrySink)

    class Keep(TelemetrySink):
        def __init__(self):
            self.records = []

        def emit(self, record):
            self.records.append(record)

    os.makedirs(os.path.join("build", "telemetry"), exist_ok=True)
    path = os.path.join("build", "telemetry", f"{tag}.jsonl")
    keep = Keep()
    return Telemetry([AggregatingSink(), JsonlSink(path), keep]), keep, path


def check_calculate_records(tag, records, n_calls, n_atoms):
    """The fields a DistPotential record must carry on the card (a broken
    record is not swallowed: this fails the phase)."""
    import numpy as np

    if len(records) != n_calls:
        raise AssertionError(f"[{tag}] {len(records)} records for {n_calls} calculates")
    for r in records:
        mem = r.device_memory
        bad = [
            r.kind != "calculate", r.n_atoms != n_atoms, r.num_partitions != 1,
            not 0 < r.node_occupancy <= 1, not 0 < r.edge_occupancy <= 1,
            r.kernel_mode != "cuda", not 0 < r.kernel_coverage <= 1,
            not all(f"dev0_{k}" in mem for k in ("bytes_in_use", "peak_bytes_in_use",
                                                 "bytes_limit")),
            not 0 < r.mfu < 1, not r.flops_per_step > 0,
            not all(k in r.timings for k in ("neighbor_s", "partition_s", "device_s",
                                             "total_s")),
            not np.isfinite(list(r.timings.values())).all(),
            r.graph_reused == r.rebuild,
        ]
        if any(bad):
            raise AssertionError(f"[{tag}] record {r.step} fails check "
                                 f"{[i for i, b in enumerate(bad) if b]}: {r.to_json()}")
    if not (records[0].compiled and records[0].compile_kind == "fresh"
            and records[0].rebuild and not any(r.compiled for r in records[1:])):
        raise AssertionError(f"[{tag}] compile flags: "
                             f"{[(r.compiled, r.compile_kind) for r in records]}")


def deterministic_runs(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    bit-for-bit comparisons (``index_select``'s backward adds rows with
    atomics otherwise); yields the set of warnings about ops that have no
    deterministic version."""
    import contextlib
    import warnings

    @contextlib.contextmanager
    def ctx():
        was = torch.are_deterministic_algorithms_enabled()
        seen = set()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield seen
                seen.update(str(w.message).split("\n")[0][:160] for w in caught
                            if "deterministic" in str(w.message))
        finally:
            torch.use_deterministic_algorithms(was)
    return ctx()


def count_run_syncs(torch, fn):
    """Runs ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    counts the synchronizing CUDA calls it made; returns (result, count)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(SYNC_WORDS in str(w.message) for w in caught)


def phase_telemetry(torch):
    """``[telemetry]``: ``[md]``'s workload (MACE at MACE_KW on the 2048-atom
    crystal, skin 0.5, nvt_bussi at MACE_MD_TIMESTEP) for TELEMETRY_MD_STEPS
    steps without a hub and with one (AggregatingSink + JsonlSink), under
    deterministic algorithms: positions and velocities equal bit for bit,
    one record per calculate with its fields checked
    (``check_calculate_records``); then TELEMETRY_TIMED warm calculates with
    the hub attached and detached in turn (the step time each way) and the
    host cost of building and emitting one record; then ``DeviceMD`` for
    TELEMETRY_DMD_STEPS steps in two chunks without and with the hub: the
    same trajectory bit for bit, one ``md_chunk`` record a chunk, and at
    most one more sync a chunk with the hub. Launch counts from just before
    the first run to just after the last. Returns the launches and the warm
    potential with its structure."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DeviceMD, DistPotential, MolecularDynamics
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.telemetry import AggregatingSink, Telemetry, report
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    t_phase = time.perf_counter()
    model = MACE(MACEConfig(**MACE_KW))
    params = model.init(0)
    for k in launch_counts:
        launch_counts[k] = 0
    runs = {}
    with deterministic_runs(torch) as nondet:
        for hub in (False, True):
            atoms, rng = bench_atoms()
            atoms.set_maxwell_boltzmann_velocities(MD_KW["temperature"], rng=rng)
            tel, keep, path = telemetry_hub("md") if hub else (None, None, None)
            pot = DistPotential(model, params, device="cuda", skin=0.5)
            md = MolecularDynamics(atoms, pot, **{**MD_KW, "timestep": MACE_MD_TIMESTEP},
                                   telemetry=tel)
            md.run(TELEMETRY_MD_STEPS)
            runs[hub] = (atoms, pot, tel, keep, path)
    (a0, pot0, _, _, _), (a1, pot, tel, keep, path) = runs[False], runs[True]
    same = (np.array_equal(a0.positions, a1.positions)
            and np.array_equal(a0.velocities, a1.velocities))
    log(f"[telemetry] {TELEMETRY_MD_STEPS} MD steps with and without the hub, deterministic "
        f"algorithms: positions and velocities equal bit for bit: {same}; max |dx| "
        f"{float(np.abs(a0.positions - a1.positions).max()):.3e} Å; ops without a "
        f"deterministic version: {sorted(nondet)}")
    if not same:
        raise AssertionError("[telemetry] the run with a hub moved the atoms differently")
    check_calculate_records("telemetry", keep.records, pot._step_counter, len(a1))
    tel.close()
    rep = report.aggregate(report.read_jsonl(path))
    if rep.n_records != len(keep.records):
        raise AssertionError(f"[telemetry] the JSONL holds {rep.n_records} records")
    log("[telemetry] report of the JSONL:\n" + rep.render())
    del pot0, runs

    # the hub's cost on a warm step: attached and detached in turn
    tel2, keep2, _ = telemetry_hub("timed")
    rng = np.random.default_rng(5)
    ms = {False: [], True: []}
    for i in range(TELEMETRY_TIMED):
        for hub in ((False, True) if i % 2 else (True, False)):
            pot.telemetry = tel2 if hub else None
            a1.positions = a1.positions + rng.normal(0, 0.002, a1.positions.shape)
            t = time.perf_counter()
            pot.calculate(a1)
            ms[hub].append((time.perf_counter() - t) * 1e3)
    host = pot._cache[1]
    pot.telemetry = Telemetry([AggregatingSink()])
    t = time.perf_counter()
    for _ in range(200):
        pot._emit_record("calculate", host, 0.1, routes={"kernel": 0, "plain": 0})
    emit_us = (time.perf_counter() - t) / 200 * 1e6
    pot.telemetry = None
    # the record's parts: the device-memory snapshot (one nested allocator
    # query) against memory_allocated + max_memory_allocated, the FLOP model
    from distmlip_tpu_torch.utils.flops import model_flop_estimate
    from distmlip_tpu_torch.utils.memory import device_memory_stats

    def per_call_us(fn, n=200):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    parts_us = {
        "device_memory_stats": per_call_us(device_memory_stats),
        "memory_allocated+max_memory_allocated": per_call_us(
            lambda: (torch.cuda.memory_allocated(0), torch.cuda.max_memory_allocated(0))),
        "mem_get_info": per_call_us(lambda: torch.cuda.mem_get_info(0)),
        "model_flop_estimate": per_call_us(
            lambda: model_flop_estimate(model, len(a1), pot.last_stats["n_edges"])),
    }
    timed = {"step_ms_median_without_hub": median(ms[False]),
             "step_ms_median_with_hub": median(ms[True]),
             "hub_overhead_ms": median(ms[True]) - median(ms[False]),
             "record_host_us": emit_us, "record_parts_us": parts_us,
             "steps_each": TELEMETRY_TIMED,
             "mfu_median": median([r.mfu for r in keep2.records]),
             "flops_per_step": keep2.records[-1].flops_per_step,
             "device_s_median": median([r.timings["device_s"] for r in keep2.records]),
             "kernel_coverage": keep2.records[-1].kernel_coverage}
    log(f"[telemetry] warm step with and without the hub: {json.dumps(timed)}")
    if len(keep2.records) != TELEMETRY_TIMED:
        raise AssertionError(f"[telemetry] {len(keep2.records)} records for "
                             f"{TELEMETRY_TIMED} calculates with the hub")

    # DeviceMD: chunk records at the chunk end, no sync inside the chunk
    dmd = {}
    with deterministic_runs(torch):
        for hub in (False, True):
            atoms, rng = bench_atoms()
            atoms.set_maxwell_boltzmann_velocities(MD_KW["temperature"], rng=rng)
            tel3, keep3, _ = telemetry_hub("device_md") if hub else (None, None, None)
            p = DistPotential(model, params, device="cuda", skin=0.5)
            md = DeviceMD(p, atoms, timestep=MACE_MD_TIMESTEP, telemetry=tel3)
            syncs = 0
            for n in (TELEMETRY_DMD_STEPS // 2, TELEMETRY_DMD_STEPS - TELEMETRY_DMD_STEPS // 2):
                _, c = count_run_syncs(torch, lambda n=n: md.run(n))
                syncs += c
            dmd[hub] = {"atoms": atoms, "syncs_in_run": syncs, "host_reads": md.host_reads,
                        "refreshes": md.rebuilds_on_device,
                        "records": keep3.records if hub else None}
            del p, md
    d0, d1 = dmd[False], dmd[True]
    same = np.array_equal(d0["atoms"].positions, d1["atoms"].positions)
    recs = d1["records"]
    summary = {k: [d0[k], d1[k]] for k in ("syncs_in_run", "host_reads", "refreshes")}
    summary.update(same_positions=same, md_chunk_records=len(recs),
                   steps_in_records=[r.extra.get("steps_done") for r in recs])
    log(f"[telemetry] DeviceMD without / with the hub (syncs counted over each whole "
        f"run() call, chunk starts and ends included): {json.dumps(summary)}")
    if not (same and d1["host_reads"] == d0["host_reads"]
            and d1["syncs_in_run"] <= d0["syncs_in_run"] + len(recs) and len(recs) >= 2
            and all(r.kind == "md_chunk" for r in recs)
            and sum(r.extra["steps_done"] for r in recs) == TELEMETRY_DMD_STEPS
            and all(r.kernel_mode == "cuda" and r.device_memory for r in recs)):
        raise AssertionError(f"[telemetry] DeviceMD with the hub: {summary}")
    launches = dict(launch_counts)
    log(f"[telemetry] launches {nonzero(launches)}; phase {time.perf_counter() - t_phase:.1f} s")
    if not launches["segment_sum"]:
        raise AssertionError("[telemetry] B1 was not launched")
    return launches, pot, a1, timed


def phase_telemetry_serve(torch):
    """``[telemetry-serve]``: ``ServeEngine(BatchedPotential(MACE), fallback=
    DistPotential(MACE), max_batch=8)`` with a telemetry hub and the obs hub
    installed (tracer, metrics, an SLO and the flight recorder under
    build/telemetry/): two bursts of the 8-structure pool and the 2048-atom
    crystal on the fallback lane. Every request trace must be complete (one
    terminal each), the metrics scraped over HTTP from localhost must parse
    and count every completion, and each batch must leave a ``serve_batch``
    record beside the potential's ``batched_calculate`` one."""
    import urllib.request

    from distmlip_tpu_torch import obs
    from distmlip_tpu_torch.calculators import BatchedPotential, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.serve import ServeEngine
    from distmlip_tpu_torch.tools.workload import batched_pool, bench_atoms

    t_phase = time.perf_counter()
    model, params, _, _, _, _ = batched_family(torch, "mace")
    pool, _ = batched_pool(8, seed=4)
    big = bench_atoms()[0]
    tel, keep, path = telemetry_hub("serve")
    hub = obs.Observability.enable(slo=obs.SLOConfig(latency_s=30.0),
                                   flight_dir="build/telemetry/incidents")
    server = obs.MetricsServer(hub.metrics, port=0)
    try:
        for k in launch_counts:
            launch_counts[k] = 0
        engine = ServeEngine(BatchedPotential(model, params, device="cuda", skin=0.5),
                             fallback=DistPotential(model, params, device="cuda", skin=0.5),
                             max_batch=8, max_wait_s=0.005, admission="block",
                             max_batch_atoms=SERVE_MAX_BATCH_ATOMS, telemetry=tel,
                             start=False)
        futs = [engine.submit(a) for a in pool]
        engine.start()
        futs += [engine.submit(a) for a in pool + [big]]
        results = [f.result(timeout=600) for f in futs]
        if not engine.drain(timeout=600):
            raise AssertionError("[telemetry-serve] drain() timed out")
        engine.close()
        launches = dict(launch_counts)
        for r, a in zip(results, pool + pool + [big]):
            check_result(r, len(a))
        with urllib.request.urlopen(server.url, timeout=30) as resp:
            scraped = obs.parse_exposition(resp.read().decode())
        spans = hub.tracer.spans()
        trace = obs.request_trace_summary(spans)
        paths = obs.critical_path_summary(spans)
    finally:
        server.close()
        obs.uninstall()
    tel.close()
    n = len(futs)
    serve_recs = [r for r in keep.records if r.kind in ("serve_batch", "serve_fallback")]
    batch_recs = [r for r in keep.records if r.kind == "batched_calculate"]
    summary = {
        "requests": n, "trace": trace, "coverage_p50": paths.get("coverage_p50"),
        "critical_path_ms_p50": {k: v["p50"] * 1e3 for k, v in paths["components"].items()},
        "completed_metric": scraped.get("distmlip_serve_completed_total"),
        "batches_metric": scraped.get("distmlip_serve_batches_total"),
        "slo": hub.slo.snapshot(), "serve_records": len(serve_recs),
        "batched_records": len(batch_recs),
        "batch_sizes": [r.batch_size for r in serve_recs],
        "kernel_modes": sorted({r.kernel_mode for r in batch_recs}),
        "launches": nonzero(launches),
    }
    log(f"[telemetry-serve] {json.dumps(summary)}")
    served = sum(r.batch_size for r in serve_recs)
    if not (trace["requests"] == n and trace["complete"] == n
            and trace["terminal_violation_count"] == 0
            and summary["completed_metric"] == n and served == n
            and len(batch_recs) == sum(r.kind == "serve_batch" for r in serve_recs)
            and summary["kernel_modes"] == ["cuda"]
            and hub.slo.snapshot()["engine"]["good"] == n
            and all(r.trace_id for r in serve_recs) and launches["segment_sum"]):
        raise AssertionError(f"[telemetry-serve] {summary}")
    log(f"[telemetry-serve] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def profile_step(torch, pot, atoms, rng, tag):
    """One warm calculate (skin-cache hit) of ``pot`` under a CPU + CUDA
    ``torch.profiler`` capture; the Chrome trace through ``obs.attribution``
    and ``step_profile.device_split``, whose own-kernel device time (from
    ``key_averages``) the ``custom_kernel`` bucket must match within
    ATTRIBUTION_TOL. Returns the summary."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.obs import attribution
    from distmlip_tpu_torch.tools.step_profile import device_split

    out_dir = os.path.join("build", "telemetry", tag)
    os.makedirs(out_dir, exist_ok=True)
    atoms.positions = atoms.positions + rng.normal(0, 0.002, atoms.positions.shape)
    pot.calculate(atoms)  # warm, outside the capture
    atoms.positions = atoms.positions + rng.normal(0, 0.002, atoms.positions.shape)
    builds = pot.rebuild_count
    before = dict(launch_counts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    launched = {k: v - before[k] for k, v in launch_counts.items() if v != before[k]}
    split = device_split(torch, prof, wall_s, out_dir)
    bd = attribution.attribute_trace(os.path.join(out_dir, "step_profile_warm.json"),
                                     program=tag)
    kernel_ms = bd.by_category.get("custom_kernel", 0.0) * 1e3
    out = {"wall_ms": split["wall_ms"], "device_ms": split["device_ms"],
           "attributed_ms": bd.total_s * 1e3, "custom_kernel_ms": kernel_ms,
           "custom_kernel_share": bd.fraction("custom_kernel"),
           "step_profile_own_kernels_ms": split["own_kernels_ms"],
           "own_kernels": split["own_kernels"],
           "by_category_ms": split["by_category_ms"], "by_layer_ms": split["by_layer_ms"],
           "launches": launched, "n_events": bd.n_events}
    log(f"[attribution] {tag}: {json.dumps(out)}")
    log(f"[attribution] {tag}:\n{bd.render(top_scopes=12)}")
    if pot.rebuild_count != builds:
        raise AssertionError(f"[attribution] {tag}: the profiled step rebuilt the graph")
    own = split["own_kernels_ms"]
    if not (own > 0 and abs(kernel_ms - own) <= ATTRIBUTION_TOL * own):
        raise AssertionError(f"[attribution] {tag}: custom_kernel {kernel_ms:.4f} ms against "
                             f"step_profile's {own:.4f} ms")
    if abs(bd.total_s * 1e3 - split["device_ms"]) > ATTRIBUTION_TOL * split["device_ms"]:
        raise AssertionError(f"[attribution] {tag}: attributed {bd.total_s * 1e3:.3f} ms of "
                             f"{split['device_ms']:.3f} ms of device time")
    return out


def phase_attribution(torch, mace_pot, mace_atoms):
    """``[attribution]``: one warm step of ``[telemetry]``'s MACE potential
    and one of eSCN at ESCN_KW on the 2048-atom crystal (ESCN_INFO), each
    under the profiler (``profile_step``): the ``custom_kernel`` bucket must
    hold B1 on MACE and B1 and B3 on eSCN, and each layer scope must carry
    device time. Launch counts: the two profiled steps (and eSCN's warm
    calculates). Returns the launches and the summaries."""
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import ESCN, ESCNConfig
    from distmlip_tpu_torch.tools.workload import ESCN_INFO, ESCN_KW, bench_atoms

    t_phase = time.perf_counter()
    for k in launch_counts:
        launch_counts[k] = 0
    rng = np.random.default_rng(11)
    mace = profile_step(torch, mace_pot, mace_atoms, rng, "mace")
    model = ESCN(ESCNConfig(**ESCN_KW))
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5)
    atoms = bench_atoms()[0]
    atoms.info = dict(ESCN_INFO)
    pot.calculate(atoms)
    escn = profile_step(torch, pot, atoms, rng, "escn")
    launches = dict(launch_counts)
    want = {"mace": ({"segment_sum"}, ("mace/interaction0", "mace/interaction1")),
            "escn": ({"segment_sum", "so2_conv"}, ("escn/layer0", "escn/layer1"))}
    for tag, got in (("mace", mace), ("escn", escn)):
        kernels, layers = want[tag]
        if set(got["launches"]) != kernels or not all(
                got["by_layer_ms"].get(layer, 0.0) > 0 for layer in layers):
            raise AssertionError(f"[attribution] {tag}: launches {got['launches']}, layers "
                                 f"{got['by_layer_ms']}")
    log(f"[attribution] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, {"mace": mace, "escn": escn}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    from distmlip_tpu_torch.device import resolve_device
    from distmlip_tpu_torch.kernels import build

    t_start = time.perf_counter()
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    uuid = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[env] {smi}; {uuid}; host {socket.gethostname()}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"[env] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    seconds = build.build()
    for name, s in seconds.items():
        log(f"[build] {name}: {s:.2f} s")
        with open(build.library_path(name)[:-3] + ".log") as f:
            for line in f:
                if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                    log(f"[build]   {line.strip()}")

    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)

    phase_host_graph(torch)
    max_err, timed, sweep = phase_kernels(torch)
    bf16_err, bf16_timed, bf16_sweep = phase_kernels_bf16(torch)
    edge_errs, edge_timed = phase_edge_aggregate_kernels(torch)
    chg_errs, chg_timed, proj_err, proj_timed = phase_chgnet_kernels(torch)
    so2_err, so2_timed, seg_escn = phase_so2_kernels(torch)
    so2_bf16_err, so2_bf16_timed = phase_so2_kernels_bf16(torch)
    tn_bf16_errs, tn_bf16_timed = phase_edge_aggregate_kernels_bf16(torch)
    seg_escn_md = phase_segment_sum_escn_md(torch)
    (chg_bf16_errs, chg_bf16_timed, chg_bf16_proj_err,
     chg_bf16_proj_timed) = phase_chgnet_kernels_bf16(torch)
    # the packing's gather tables of the shapes above: each path below
    # counts only its own in its peak memory
    from distmlip_tpu_torch.kernels import so3
    so3._pack_index.cache_clear()
    torch.cuda.empty_cache()
    launches = phase_main_path(torch)
    torch.cuda.empty_cache()
    zbl_launches, zbl_width1 = phase_main_zbl(torch)
    torch.cuda.empty_cache()
    tn_launches = phase_tensornet(torch)
    torch.cuda.empty_cache()
    chg_launches = phase_chgnet(torch)
    torch.cuda.empty_cache()
    escn_launches = phase_escn(torch)
    torch.cuda.empty_cache()
    bf16_launches = phase_main_bf16(torch, "mace")
    torch.cuda.empty_cache()
    escn_bf16_launches = phase_main_bf16(torch, "escn")
    torch.cuda.empty_cache()
    tn_bf16_launches = phase_main_bf16(torch, "tensornet")
    torch.cuda.empty_cache()
    chg_bf16_launches = phase_main_bf16(torch, "chgnet")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    uma_launches = phase_uma(torch)
    log(f"[uma] both phases: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    convert_launches = phase_convert(torch)
    log(f"[convert] {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    phase_small_reference(torch, MACE(MACEConfig(
        num_species=4, channels=16, l_max=3, a_lmax=3, hidden_lmax=1, correlation=3,
        cutoff=4.0, edge_chunk=64, node_chunk=16)), "small")
    phase_small_reference(torch, TensorNet(TensorNetConfig(
        num_species=4, units=16, num_rbf=8, cutoff=4.0)), "small-tensornet")
    # fcc at a = 3.5 (nn 2.47 Å) rattled by 0.1 Å: bonds within 2.6 Å, and
    # skin-shell edges and bonds with the 0.5 Å skin
    phase_small_reference(torch, CHGNet(CHGNetConfig(
        num_species=4, units=16, num_rbf=6, num_blocks=3, cutoff=3.2, bond_cutoff=2.6)),
        "small-chgnet", small_structure(3.5, 0.1, 4), skin=0.5, compute_magmom=True)
    small_escn_atoms = small_structure(3.5, 0.1, 4)
    small_escn_atoms.info = {"charge": 1, "spin": 2, "dataset": 3}
    phase_small_reference(torch, ESCN(ESCNConfig(
        num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6, num_experts=4,
        cutoff=3.2, avg_num_neighbors=12.0, edge_chunk=256)), "small-escn",
        small_escn_atoms, skin=0.5)
    torch.cuda.empty_cache()
    md_launches = phase_md(torch)
    torch.cuda.empty_cache()
    md_tn_launches = phase_md_tensornet(torch)
    torch.cuda.empty_cache()
    relax_launches = phase_relax_chgnet(torch)
    torch.cuda.empty_cache()
    md_bf16_launches = phase_md_bf16(torch)
    torch.cuda.empty_cache()
    md_tn_bf16_launches = phase_md_tensornet_bf16(torch)
    torch.cuda.empty_cache()
    relax_bf16_launches = phase_relax_chgnet(torch, bf16=True)
    md_launches = {k: md_launches[k] + md_tn_launches[k] + relax_launches[k]
                   + md_bf16_launches[k] + md_tn_bf16_launches[k] + relax_bf16_launches[k]
                   for k in md_launches}
    # the device-resident MD loop and the ensemble: each phase counts its own
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dmd_tn_launches = phase_device_md(torch)
    torch.cuda.empty_cache()
    dmd_mace_launches = phase_device_md_mace(torch)
    device_md_launches = {k: dmd_tn_launches[k] + dmd_mace_launches[k] for k in md_launches}
    torch.cuda.empty_cache()
    ensemble_launches = phase_ensemble(torch)
    log(f"[device-md] [device-md-mace] [ensemble]: {time.perf_counter() - t_phase:.1f} s")
    # training: each phase counts its own timed steps' launches, by role too
    t_phase = time.perf_counter()
    train_launches = {k: 0 for k in md_launches}
    train_roles = {r: {k: 0 for k in md_launches} for r in RoleCounter.ROLES}
    for family in ("mace", "tensornet", "chgnet", "escn", "mace-bf16"):
        torch.cuda.empty_cache()
        launched, roles = phase_train(torch, family)
        for k, v in launched.items():
            train_launches[k] += v
        for r, counts in roles.items():
            for k, v in counts.items():
                train_roles[r][k] += v
    log(f"[train*]: {time.perf_counter() - t_phase:.1f} s")
    # slab graph parallelism: each phase counts its own launches
    par_launches, par_errs = {k: 0 for k in md_launches}, {}
    for phase in (phase_parallel_tensornet, phase_parallel_chgnet, phase_parallel_mace,
                  phase_parallel_escn, lambda t: phase_parallel_bf16(t, "tensornet"),
                  lambda t: phase_parallel_bf16(t, "chgnet")):
        torch.cuda.empty_cache()
        launched, errs = phase(torch)
        for k, v in launched.items():
            par_launches[k] += v
        for k, v in errs.items():
            par_errs[k] = max(par_errs.get(k, 0.0), v)
    torch.cuda.empty_cache()
    for k, v in phase_parallel_md(torch).items():
        par_launches[k] += v
    # the batched engine and serving: each phase counts its own launches
    bat_launches, bat_errs = {k: 0 for k in md_launches}, {}
    for family in ("mace", "tensornet", "chgnet", "escn"):
        torch.cuda.empty_cache()
        launched, errs = phase_batched(torch, family)
        for k, v in launched.items():
            bat_launches[k] += v
        for k, v in errs.items():
            bat_errs[k] = max(bat_errs.get(k, 0.0), v)
    for phase in (lambda t: phase_batched_bf16(t, "mace"),
                  lambda t: phase_batched_bf16(t, "tensornet"),
                  lambda t: phase_batched_bf16(t, "chgnet"), phase_batched_md,
                  phase_batched_relax, phase_serve):
        torch.cuda.empty_cache()
        for k, v in phase(torch).items():
            bat_launches[k] += v
    # telemetry and observability: each phase counts its own launches
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tel_launches, tel_pot, tel_atoms, _ = phase_telemetry(torch)
    torch.cuda.empty_cache()
    for k, v in phase_telemetry_serve(torch).items():
        tel_launches[k] += v
    torch.cuda.empty_cache()
    attr_launches, _ = phase_attribution(torch, tel_pot, tel_atoms)
    for k, v in attr_launches.items():
        tel_launches[k] += v
    del tel_pot
    log(f"[telemetry] [telemetry-serve] [attribution]: {time.perf_counter() - t_phase:.1f} s")

    headline = timed[-1]  # the (32768, 40, 128) chunk of interaction 1
    kernels = [{
        "name": "segment_sum", "route": "cuda", "source": SOURCES["segment_sum"],
        "replaces": REPLACES["segment_sum"], "launches": launches["segment_sum"],
        "max_abs_err": max_err, "ms": headline["ms"], "kernel_ms": headline["kernel_ms"],
        "host_us": headline["host_us"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "library_kernel_ms": headline["library_kernel_ms"], "shape": headline["shape"],
        # MACE's two chunk shapes, eSCN's row width and the width-1 ZBL sum on
        # the crystal graph, then the width sweep on one chunk's ids and mask
        "per_shape": timed + [seg_escn, zbl_width1, seg_escn_md["float32"]],
        "width_sweep": sweep, "escn_launches": escn_launches["segment_sum"],
        # ESCNMD at the UMA-S widths ([uma]): its launches, its row shape
        "uma_launches": uma_launches["uma"]["segment_sum"],
        "escn_md_case": seg_escn_md["float32"],
        # MACE with zbl=True: its launches, and the width-1 pair-term call
        "zbl_launches": zbl_launches["segment_sum"], "zbl_width1": zbl_width1,
    }]
    for which in ("embed", "interaction"):
        name = f"tensornet_{which}_aggregate"
        t = edge_timed[which]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": tn_launches[name],
            "max_abs_err": edge_errs[which], "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "host_us": t["host_us"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": [t["e"], 3, 3, t["channels"]], "n_segments": t["n_segments"],
        })
    name, t = "tensornet_interaction_backward", edge_timed["backward"]
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": tn_launches[name], "max_abs_err": edge_errs["backward"], "ms": t["ms"],
        "kernel_ms": t["kernel_ms"], "host_us": t["host_us"], "plain_ms": t["plain_ms"], "plain": t["plain"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "library": t["library"],
        "shape": [t["e"], t["channels"], 3], "n_node": t["n_node"], "sort_ms": t["sort_ms"],
    })
    for which, name in (("atom", "chgnet_atom_conv_aggregate"),
                        ("line", "chgnet_line_aggregate")):
        t = chg_timed[which]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": chg_launches[name],
            "max_abs_err": chg_errs[which], "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "host_us": t["host_us"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": [t["e"], t["channels"]], "hidden": t["hidden"],
            "valid_edges": t["valid_edges"], "n_segments": t["n_segments"],
            "projection_ms": t["projection_ms"],
        })
    name = "chgnet_row_projection"
    t = max(proj_timed, key=lambda p: p["shape"][0])  # the line conv's bond table
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": chg_launches[name], "max_abs_err": proj_err, "ms": t["ms"],
        "kernel_ms": t["kernel_ms"], "host_us": t["host_us"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "library_kernel_ms": t["library_kernel_ms"],
        "library": t["library"], "shape": t["shape"], "per_shape": proj_timed,
    })
    kernels.append({
        "name": "so2_conv", "route": "cuda", "source": SOURCES["so2_conv"],
        "replaces": REPLACES["so2_conv"], "launches": escn_launches["so2_conv"],
        "max_abs_err": so2_err, "ms": so2_timed["ms"], "plain_ms": so2_timed["plain_ms"],
        "bound_ms": so2_timed["bound_ms"], "bound_by": so2_timed["bound_by"],
        "library_ms": so2_timed["library_ms"], "library": so2_timed["library"],
        "shape": [so2_timed["e"], so2_timed["s"], so2_timed["channels"]],
        "bound_route": so2_timed["bound_route"],
        "bound_ms_fp32_cores": so2_timed["bound_ms_fp32_cores"],
        "backward_ms": so2_timed["backward_ms"], "pack_ms": so2_timed["pack_ms"],
        "kernel_ms": so2_timed["kernel_ms"], "host_us": so2_timed["host_us"],
    })
    headline = bf16_timed[1]  # the (32768, 40, 128) chunk of interaction 1, bf16 rows
    kernels.append({
        "name": "segment_sum_bf16", "route": "cuda", "source": SOURCES["segment_sum_bf16"],
        "replaces": REPLACES["segment_sum_bf16"],
        "launches": bf16_launches["segment_sum_bf16"],
        "max_abs_err": bf16_err, "ms": headline["ms"], "kernel_ms": headline["kernel_ms"],
        "host_us": headline["host_us"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "library_kernel_ms": headline["library_kernel_ms"],
        "library": "index_add_ of the masked rows upcast to float32",
        "shape": headline["shape"], "per_shape": bf16_timed + [seg_escn_md["bfloat16"]],
        "width_sweep": bf16_sweep, "escn_launches": escn_bf16_launches["segment_sum_bf16"],
        "uma_launches": uma_launches["uma-bf16"]["segment_sum_bf16"],
        "escn_md_case": seg_escn_md["bfloat16"],
    })
    t = so2_bf16_timed
    kernels.append({
        "name": "so2_conv_bf16", "route": "cuda", "source": SOURCES["so2_conv_bf16"],
        "replaces": REPLACES["so2_conv_bf16"], "launches": escn_bf16_launches["so2_conv_bf16"],
        "max_abs_err": so2_bf16_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": t["library"], "shape": [t["e"], t["s"], t["channels"]],
        "bound_route": t["bound_route"], "backward_ms": t["backward_ms"],
        "pack_ms": t["pack_ms"], "kernel_ms": t["kernel_ms"], "host_us": t["host_us"],
    })
    for which, name in (("embed", "tensornet_embed_aggregate_bf16"),
                        ("interaction", "tensornet_interaction_aggregate_bf16"),
                        ("backward", "tensornet_interaction_backward_bf16")):
        t = tn_bf16_timed[which]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": tn_bf16_launches[name], "max_abs_err": tn_bf16_errs[which],
            "ms": t["ms"], "kernel_ms": t["kernel_ms"], "host_us": t["host_us"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": [t["e"], t["channels"]], "valid_edges": t["valid_edges"],
            # the forwards: the wrapper's host µs by part, and the
            # interaction's L2 gather rate (measured in this run)
            **{k: t[k] for k in ("host_split_us", "l2_gather_tb_s") if k in t},
        })
    for which, name in (("atom", "chgnet_atom_conv_aggregate_bf16"),
                        ("line", "chgnet_line_aggregate_bf16")):
        t = chg_bf16_timed[which]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": chg_bf16_launches[name], "max_abs_err": chg_bf16_errs[which],
            "ms": t["ms"], "kernel_ms": t["kernel_ms"], "host_us": t["host_us"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": [t["e"], t["channels"]], "hidden": t["hidden"],
            "valid_edges": t["valid_edges"], "projection_ms": t["projection_ms"],
            "float32_kernel": t["float32_kernel"], "float32_bar_ratio": t["float32_bar_ratio"],
            "host_split_us": t["host_split_us"],
        })
    name = "chgnet_row_projection_bf16"
    t = max(chg_bf16_proj_timed, key=lambda p: p["shape"][0])  # the bond table
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": chg_bf16_launches[name], "max_abs_err": chg_bf16_proj_err, "ms": t["ms"],
        "kernel_ms": t["kernel_ms"], "host_us": t["host_us"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library_kernel_ms": t["library_kernel_ms"], "library": t["library"],
        "shape": t["shape"], "per_shape": chg_bf16_proj_timed,
    })
    for k in kernels:  # each kernel's launches in [md], [md-tensornet], [relax-chgnet]
        k["md_launches"] = md_launches[k["name"]]
        # ... in the [parallel-*] phases, and its worst error against its
        # plain version on the flattened graphs' segments (where checked)
        k["parallel_launches"] = par_launches[k["name"]]
        k["parallel_segments_max_abs_err"] = par_errs.get(k["name"])
        # ... in the [batched-*] and [serve] phases, and its worst error
        # against its plain version on the packed graphs (where checked)
        k["batched_launches"] = bat_launches[k["name"]]
        k["batched_packed_max_abs_err"] = bat_errs.get(k["name"])
        # ... in [convert]'s three converted models
        k["convert_launches"] = convert_launches[k["name"]]
        # ... in the DeviceMD runs of [device-md] and [device-md-mace], and in
        # [ensemble]'s stacked and sequential calculates
        k["device_md_launches"] = device_md_launches[k["name"]]
        k["ensemble_launches"] = ensemble_launches[k["name"]]
        # ... in the [train*] phases' timed steps, and by the part of the
        # step that launched it (RoleCounter)
        k["train_launches"] = train_launches[k["name"]]
        k["train_launches_by_role"] = {r: c[k["name"]] for r, c in train_roles.items()}
        # ... in [telemetry], [telemetry-serve] and [attribution]
        k["telemetry_launches"] = tel_launches[k["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
