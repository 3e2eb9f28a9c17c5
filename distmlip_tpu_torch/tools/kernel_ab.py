"""Time the segment sum (B1), the TensorNet kernels, the CHGNet row
projection, the CHGNet convs and the SO(2) convolution (B3) of one checkout
on the card, at the shapes the main paths give them, split three ways.

    python distmlip_tpu_torch/tools/kernel_ab.py [--root DIR] [--label L]
        [--out FILE] [--steps N]

``--root`` names the checkout whose ``distmlip_tpu_torch`` is imported (by
default the one holding this file), so one process per checkout, in turns
(parent, change, change, parent), compares two commits on one card; the
kernels build from that checkout's sources into its own ``build/``. For
each shape it prints one JSON line:

- ``ms``: the call, CUDA events around 20 back-to-back calls
  (``cuda_ms``, which ``chip_smoke.py`` times every kernel with). When the host enqueues more slowly than the
  card runs, this is host time;
- ``kernel_ms``: the kernel alone, ``torch.profiler``'s device time of the
  kernels whose name holds the kernel's own (``device_ms``: every kernel the
  call launched, per call);
- ``host_us``: host microseconds per call, the host clock over 200 calls
  with no sync between them;
- the same for one PyTorch call that computes the same function
  (``index_add_`` of the masked rows; ``addmm``, on bf16 rows with a
  float32 output; B3: the five cuBLAS products on pre-packed operands):
  ``library_ms``, ``library_kernel_ms``, ``library_host_us``.

Shapes: B1 at width 1 on the crystal graph of the MACE path (2048 Si,
cutoff 5 Å, skin 0.5: its own dst ids and mask, the pair term's sum with
``zbl=True``; and the same cut at its last valid edge), at MACE's two edge-chunk shapes (32768, 16 x 128) and
(32768, 40 x 128) and eSCN's (32768, 25 x 128), each chunk with ~47 edges
a row, a 3000-edge padding tail and 200 masked edges, in float32 and on
bf16 rows (with ``bound_ms``, the bytes bound at the rows' element size,
and the checkout's bf16 ``plan`` where it has one); the row projection at
CHGNet's atom tables (19,712, 64) @ (64, 128) and (64, 256) and its bond
table (236,032, 64) @ (64, 256), on float32 rows and on bf16 rows (with
bf16 packed blocks when the checkout's ``chgnet_projection_plan`` takes a
``dtype``, the tensor-core kernel's; float32 blocks otherwise, as an older
checkout's bf16 projection took them); B3 at eSCN's chunk (32768, 25, 128),
l_max 4, in float32 and bf16, forward and on the backward's route (the
transposed weight set, ``backward_ms`` and ``backward_kernel_ms``), on
weights packed once. ``chip_smoke.py`` imports ``cuda_ms``,
``slice_case``, ``split``, ``library_split`` and
``projection_library_call`` from here, so its ``[kernels]`` lines time the
same cases the same ways.

The CHGNet atom and line convs at the CHGNet path's graph (16,384 atoms,
its real ids and masks; random rows and weights at C = H = 64), float32
and bf16: ``ms``, ``kernel_ms`` (the per-edge kernel alone), ``host_us``.
The TensorNet embed, interaction and interaction backward at the TensorNet
path's graph (16,384 atoms, its real ids, src ids and mask; random inputs
at C = 64), float32 and bf16, each bf16 row with the checkout's ``plan``
where it has one; the backward through its wrapper (the src
sort and CSR offsets included) and as its C launch alone on the sorted
edges (``no_sort_ms``), with ``bound_ms``.
Every row of the ``segment_sum`` and ``tensornet`` groups prints
``digest``, the sha256 of its output bytes on the fixed-seed inputs, so two
checkouts' outputs compare bit for bit.
``--kernels`` picks groups of rows (``segment_sum``, ``tensornet``,
``projection``, ``so2``, ``chgnet_conv``; all by default).

``--steps N`` times, in place of the kernels, the eSCN and CHGNet main
paths end to end (``--families`` picks them), in bfloat16 and in float32,
as ``chip_smoke.py``'s ``[main-escn-bf16]`` and ``[main-chgnet-bf16]``
build them (the same structures, seeds and readout terms; ``DistPotential``
with the checkout's kernels): one calculate that builds the graph, then N
MD-like calculates (``step_ms``, host clock to the card's sync, and their
median), then one under ``torch.profiler`` (its kernels' device ms and the
top ops by device and by host time). The family ``relax`` is
``[relax-chgnet]`` and ``[relax-chgnet-bf16]``: 30 FIRE steps with the cell
on 864 Li, each calculate a host rebuild (``calculate_ms`` and their
median). Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import time


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events around
    ``iters`` back-to-back calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters=200, warmup=5):
    """Host microseconds per call over ``iters`` calls with no sync between
    them (the card's queue absorbs the launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_split(torch, fn, key=None, iters=20, tries=2):
    """(ms per call of the kernels whose name holds ``key``, ms per call of
    every kernel) under ``torch.profiler``; ``key`` None gives the total
    twice. A window in which the profiler recorded no device time at all
    (it sometimes drops one) is profiled again, up to ``tries`` times, then
    reads (None, None): not measured, never 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
        if total > 0:
            own = (total if key is None else
                   sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3 / iters)
            return own, total
    return None, None


def split(torch, fn, key):
    own, total = device_split(torch, fn, key)
    return {"ms": cuda_ms(torch, fn), "kernel_ms": own, "device_ms": total,
            "host_us": host_us(torch, fn)}


def library_split(torch, fn):
    own, _ = device_split(torch, fn)
    return {"library_ms": cuda_ms(torch, fn), "library_kernel_ms": own,
            "library_host_us": host_us(torch, fn)}


def digest(*tensors):
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def segment_sum_bytes(data, ids, mask, n):
    """Bytes B1 must move: each valid data row read once (masked rows need
    not be read), ids and mask read once, the output written once."""
    e, w, es = data.shape[0], data[0].numel(), data.element_size()
    n_valid = int(mask.sum())
    return n_valid * w * es + e * ids.element_size() + e + n * w * es


def interaction_backward_cost(torch, f, src, ids, mask, n_node):
    """(bytes, operations) of TensorNet's interaction backward: f of each
    valid edge read, d f of every edge written, each gathered g row and x
    row read once, d x written, src, dst ids and mask read; per valid
    (edge, channel) 8 adds for t, u, v, 10 multiply-adds into d x and
    1 + 5 + 11 for d f's three columns."""
    e, c, es = f.shape[0], f.shape[1], f.element_size()
    n_valid = int(mask.sum())
    n_src = int(torch.unique(src[mask]).numel())
    n_dst = int(torch.unique(ids[mask]).numel())
    nbytes = ((n_valid * 3 * c + e * 3 * c + n_dst * 9 * c + n_src * 10 * c
               + n_node * 10 * c) * es + e * (src.element_size() + ids.element_size() + 1))
    return nbytes, n_valid * c * (8 + 20 + 17)


def slice_case(torch, gen, e, trailing, n_rows=2560, per_row=47, pad=3000,
               interior_masked=200):
    """dst-sorted ids as one edge chunk of the main path: ~47 edges a dst
    row over a contiguous block of rows, a repeated-tail padding block (mask
    false), some masked interior rows."""
    real = e - pad
    rows = -(-real // per_row)
    ids = torch.sort(torch.randint(0, rows, (real,), generator=gen,
                                   device="cuda"))[0] + (n_rows - rows) // 2
    ids = torch.cat([ids, ids[-1:].expand(pad)]).to(torch.int32)
    mask = torch.ones(e, dtype=torch.bool, device="cuda")
    mask[real:] = False
    mask[torch.randint(0, real, (interior_masked,), generator=gen,
                       device="cuda")] = False
    data = torch.randn((e,) + trailing, generator=gen, device="cuda")
    return data, ids, mask, n_rows


def chgnet_graph(torch, reps=16):
    """The CHGNet path's graph on the card (bench.py's crystal at ``reps``,
    16,384 atoms, built at cutoff + skin and bond_cutoff + skin) as a
    LocalGraph, with the model's masks: ``in_r`` (edges within the cutoff)
    and ``line_ok`` (lines whose two bonds lie within the bond cutoff)."""
    from distmlip_tpu_torch.neighbors import neighbor_list
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.partition import (CapacityPolicy, build_partitioned_graph,
                                              build_plan)
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, bench_atoms

    atoms, _ = bench_atoms(reps)
    r, br = CHGNET_KW["cutoff"] + 0.5, CHGNET_KW["bond_cutoff"] + 0.5
    nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r, bond_r=br)
    plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r, br, True)
    g, _ = build_partitioned_graph(plan, nl, atoms.numbers, atoms.cell,
                                   caps=CapacityPolicy())
    g = g.to("cuda")
    lg = local_graph_from_stacked(g)
    vec = lg.edge_vectors(g.positions[0])
    d = torch.linalg.norm(torch.where(lg.edge_mask[:, None], vec, torch.ones_like(vec)),
                          dim=-1)
    in_r = lg.edge_mask & (d <= CHGNET_KW["cutoff"])
    b_d = lg.edge_to_bond(d[:, None], torch.zeros((lg.b_cap, 1), device="cuda"))[:, 0]
    b_real = (b_d > 1e-6) & (b_d <= CHGNET_KW["bond_cutoff"])
    line_ok = lg.line_mask & b_real[lg.line_src] & b_real[lg.line_dst]
    return lg, in_r, line_ok


def chgnet_inputs(torch, gen, which, e, c, h, n_node, idx=None):
    """Random inputs of one CHGNet message at (E, C), hidden width H, in the
    order of its plain version up to ``weights``: ``n_node`` rows of the
    node array (atom conv) or (bond rows, atom rows) (line conv); ``idx``
    gives the gather ids (src, dst) or (line_src, line_dst, center), random
    otherwise. The gated MLP's 8 weights at a linear init's scale."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def ids(k, rows):
        if idx is not None:
            return idx[k]
        return torch.randint(0, rows, (e,), generator=gen, device="cuda",
                             dtype=torch.int32)

    if which == "atom":
        node = r(n_node, c)
        arrays = [node, ids(0, n_node), node, ids(1, n_node), r(e, c), r(e, c)]
        k1 = 3 * c
    else:
        n_bond, n_atom = n_node
        bond = r(n_bond, c)
        arrays = [bond, ids(0, n_bond), bond, ids(1, n_bond), r(e, c), r(n_atom, c),
                  ids(2, n_atom)]
        k1 = 4 * c
    weights = []
    for _ in range(2):
        weights += [r(k1, h) / k1 ** 0.5, r(h) / k1 ** 0.5, r(h, c) / h ** 0.5,
                    r(c) / h ** 0.5]
    return arrays, weights


def crystal_graph(torch):
    """dst ids, mask and n_cap of the MACE path's graph (2048 Si, cutoff 5
    Å, skin 0.5), built by the checkout's own ``DistPotential`` (a narrow
    MACE: the graph depends on the cutoff and capacities only)."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    kw = dict(MACE_KW, channels=8, l_max=1, a_lmax=1, correlation=1)
    model = MACE(MACEConfig(**kw))
    atoms, _ = bench_atoms()
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5)
    pot.calculate(atoms)
    lg = local_graph_from_stacked(pot._cache[0])
    return lg.edge_dst, lg.edge_mask, lg.n_cap


def time_segment_sum(torch, name, data, ids, mask, n):
    """B1 on one input: the three times, the bytes bound at the rows'
    element size, the output's digest, ``index_add_`` of the masked rows
    (float32: bf16 rows upcast beforehand) and, on bf16 rows, the
    checkout's plan where it has one."""
    from distmlip_tpu_torch import kernels as K

    e = data.shape[0]
    masked = torch.where(mask.reshape((e,) + (1,) * (data.ndim - 1)), data.float(), 0.0)
    out = torch.zeros((n,) + tuple(data.shape[1:]), device="cuda")
    ids_long = ids.long()
    row = {"kernel": "segment_sum", "case": name, "dtype": str(data.dtype).split(".")[-1],
           "shape": list(data.shape), "ids": str(ids.dtype), "n_segments": n,
           "valid": int(mask.sum()),
           "bound_ms": segment_sum_bytes(data, ids, mask, n) / H100_BYTES_PER_S * 1e3,
           "digest": digest(K.segment_sum_cuda(data, ids, n, mask))}
    if data.dtype == torch.bfloat16 and hasattr(K, "segment_sum_bf16_plan"):
        row["plan"] = K.segment_sum_bf16_plan(data, ids)
    row.update(split(torch, lambda: K.segment_sum_cuda(data, ids, n, mask), "segment_sum"))
    row.update(library_split(torch, lambda: out.index_add_(0, ids_long, masked)))
    return row


def tensornet_graph(torch, reps=16):
    """dst ids, src ids, mask and n_cap of the TensorNet path's graph
    (bench.py's crystal at ``reps``, 16,384 atoms, built at cutoff +
    skin), on the card."""
    from distmlip_tpu_torch.neighbors import neighbor_list
    from distmlip_tpu_torch.partition import (CapacityPolicy, build_partitioned_graph,
                                              build_plan)
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    atoms, _ = bench_atoms(reps)
    r = TENSORNET_KW["cutoff"] + 0.5
    nl = neighbor_list(atoms.positions, atoms.cell, atoms.pbc, r)
    plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r)
    g, _ = build_partitioned_graph(plan, nl, atoms.numbers, atoms.cell,
                                   caps=CapacityPolicy())
    to = lambda x: torch.as_tensor(x[0]).to("cuda")  # noqa: E731
    return to(g.edge_dst), to(g.edge_src), to(g.edge_mask), g.n_cap


def edge_inputs(torch, gen, which, e, c, n_node, src=None):
    """Random inputs of one TensorNet message at (E, C): the embed's
    Z, W1, W2, W3 (E, C) and A_e, S_e (E, 3, 3, 1); the interaction's
    f (E, C, 3), the compact node rows i (N_node, C), a (N_node, 3, C),
    s (N_node, 6, C) and src."""
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    if which == "embed":
        return [r(e, c) for _ in range(4)] + [r(e, 3, 3, 1) for _ in range(2)]
    if src is None:
        src = torch.randint(0, n_node, (e,), generator=gen, device="cuda",
                            dtype=torch.int32)
    return [r(e, c, 3), r(n_node, c), r(n_node, 3, c), r(n_node, 6, c), src]


def time_tensornet(torch, gen):
    """The TensorNet embed, interaction and interaction backward at the
    TensorNet path's graph (C = 64, random inputs), float32 and bf16 (the
    same values rounded once): the three times and the output's digest;
    the backward also as its C launch alone on the edges sorted beforehand
    (``no_sort_ms``), its bound and the bf16 plan."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import edge_aggregate as EA
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW

    ids, src, mask, n = tensornet_graph(torch)
    c = TENSORNET_KW["units"]
    inputs = {"embed": edge_inputs(torch, gen, "embed", ids.shape[0], c, n, src),
              "interaction": edge_inputs(torch, gen, "interaction", ids.shape[0], c, n, src)}
    g32 = torch.randn((n, 3, 3, c), generator=gen, device="cuda")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for which, cuda in (("embed", K.tensornet_embed_aggregate_cuda),
                            ("interaction", K.tensornet_interaction_aggregate_cuda)):
            xs = [x.to(dtype) if x.is_floating_point() else x for x in inputs[which]]
            row = {"kernel": f"tensornet_{which}", "dtype": tag, "e": ids.shape[0],
                   "valid": int(mask.sum()), "channels": c,
                   "digest": digest(cuda(*xs, ids, n, mask))}
            plan = getattr(K, f"tensornet_{which}_bf16_plan", None)
            if dtype == torch.bfloat16 and plan is not None:
                row["plan"] = plan(*xs[:4], n)
            row.update(split(torch, lambda: cuda(*xs, ids, n, mask),
                             f"tensornet_{which}_kernel"))
            rows.append(row)
        xs = [x.to(dtype) if x.is_floating_point() else x for x in inputs["interaction"]]
        g = g32.to(dtype)
        f, node_i, node_a, node_s, _ = xs
        nbytes, _ = interaction_backward_cost(torch, f, src, ids, mask, node_i.shape[0])
        row = {"kernel": "tensornet_interaction_backward", "dtype": tag, "e": ids.shape[0],
               "valid": int(mask.sum()), "channels": c,
               "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
               "digest": digest(*K.tensornet_interaction_backward_cuda(g, *xs, ids, mask))}
        if dtype == torch.bfloat16 and hasattr(K, "tensornet_interaction_backward_bf16_plan"):
            row["plan"] = K.tensornet_interaction_backward_bf16_plan(g, *xs[:4])
        row.update(split(torch, lambda: K.tensornet_interaction_backward_cuda(g, *xs, ids, mask),
                         "tensornet_interaction_bwd_kernel"))
        # the C launch alone, on the edges sorted and the outputs allocated beforehand
        perm, row_ptr = K.src_order(src, node_i.shape[0], mask)
        dst32 = ids.to(torch.int32).contiguous()
        outs = [torch.empty_like(x) for x in (f, node_i, node_a, node_s)]
        suffix = "_f32" if dtype == torch.float32 else "_bf16"
        head = [x.data_ptr() for x in (g, f, node_i, node_a, node_s, perm, dst32, row_ptr)]
        head += [x.data_ptr() for x in outs]
        tail = [node_i.shape[0], f.shape[0], c]
        launch = EA._interaction_bwd_fn(suffix)

        def no_sort():
            err = launch(*head, *tail, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"interaction backward launch failed: cudaError_t {err}")

        row["no_sort_ms"] = cuda_ms(torch, no_sort)
        rows.append(row)
        del xs, outs, g
        torch.cuda.empty_cache()
    return rows


def projection_library_call(torch, x, w, bias):
    """(name, fn): one PyTorch call of the bf16 row projection's function,
    bf16 operands into a float32 table with the float32 bias: ``addmm``
    with ``out_dtype`` (``aten::addmm.dtype``)."""
    return ("torch.addmm(bias, x, w, out_dtype=torch.float32)",
            lambda: torch.addmm(bias, x, w, out_dtype=torch.float32))


def time_projection(torch, rows, k, m, gen, dtype=None):
    from distmlip_tpu_torch import kernels as K

    dtype = dtype or torch.float32
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((k, m), generator=gen, device="cuda") / k ** 0.5
    b = torch.randn(m, generator=gen, device="cuda")
    row = {"kernel": "chgnet_row_projection", "dtype": str(dtype).split(".")[-1],
           "shape": [rows, k, m]}
    if dtype == torch.bfloat16:
        if "dtype" in inspect.signature(K.chgnet_projection_plan).parameters:
            w = w.bfloat16()  # the tensor-core kernel takes the packed blocks in bf16
        row["w_dtype"] = str(w.dtype).split(".")[-1]
        name, call = projection_library_call(torch, x, w.bfloat16(), b)
        row["library"] = name
    else:
        call = lambda: torch.addmm(b, x, w)  # noqa: E731
    row.update(split(torch, lambda: K.chgnet_row_projection_cuda(x, w, b), "row_projection"))
    row.update(library_split(torch, call))
    if dtype == torch.bfloat16:
        row["library_bf16_out_ms"] = cuda_ms(torch, lambda: torch.addmm(
            b.bfloat16(), x, w.bfloat16()))
    return row


def time_chgnet_convs(torch, gen):
    """The CHGNet atom and line convs (their row projections included in the
    call; the per-edge kernel alone by the profiler) at the CHGNet path's
    graph, real ids and masks, random rows and weights at C = H = 64, in
    float32 and in bf16 (the same values rounded once)."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.tools.workload import CHGNET_KW

    lg, in_r, line_ok = chgnet_graph(torch)
    c = CHGNET_KW["units"]
    rows = []
    for which in ("atom", "line"):
        if which == "atom":
            cuda, ids, mask, n = K.chgnet_atom_conv_aggregate_cuda, lg.edge_dst, in_r, lg.n_cap
            arrays, weights = chgnet_inputs(torch, gen, which, ids.shape[0], c, c, n,
                                            (lg.edge_src, lg.edge_dst))
        else:
            cuda, ids, mask, n = K.chgnet_line_aggregate_cuda, lg.line_dst, line_ok, lg.b_cap
            arrays, weights = chgnet_inputs(torch, gen, which, ids.shape[0], c, c,
                                            (lg.b_cap, lg.n_cap),
                                            (lg.line_src, lg.line_dst, lg.line_center))
        for dtype in (torch.float32, torch.bfloat16):
            seen = {}
            xs = [x if x is None or not x.is_floating_point()
                  else seen.setdefault(id(x), x.to(dtype)) for x in arrays]
            ws = [w.to(dtype) for w in weights]
            row = {"kernel": f"chgnet_{which}_conv", "dtype": str(dtype).split(".")[-1],
                   "e": ids.shape[0], "valid": int(mask.sum()), "channels": c}
            row.update(split(torch, lambda: cuda(*xs, ws, ids, n, mask),
                             f"chgnet_{which}_conv"))
            rows.append(row)
            del xs, seen
        torch.cuda.empty_cache()
    return rows


def time_so2(torch, gen, dtype):
    """B3 at eSCN's chunk, forward and on the backward's route, beside the
    five cuBLAS products on pre-packed operands ([f+ | f-] and [[Wr, Wi],
    [-Wi, Wr]] built beforehand: the GEMM work alone)."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch
    from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout

    e, l_max, c = 32768, 4, 128
    lay = CoeffLayout(l_max)
    m_idx = {m: (lay.plus_idx[m], lay.minus_idx[m]) for m in range(l_max + 1)}
    h = torch.randn((e, (l_max + 1) ** 2, c), generator=gen, device="cuda").to(dtype)
    weights = [(torch.randn((d, d), generator=gen, device="cuda") / d ** 0.5).to(dtype)
               for m in range(l_max + 1)
               for d in [(l_max + 1 - m) * c] * (1 if m == 0 else 2)]
    perm, _, segments = K.packed_m_layout(m_idx)
    packed = K.pack_so2_weights(weights, segments, c)
    back, wt = packed.transposed(), dispatch._so2_transposed_weights(weights, segments)
    row = {"kernel": "so2_conv", "dtype": str(dtype).split(".")[-1], "shape": [e, 25, c]}
    row.update(split(torch, lambda: K.so2_conv_cuda(h, weights, segments, c, perm,
                                                    packed=packed), "so2_conv"))
    bwd = lambda: K.so2_conv_cuda(h, wt, segments, c, perm, packed=back)  # noqa: E731
    row["backward_ms"] = cuda_ms(torch, bwd)
    row["backward_kernel_ms"] = device_split(torch, bwd, "so2_conv")[0]
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
            blk = torch.cat([torch.cat([wr, wim], 1), torch.cat([-wim, wr], 1)], 0)
            operands.append((hp[:, start:start + 2 * nl].reshape(e, 2 * d).contiguous(), blk))
    del hp
    row.update(library_split(torch, lambda: [torch.matmul(a, b) for a, b in operands]))
    row["library"] = "five cuBLAS products on pre-packed operands"
    return row


def relax_structure():
    """``examples/02_relax_chgnet.py``'s structure: 864 Li (fcc a = 3.6 Å,
    6 x 6 x 6 cells), 0.08 Å noise from seed 1, the cell stretched by 2%."""
    import numpy as np

    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(1)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * 3.6, (6, 6, 6))
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.08, (len(frac), 3))
    return Atoms(numbers=np.full(len(cart), 3), positions=cart, cell=lattice * 1.02)


def profile_calculate(torch, pot, atoms, top=8):
    """One calculate under ``torch.profiler`` (CPU and CUDA): its wall ms
    (the profiler's overhead included), the device's kernel ms (the sum of
    the kernels' self device time), and the ``top`` ops by self device time
    and by self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]

    def rows(events, key):
        events = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:top]
        return [{"name": e.key[:100], "calls": e.count, "ms": getattr(e, key) / 1e3}
                for e in events]

    return {"wall_ms": wall,
            "device_kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "top_device": rows(kernels, "self_device_time_total"),
            "top_cpu": rows([e for e in ev if e.device_type == DeviceType.CPU],
                            "self_cpu_time_total")}


def time_steps(torch, family, dtype, steps):
    """One calculate, then ``steps`` MD-like calculates (0.01 Å moves) of
    the eSCN (2048 atoms, example 05's conditioning) or CHGNet (16384
    atoms, magmoms, off-default readout terms) main path in ``dtype``, as
    ``chip_smoke.py`` builds them, then one more calculate under the
    profiler (``profiled``, see ``profile_calculate``)."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, ESCN, ESCNConfig
    from distmlip_tpu_torch.tools.workload import CHGNET_KW, ESCN_INFO, ESCN_KW, bench_atoms

    cls, cfg, kw, reps = {"escn": (ESCN, ESCNConfig, ESCN_KW, 8),
                          "chgnet": (CHGNet, CHGNetConfig, CHGNET_KW, 16)}[family]
    kw = dict(kw, dtype=str(dtype).split(".")[-1])
    model = cls(cfg(**kw))
    params = model.init(0)
    atoms, rng = bench_atoms(reps)
    shape = (kw["num_species"],) if family == "escn" else (kw["num_species"], 1)
    params["species_ref"]["w"] = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    pot_kw = {}
    if family == "escn":
        atoms.info = dict(ESCN_INFO)
    else:
        params["data_std"] = torch.tensor(1.3)
        pot_kw = {"compute_magmom": True}
    pot = DistPotential(model, params, device="cuda", skin=0.5, **pot_kw)
    secs = []
    for step in range(1 + steps):
        if step:
            atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t) * 1e3)
    atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
    profiled = profile_calculate(torch, pot, atoms)
    return {"kernel": "steps", "family": family, "dtype": kw["dtype"], "n_atoms": len(atoms),
            "first_calculate_ms": secs[0], "step_ms": secs[1:],
            "median_step_ms": statistics.median(secs[1:]), "rebuilds": pot.rebuild_count,
            "profiled": profiled}


def time_relax(torch, dtype, steps=30):
    """``chip_smoke.py``'s ``[relax-chgnet]`` (``[relax-chgnet-bf16]`` at
    bf16): CHGNet at the MPtrj layout with magmoms on ``relax_structure``,
    FIRE with the cell relaxed for ``steps`` steps (fmax 1e-4, smax 1e-5:
    it runs them all), a host rebuild at every calculate. Each calculate's
    ms (host clock; the results come back to the host), their median past
    the first."""
    from distmlip_tpu_torch.calculators import DistPotential, Relaxer
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.tools.workload import CHGNET_KW

    kw = dict(CHGNET_KW, dtype=str(dtype).split(".")[-1])
    model = CHGNet(CHGNetConfig(**kw))
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.4, compute_magmom=True)
    secs = []

    class Timed:
        def calculate(self, atoms):
            t = time.perf_counter()
            out = pot.calculate(atoms)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t) * 1e3)
            return out

    out = Relaxer(Timed(), optimizer="fire", relax_cell=True, fmax=1e-4, smax=1e-5).relax(
        relax_structure(), steps=steps)
    return {"kernel": "relax", "family": "chgnet", "dtype": kw["dtype"], "nsteps": out.nsteps,
            "first_calculate_ms": secs[0], "calculate_ms": secs[1:],
            "median_calculate_ms": statistics.median(secs[1:]),
            "rebuilds": pot.rebuild_count}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import (default: this one)")
    ap.add_argument("--label", default="", help="tag printed on every line")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--steps", type=int, default=0,
                    help="time N calculates of the eSCN and CHGNet main paths instead")
    ap.add_argument("--families", default="escn,chgnet",
                    help="the paths --steps times (comma-separated: escn, chgnet, relax)")
    ap.add_argument("--kernels", default="segment_sum,tensornet,projection,so2,chgnet_conv",
                    help="the groups of kernel rows to time (comma-separated)")
    args = ap.parse_args(argv)
    groups = args.kernels.split(",")
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    import distmlip_tpu_torch
    from distmlip_tpu_torch.kernels import build

    if not os.path.abspath(distmlip_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {distmlip_tpu_torch.__file__}, not {root}'s package")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()

    def emit(row):
        row.update(label=args.label, card=smi.strip())
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    sources = {"segment_sum": "segment_sum", "tensornet": "edge_aggregate",
               "projection": "chgnet_aggregate", "so2": "so2_conv",
               "chgnet_conv": "chgnet_aggregate"}
    emit({"kernel": "build", "seconds": build.build(
        sorted(set(sources.values()) if args.steps else {sources[g] for g in groups}))})
    if args.steps:
        for family in args.families.split(","):
            for dtype in (torch.bfloat16, torch.float32):
                emit(time_relax(torch, dtype) if family == "relax"
                     else time_steps(torch, family, dtype, args.steps))
                torch.cuda.empty_cache()
        return 0
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if "segment_sum" in groups:
        dst, mask, n_cap = crystal_graph(torch)
        data = torch.randn((dst.shape[0], 1), generator=gen, device="cuda")
        emit(time_segment_sum(torch, "zbl_width1", data, dst, mask, n_cap))
        # the same graph cut at its last valid edge: what the last row's
        # masked padding tail costs
        cut = int(torch.nonzero(mask).max()) + 1
        emit(time_segment_sum(torch, "zbl_width1_cut", data[:cut].contiguous(),
                              dst[:cut].contiguous(), mask[:cut].contiguous(), n_cap))
        emit(time_segment_sum(torch, "zbl_width1", data.bfloat16(), dst, mask, n_cap))
        for name, trailing in (("mace_16x128", (16, 128)), ("mace_40x128", (40, 128)),
                               ("escn_25x128", (25, 128))):
            case = slice_case(torch, gen, 32768, trailing)
            emit(time_segment_sum(torch, name, *case))
            bf16 = (case[0].bfloat16(),) + case[1:]
            emit(time_segment_sum(torch, name, *bf16))
            del case, bf16
            torch.cuda.empty_cache()
    if "tensornet" in groups:
        for row in time_tensornet(torch, gen):
            emit(row)
    if "projection" in groups:
        for dtype in (torch.float32, torch.bfloat16):
            for r, k, m in ((19712, 64, 128), (19712, 64, 256), (236032, 64, 256)):
                emit(time_projection(torch, r, k, m, gen, dtype))
    if "so2" in groups:
        for dtype in (torch.float32, torch.bfloat16):
            emit(time_so2(torch, gen, dtype))
            torch.cuda.empty_cache()
    if "chgnet_conv" in groups:
        for row in time_chgnet_convs(torch, gen):
            emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
