"""Time the segment sum (B1) and the CHGNet row projection of one checkout on
the card, at the shapes the main paths give them, split three ways.

    python distmlip_tpu_torch/tools/kernel_ab.py [--root DIR] [--label L]
        [--out FILE]

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
  (``index_add_`` of the masked rows; ``addmm``): ``library_ms``,
  ``library_kernel_ms``, ``library_host_us``.

Shapes: B1 at width 1 on the crystal graph of the MACE path (2048 Si,
cutoff 5 Å, skin 0.5: its own dst ids and mask, the pair term's sum with
``zbl=True``; and the same cut at its last valid edge), at MACE's two edge-chunk shapes (32768, 16 x 128) and
(32768, 40 x 128) and eSCN's (32768, 25 x 128), each chunk with ~47 edges
a row, a 3000-edge padding tail and 200 masked edges; the row projection at
CHGNet's atom tables (19,712, 64) @ (64, 128) and (64, 256) and its bond
table (236,032, 64) @ (64, 256). ``chip_smoke.py`` imports ``cuda_ms``,
``slice_case``, ``split`` and ``library_split`` from here, so its
``[kernels]`` lines time the same cases the same ways. Needs a card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
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


def device_split(torch, fn, key=None, iters=20):
    """(ms per call of the kernels whose name holds ``key``, ms per call of
    every kernel) under ``torch.profiler``; ``key`` None gives the total
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    own = (total if key is None else
           sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3 / iters)
    return own, total


def split(torch, fn, key):
    own, total = device_split(torch, fn, key)
    return {"ms": cuda_ms(torch, fn), "kernel_ms": own, "device_ms": total,
            "host_us": host_us(torch, fn)}


def library_split(torch, fn):
    own, _ = device_split(torch, fn)
    return {"library_ms": cuda_ms(torch, fn), "library_kernel_ms": own,
            "library_host_us": host_us(torch, fn)}


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
    from distmlip_tpu_torch.kernels import segment_sum_cuda

    e = data.shape[0]
    masked = torch.where(mask.reshape((e,) + (1,) * (data.ndim - 1)), data, 0.0)
    out = torch.zeros((n,) + tuple(data.shape[1:]), device="cuda")
    ids_long = ids.long()
    row = {"kernel": "segment_sum", "case": name, "shape": list(data.shape),
           "ids": str(ids.dtype), "n_segments": n, "valid": int(mask.sum())}
    row.update(split(torch, lambda: segment_sum_cuda(data, ids, n, mask), "segment_sum"))
    row.update(library_split(torch, lambda: out.index_add_(0, ids_long, masked)))
    return row


def time_projection(torch, rows, k, m, gen):
    from distmlip_tpu_torch import kernels as K

    x = torch.randn((rows, k), generator=gen, device="cuda")
    w = torch.randn((k, m), generator=gen, device="cuda") / k ** 0.5
    b = torch.randn(m, generator=gen, device="cuda")
    row = {"kernel": "chgnet_row_projection", "shape": [rows, k, m]}
    row.update(split(torch, lambda: K.chgnet_row_projection_cuda(x, w, b), "row_projection"))
    row.update(library_split(torch, lambda: torch.addmm(b, x, w)))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import (default: this one)")
    ap.add_argument("--label", default="", help="tag printed on every line")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
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
    rows = [{"kernel": "build", "seconds": build.build(["segment_sum", "chgnet_aggregate"])}]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dst, mask, n_cap = crystal_graph(torch)
    data = torch.randn((dst.shape[0], 1), generator=gen, device="cuda")
    rows.append(time_segment_sum(torch, "zbl_width1", data, dst, mask, n_cap))
    # the same graph cut at its last valid edge: what the last row's masked
    # padding tail costs
    cut = int(torch.nonzero(mask).max()) + 1
    rows.append(time_segment_sum(torch, "zbl_width1_cut", data[:cut].contiguous(),
                                 dst[:cut].contiguous(), mask[:cut].contiguous(), n_cap))
    for name, trailing in (("mace_16x128", (16, 128)), ("mace_40x128", (40, 128)),
                           ("escn_25x128", (25, 128))):
        rows.append(time_segment_sum(torch, name, *slice_case(torch, gen, 32768, trailing)))
        torch.cuda.empty_cache()
    for r, k, m in ((19712, 64, 128), (19712, 64, 256), (236032, 64, 256)):
        rows.append(time_projection(torch, r, k, m, gen))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    for row in rows:
        row.update(label=args.label, card=smi.strip())
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
