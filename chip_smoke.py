#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``distmlip_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

Phases (each failure raises, so the exit code is non-zero):

1. environment — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, both TF32 flags (off: this port computes in float32);
2. build — ``nvcc`` compiles every kernel under
   ``distmlip_tpu_torch/kernels/csrc`` (one process per source, in
   parallel) into ``build/kernels``;
3. kernels vs plain — each kernel's wrapper on card tensors at the shapes
   the main path gives it, held against its plain PyTorch version with the
   stated tolerance, plus edge cases; times of the kernel, the plain
   version, one library call and the least time the card could take;
4. the main path — MACE at the MACE-MP-0-medium widths (channels 128,
   l_max = a_lmax = 3, correlation 3, 2 interactions; random weights from
   seed 0) through ``DistPotential(device="cuda", skin=0.5)`` on a
   2048-atom Si crystal: one calculate plus 3 MD-like steps. The kernels'
   launch counts are set to 0 just before and read just after, and must
   equal the count derived from the code. The same 4 geometries through a
   ``kernels=False`` potential on the card are the reference;
5. a small structure on the card (kernels) against the CPU (plain).

Prints one ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name/power
line, then ``{"ok": true, "device": {...}}`` as the last line. Without a
card, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
REPLACES = {"segment_sum": "distmlip_tpu/kernels/segment.py:142"}
SOURCES = {"segment_sum": "distmlip_tpu_torch/kernels/csrc/segment_sum.cu"}
STEPS = 3


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
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


def slice_case(torch, gen, e, trailing, n_rows=2560, per_row=47, pad=3000,
               interior_masked=200):
    """dst-sorted ids as one edge chunk of the main path: ~47 edges per dst
    row over a contiguous block of rows, a repeated-tail padding block
    (mask false), some masked interior rows."""
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


def check_segment_sum(torch, data, ids, mask, n):
    """Kernel vs plain on one input; returns max |kernel - plain|. float32
    in two summation orders: each output may differ by up to 2 k u sum|x|
    (k = the largest row's edge count, u = 2^-24)."""
    from distmlip_tpu_torch.kernels import segment_sum_cuda, segment_sum_reference

    got = segment_sum_cuda(data, ids, n, mask)
    want = segment_sum_reference(data, ids, n, mask)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"segment_sum shape/dtype {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}")
    k = max(int(torch.bincount(ids.long(), minlength=n).max()), 1)
    bound = 2 * k * 2.0 ** -24 * segment_sum_reference(data.abs(), ids, n, mask)
    err = (got - want).abs()
    if not bool((err <= bound + 1e-30).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"segment_sum disagrees with its plain version: max "
                             f"|err| {float(err.max())}, bound {float(bound.max())}")
    return float(err.max()) if err.numel() else 0.0


def time_segment_sum(torch, data, ids, mask, n):
    from distmlip_tpu_torch.kernels import segment_sum_cuda, segment_sum_reference

    e = data.shape[0]
    w = data[0].numel()
    ms = cuda_ms(torch, lambda: segment_sum_cuda(data, ids, n, mask))
    plain_ms = cuda_ms(torch, lambda: segment_sum_reference(data, ids, n, mask))
    masked = torch.where(mask.reshape((e,) + (1,) * (data.ndim - 1)), data, 0.0)
    out = torch.zeros((n,) + tuple(data.shape[1:]), device="cuda")
    ids_long = ids.long()
    library_ms = cuda_ms(torch, lambda: out.index_add_(0, ids_long, masked))
    n_valid = int(mask.sum())
    # bytes the function must move: each valid data row read once (masked
    # rows need not be read), ids and mask read once, the output written once
    nbytes = n_valid * w * 4 + e * ids.element_size() + e + n * w * 4
    ops = n_valid * w
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return {"shape": [e] + list(data.shape[1:]), "n_segments": n,
            "valid_rows": n_valid, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs, timed = [], []
    for q in (16, 40):  # the two interactions' Q; C = 128
        case = slice_case(torch, gen, 32768, (q, 128))
        errs.append(check_segment_sum(torch, *case))
        timed.append(time_segment_sum(torch, *case))
        log(f"[kernels] segment_sum {timed[-1]['shape']}: {json.dumps(timed[-1])}")
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
    return max(errs), timed, pad_time


def check_result(res, n_atoms):
    import numpy as np

    if not (np.isfinite(res["energy"]) and res["forces"].shape == (n_atoms, 3)
            and res["stress"].shape == (3, 3)
            and np.isfinite(res["forces"]).all() and np.isfinite(res["stress"]).all()):
        raise AssertionError("non-finite or misshapen outputs")


def phase_main_path(torch):
    import numpy as np

    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.tools.workload import MACE_KW, bench_atoms

    t0 = time.perf_counter()
    model = MACE(MACEConfig(**MACE_KW))
    params = model.init(0)
    atoms, rng = bench_atoms()
    pot = DistPotential(model, params, device="cuda", skin=0.5, compute_stress=True)
    log(f"[main] model + params + potential built in {time.perf_counter() - t0:.2f} s")

    geometries, results, step_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in launch_counts:
        launch_counts[k] = 0
    for step in range(1 + STEPS):
        if step:
            atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
        geometries.append(atoms.positions.copy())
        t = time.perf_counter()
        res = pot.calculate(atoms)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        results.append(res)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()

    for res in results:
        check_result(res, len(atoms))
    if pot.rebuild_count != 1:
        raise AssertionError(f"graph rebuilt after step 1 ({pot.rebuild_count} builds)")
    stats = pot.last_stats
    K = chunk_layout(stats["e_cap"], MACE_KW["edge_chunk"])[2]
    n_calc = 1 + STEPS
    per_calc = MACE_KW["num_interactions"] * 2 * K
    expected = n_calc * per_calc
    log(f"[main] segment_sum launches: {n_calc} calculates x "
        f"{MACE_KW['num_interactions']} interactions x (K={K} forward chunks + "
        f"K={K} backward recomputes of the checkpointed chunk bodies) = "
        f"{expected}; counted {launches['segment_sum']} "
        f"(e_cap {stats['e_cap']}, edge_chunk {MACE_KW['edge_chunk']})")
    if launches["segment_sum"] != expected:
        raise AssertionError("kernel launch count differs from the derivation")

    # reference: the same geometries through the plain versions on the card
    ref_pot = DistPotential(model, params, device="cuda", skin=0.5, kernels=False)
    worst = {"rel_dE": 0.0, "max_dF": 0.0, "max_dS": 0.0}
    for pos, res in zip(geometries, results):
        atoms.positions = pos.copy()
        ref = ref_pot.calculate(atoms)
        worst["rel_dE"] = max(worst["rel_dE"],
                              abs(res["energy"] - ref["energy"]) / abs(ref["energy"]))
        worst["max_dF"] = max(worst["max_dF"],
                              float(np.abs(res["forces"] - ref["forces"]).max()))
        worst["max_dS"] = max(worst["max_dS"],
                              float(np.abs(res["stress"] - ref["stress"]).max()))
    if launch_counts["segment_sum"] != expected:
        raise AssertionError("the kernels=False reference launched a kernel")
    log(f"[main] kernels vs plain on the card over {n_calc} geometries: {json.dumps(worst)}")
    if not (worst["rel_dE"] < 1e-5 and worst["max_dF"] < 1e-4 and worst["max_dS"] < 1e-4):
        raise AssertionError("main path disagrees with its plain reference")

    steady = step_s[1:]
    summary = {
        "n_atoms": len(atoms), "n_edges": stats["n_edges"], "e_cap": stats["e_cap"],
        "n_cap": stats["n_cap"], "edge_chunks": K,
        "first_calculate_ms": step_s[0] * 1e3,
        "step_ms": [s * 1e3 for s in steady],
        "atoms_per_s": len(atoms) / (sum(steady) / len(steady)),
        "max_memory_allocated_bytes": peak,
        "energy": results[-1]["energy"],
        "launches": launches, "launches_expected": {"segment_sum": expected},
    }
    log(f"[main] {json.dumps(summary)}")
    return launches


def phase_small_reference(torch):
    """A 32-atom structure: the port on the card (kernels) vs on the CPU
    (plain versions), same params."""
    import numpy as np

    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 4.0, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (32, 3))
    atoms = Atoms(numbers=rng.integers(0, 3, 32), positions=cart, cell=lat)
    model = MACE(MACEConfig(num_species=4, channels=16, l_max=3, a_lmax=3,
                            hidden_lmax=1, correlation=3, cutoff=4.0,
                            edge_chunk=64, node_chunk=16))
    params = model.init(0)
    gpu = DistPotential(model, params, device="cuda").calculate(atoms)
    cpu = DistPotential(model, params, device="cpu").calculate(atoms)
    check_result(gpu, 32)
    d = {"rel_dE": abs(gpu["energy"] - cpu["energy"]) / abs(cpu["energy"]),
         "max_dF": float(np.abs(gpu["forces"] - cpu["forces"]).max()),
         "max_dS": float(np.abs(gpu["stress"] - cpu["stress"]).max())}
    log(f"[small] card (kernels) vs CPU (plain), 32 atoms: {json.dumps(d)}")
    if not (d["rel_dE"] < 1e-5 and d["max_dF"] < 1e-4 and d["max_dS"] < 1e-4):
        raise AssertionError("small structure: card disagrees with CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from distmlip_tpu_torch.device import resolve_device
        from distmlip_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[env] {smi}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"[env] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    seconds = build.build()
    for name, s in seconds.items():
        log(f"[build] {name}: {s:.2f} s")
        with open(build.library_path(name)[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[build]   {line.strip()}")

    max_err, timed, _ = phase_kernels(torch)
    launches = phase_main_path(torch)
    phase_small_reference(torch)

    headline = timed[-1]  # the (32768, 40, 128) chunk of interaction 1
    kernels = [{
        "name": "segment_sum", "route": "cuda", "source": SOURCES["segment_sum"],
        "replaces": REPLACES["segment_sum"], "launches": launches["segment_sum"],
        "max_abs_err": max_err, "ms": headline["ms"], "kernel_ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"], "shape": headline["shape"],
        "per_shape": timed,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
