"""Where one MD step's time goes on the card: ``torch.profiler`` over the
smoke workload (``tools/workload.py``).

    python -m distmlip_tpu_torch.tools.step_profile [--reps 8] [--out DIR]

1. The first ``calculate`` (cold: CUDA context, library handles, the graph
   build and upload) under a CPU-only profile: its wall time and the ops
   that take the most host time.
2. One warm step (skin-cache hit) under a CPU + CUDA profile: its wall
   time, the device time by op and by kernel, and the device's busy share
   of the step (kernel, memcpy and memset time on the trace's device
   timeline over wall time; one stream, so they do not overlap).

Prints one JSON line per part and writes the warm step's Chrome trace and
both profile tables under ``--out``. Needs a card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _top(events, key, n):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"name": e.key[:120], "calls": e.count,
             "ms": getattr(e, key) / 1e3} for e in rows if getattr(e, key) > 0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8, help="crystal repeats (4 reps^3 atoms)")
    ap.add_argument("--out", default="build/step_profile",
                    help="directory for trace and tables")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..calculators import DistPotential
    from ..models import MACE, MACEConfig
    from .workload import MACE_KW, bench_atoms

    os.makedirs(args.out, exist_ok=True)
    model = MACE(MACEConfig(**MACE_KW))
    atoms, rng = bench_atoms(args.reps)
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5)

    with profile(activities=[ProfilerActivity.CPU]) as cold:
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
    ev = cold.key_averages()
    print(json.dumps({"part": "first_calculate", "wall_ms": cold_s * 1e3,
                      "top_self_cpu": _top(ev, "self_cpu_time_total", 15)}))
    with open(os.path.join(args.out, "step_profile_cold.txt"), "w") as f:
        f.write(ev.table(sort_by="self_cpu_time_total", row_limit=60))

    atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
    pot.calculate(atoms)  # one warm step outside the profile
    atoms.positions += rng.normal(0, 0.01, atoms.positions.shape)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as warm:
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
    if pot.rebuild_count != 1:
        raise AssertionError("the profiled step rebuilt the graph")
    ev = warm.key_averages()
    trace = os.path.join(args.out, "step_profile_warm.json")
    warm.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    # device work = kernels, memcpys and memsets on the card's timeline
    device_ms = sum(e["dur"] for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    # device-side kernel rows only: op rows repeat their kernels' time
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    print(json.dumps({
        "part": "warm_step", "n_atoms": len(atoms), "wall_ms": warm_s * 1e3,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (warm_s * 1e3),
        "top_ops_device_inclusive": _top(
            [e for e in ev if e.key.startswith("aten::")], "device_time_total", 20),
        "top_kernels": _top(kernels, "self_device_time_total", 25),
        "card": torch.cuda.get_device_name(0),
    }))
    with open(os.path.join(args.out, "step_profile_warm.txt"), "w") as f:
        f.write(ev.table(sort_by="self_device_time_total", row_limit=80))
    return 0


if __name__ == "__main__":
    sys.exit(main())
