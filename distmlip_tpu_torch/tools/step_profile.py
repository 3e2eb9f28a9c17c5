"""Where one MD step's time goes on the card: ``torch.profiler`` over a
smoke workload (``tools/workload.py``).

    python -m distmlip_tpu_torch.tools.step_profile
        [--model mace|tensornet|chgnet|escn|uma|uma-bf16] [--reps N]
        [--num-partitions P]
        [--out DIR]

``--model mace`` (the default) runs MACE at the MACE-MP-0-medium widths on
2048 atoms (reps 8); ``--model tensornet`` runs TensorNet at the MatPES
layout on 16384 atoms (reps 16); ``--model chgnet`` runs CHGNet at the
MPtrj layout on 16384 atoms (reps 16) with magmoms; ``--model escn`` runs
eSCN at the single-chip UMA widths (channels 128, l_max 4, 8 experts) on
2048 atoms (reps 8) with the workload's charge, spin and dataset;
``--model uma`` runs ESCNMD at the UMA-S widths (``UMA_KW``, random weights
from seed 0) on 2048 atoms with charge 1, spin 1 and the omat task's
dataset, ``uma-bf16`` the same at ``UMA_BF16_KW``.
``--num-partitions P`` splits the structure into P slabs, run on the card
as one flattened graph (``parallel/halo.py``).

``--train`` profiles one optimizer step of ``train.Trainer`` instead (MACE,
TensorNet, CHGNet or eSCN at the workload widths, bench.py's train set of
8 x 108-atom Si labelled by a teacher from seed 1, micro-batch 4,
Adam 1e-3): two warm steps, then one step under the
CPU + CUDA profile, split as part 2 below; ``--reps`` is ignored.

1. The first ``calculate`` (cold: CUDA context, library handles, the graph
   build and upload) under a CPU-only profile: its wall time and the ops
   that take the most host time.
2. One warm step (skin-cache hit) under a CPU + CUDA profile: its wall
   time, the device time by op and by kernel, the device's busy share of
   the step (kernel, memcpy and memset time on the trace's device timeline
   over wall time; one stream, so they do not overlap), and the share of
   device time in each of the port's own kernels.

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


def _device_split(torch, prof, wall_s, out_dir) -> dict:
    """Wall and device time of a profiled step, the device's busy share,
    the port's own kernels' device time and share, and the top ops and
    kernels by device time; writes the Chrome trace and the table."""
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    trace = os.path.join(out_dir, "step_profile_warm.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    # device work = kernels, memcpys and memsets on the card's timeline
    device_ms = sum(e["dur"] for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    # device-side kernel rows only: op rows repeat their kernels' time
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    own = {}  # the port's kernels, by their __global__ names
    for e in kernels:
        for name in ("segment_sum_kernel", "segment_sum_bf16_row_kernel",
                     "tensornet_embed_kernel",
                     "tensornet_interaction_kernel", "tensornet_interaction_bwd_kernel",
                     "chgnet_atom_conv_kernel",
                     "chgnet_line_conv_kernel", "chgnet_row_projection_kernel",
                     "so2_conv_kernel"):
            if name in e.key:
                row = own.setdefault(name, {"calls": 0, "ms": 0.0})
                row["calls"] += e.count
                row["ms"] += e.self_device_time_total / 1e3
    for row in own.values():
        row["device_share"] = row["ms"] / device_ms if device_ms else 0.0
    with open(os.path.join(out_dir, "step_profile_warm.txt"), "w") as f:
        f.write(ev.table(sort_by="self_device_time_total", row_limit=80))
    return {
        "wall_ms": wall_s * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "own_kernels": own,
        "top_ops_device_inclusive": _top(
            [e for e in ev if e.key.startswith("aten::")], "device_time_total", 20),
        "top_kernels": _top(kernels, "self_device_time_total", 25),
        "card": torch.cuda.get_device_name(0),
    }


def _profile_train(torch, family, model, out_dir) -> int:
    """One ``Trainer`` step (module docstring) under the CPU + CUDA profile."""
    import functools

    micro_batch = 4
    from torch.profiler import ProfilerActivity, profile

    from ..train import Trainer
    from .workload import CHGNET_KW, ESCN_INFO, train_samples

    if family.startswith("uma"):
        print("step_profile: --train takes mace, tensornet, chgnet or escn", file=sys.stderr)
        return 2
    teacher = model.init(1)
    samples = train_samples(model, teacher, ESCN_INFO if family == "escn" else None)
    lk = ({"use_bond_graph": True, "bond_cutoff": CHGNET_KW["bond_cutoff"]}
          if family == "chgnet" else {})
    trainer = Trainer(model.energy_fn, model.init(0),
                      functools.partial(torch.optim.Adam, lr=1e-3), samples,
                      float(model.cfg.cutoff), micro_batch_size=micro_batch,
                      hbm_budget_frac=0.95, device="cuda", loader_kwargs=lk)
    trainer.fit(steps=2)  # warm, outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        m = trainer.train_step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    print(json.dumps({"part": "train_step", "model": family, "micro_batch": micro_batch,
                      "n_atoms": micro_batch * len(samples[0].forces), "loss": m["loss"],
                      "est_peak_bytes": trainer.est_peak_bytes,
                      **_device_split(torch, prof, wall_s, out_dir)}))
    trainer.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("mace", "tensornet", "chgnet", "escn", "uma",
                                        "uma-bf16"), default="mace")
    ap.add_argument("--reps", type=int, default=None,
                    help="crystal repeats (4 reps^3 atoms); default 8 for mace, "
                         "escn and uma, 16 for tensornet and chgnet")
    ap.add_argument("--num-partitions", type=int, default=1,
                    help="slabs of the structure (default 1)")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step (train.Trainer) instead of an MD step")
    ap.add_argument("--out", default=None,
                    help="directory for trace and tables (default "
                         "build/step_profile/<model>, with _p<P> at P > 1)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ..calculators import UMA_TASK_DATASETS, DistPotential
    from ..models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, ESCNMD, ESCNMDConfig, MACE,
                          MACEConfig, TensorNet, TensorNetConfig)
    from .workload import (CHGNET_KW, ESCN_INFO, ESCN_KW, MACE_KW, TENSORNET_KW,
                           UMA_BF16_KW, UMA_INFO, UMA_KW, bench_atoms)

    P = args.num_partitions
    out_dir = args.out or os.path.join("build", "step_profile",
                                       args.model + (f"_p{P}" if P > 1 else "")
                                       + ("_train" if args.train else ""))
    os.makedirs(out_dir, exist_ok=True)
    extra = {}
    if args.model == "mace":
        model, reps = MACE(MACEConfig(**MACE_KW)), args.reps or 8
    elif args.model == "tensornet":
        model, reps = TensorNet(TensorNetConfig(**TENSORNET_KW)), args.reps or 16
    elif args.model == "chgnet":
        model, reps = CHGNet(CHGNetConfig(**CHGNET_KW)), args.reps or 16
        extra = {"compute_magmom": True}
    elif args.model == "escn":
        model, reps = ESCN(ESCNConfig(**ESCN_KW)), args.reps or 8
    else:
        kw = UMA_BF16_KW if args.model == "uma-bf16" else UMA_KW
        model, reps = ESCNMD(ESCNMDConfig(**kw)), args.reps or 8
    if args.train:
        return _profile_train(torch, args.model, model, out_dir)
    atoms, rng = bench_atoms(reps)
    if args.model == "escn":
        atoms.info = dict(ESCN_INFO)
    elif args.model.startswith("uma"):
        atoms.info = dict(UMA_INFO, dataset=UMA_TASK_DATASETS["omat"])
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5, num_partitions=P,
                        **extra)

    with profile(activities=[ProfilerActivity.CPU]) as cold:
        t = time.perf_counter()
        pot.calculate(atoms)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
    ev = cold.key_averages()
    print(json.dumps({"part": "first_calculate", "model": args.model, "num_partitions": P,
                      "wall_ms": cold_s * 1e3,
                      "top_self_cpu": _top(ev, "self_cpu_time_total", 15)}))
    with open(os.path.join(out_dir, "step_profile_cold.txt"), "w") as f:
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
    print(json.dumps({"part": "warm_step", "model": args.model, "num_partitions": P,
                      "n_atoms": len(atoms), **_device_split(torch, warm, warm_s, out_dir)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
