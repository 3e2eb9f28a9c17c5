"""First-use cost on the card: what the first launch of a kernel costs.

Run on a machine with a card, from the root of a checkout:

    python -m distmlip_tpu_torch.tools.first_use [--dtype float32]

In a fresh process, builds the port's CUDA kernels (nvcc) and native
host library (g++) and prints their seconds, then the ms of the first and
the second call of a few float32 and bfloat16 operations (a matmul,
elementwise ops, a reduction, a gather, a select, a backward), each
synchronised, then of a TensorNet ``DistPotential.calculate`` at the
MatPES layout in ``--dtype`` (bfloat16 by default, ``TENSORNET_BF16_KW``)
on bench.py's 2048-atom crystal, first and second.
A process pays once for each build missing from ``build/`` and, through
CUDA's lazy module loading (``CUDA_MODULE_LOADING``), once for the first
launch of each distinct kernel.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def first_and_second(torch, fn):
    """(ms of the first call, ms of the second), each synchronised."""
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the TensorNet calculate's compute dtype")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("first_use: needs an NVIDIA card", file=sys.stderr)
        return 2
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import build
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.neighbors import native
    from distmlip_tpu_torch.tools.workload import TENSORNET_KW, bench_atoms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"CUDA_MODULE_LOADING={os.environ.get('CUDA_MODULE_LOADING')}", flush=True)
    print(f"kernel builds (nvcc, s): {build.build()}; native host library (g++): "
          f"{native.build():.2f} s", flush=True)
    x = torch.randn(4096, 64, device="cuda")
    w = torch.randn(64, 64, device="cuda")
    xb, wb = x.bfloat16(), w.bfloat16()
    leaf = xb.clone().requires_grad_(True)
    ops = [("float32 matmul", lambda: x @ w), ("bfloat16 matmul", lambda: xb @ wb),
           ("bfloat16 mul", lambda: xb * xb), ("bfloat16 add", lambda: xb + xb),
           ("bfloat16 sum", lambda: xb.sum(-1)),
           ("bfloat16 index_select", lambda: xb.index_select(0, torch.arange(100, device="cuda"))),
           ("bfloat16 where", lambda: torch.where(xb > 0, xb, 0.0)),
           ("bfloat16 backward", lambda: (leaf @ wb).float().sum().backward())]
    for name, fn in ops:
        first, second = first_and_second(torch, fn)
        print(f"{name}: first {first:.1f} ms, second {second:.1f} ms", flush=True)
    model = TensorNet(TensorNetConfig(**TENSORNET_KW, dtype=args.dtype))
    atoms, _ = bench_atoms()
    pot = DistPotential(model, model.init(0), device="cuda", skin=0.5)
    timings = []
    first, second = first_and_second(
        torch, lambda: (pot.calculate(atoms), timings.append(dict(pot.last_timings))))
    print(f"TensorNet {args.dtype} calculate, {len(atoms)} atoms: first {first:.1f} ms (its host "
          f"graph build included), second {second:.1f} ms; last_timings (s) {timings}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
