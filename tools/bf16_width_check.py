#!/usr/bin/env python3
"""bfloat16 against float32 at a model's full width, in both packages, on
the CPU: how far bf16 compute lies from float32 for the JAX package and for
the PyTorch port, and how far the two bf16 paths lie from each other.

    JAX_PLATFORMS=cpu python tools/bf16_width_check.py mace   # or escn

The model is ``distmlip_tpu_torch.tools.workload``'s (MACE at the
MACE-MP-0-medium widths of ``MACE_KW``; eSCN at ``ESCN_KW`` with
``ESCN_INFO``) with the JAX package's own initial parameters (seed 0),
on bench.py's crystal at 2 x 2 x 2 cells (32 atoms: the width is real,
the structure small enough for a CPU). Each side runs
``DistPotential(compute_dtype=...)`` at float32 and bfloat16 (the JAX
side at ``kernels=False``); one line per comparison: |dE| per atom, rel
dE and max |dF| over max |F|.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from distmlip_tpu import models as jmodels  # noqa: E402
from distmlip_tpu.calculators import Atoms as JAtoms  # noqa: E402
from distmlip_tpu.calculators import DistPotential as JDistPotential  # noqa: E402
from distmlip_tpu_torch import models  # noqa: E402
from distmlip_tpu_torch.calculators import DistPotential  # noqa: E402
from distmlip_tpu_torch.tools.workload import (ESCN_INFO, ESCN_KW, MACE_KW,  # noqa: E402
                                               bench_atoms)


def main(family: str) -> int:
    torch.set_num_threads(2)
    name, kw, info = (("MACE", MACE_KW, {}) if family == "mace"
                      else ("ESCN", ESCN_KW, dict(ESCN_INFO)))
    jmodel = getattr(jmodels, name)(getattr(jmodels, name + "Config")(**kw))
    model = getattr(models, name)(getattr(models, name + "Config")(**kw))
    params = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(0)))
    atoms, _ = bench_atoms(reps=2)
    atoms.info = info
    jatoms = JAtoms(numbers=atoms.numbers, positions=atoms.positions, cell=atoms.cell,
                    info=info)
    n = len(atoms)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out["jax", dtype] = JDistPotential(jmodel, params, num_partitions=1, kernels=False,
                                           compute_dtype=dtype).calculate(jatoms)
        out["port", dtype] = DistPotential(model, params, device="cpu",
                                           compute_dtype=dtype).calculate(atoms)

    def line(a, b):
        x, y = out[a], out[b]
        de = abs(x["energy"] - y["energy"])
        return (f"{a[0]} {a[1]} vs {b[0]} {b[1]}: |dE|/atom {de / n:.3g} eV, rel dE "
                f"{de / abs(y['energy']):.3g}, max |dF| / max |F| "
                f"{np.abs(x['forces'] - y['forces']).max() / np.abs(y['forces']).max():.3g}")

    print(f"{family}: {n} atoms, E/atom {out['jax', 'float32']['energy'] / n:.4g} eV")
    for a, b in ((("jax", "bfloat16"), ("jax", "float32")),
                 (("port", "bfloat16"), ("port", "float32")),
                 (("port", "bfloat16"), ("jax", "bfloat16")),
                 (("port", "float32"), ("jax", "float32"))):
        print(line(a, b))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "mace"))
