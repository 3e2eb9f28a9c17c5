"""The workload ``chip_smoke.py`` and the profiling tools drive.

MACE at the MACE-MP-0-medium widths (the values of ``bench_mace_config``
in ``tools/bench_common.py``, copied as literals), float32, full remat,
edge chunks of 32768 and node chunks of 4096, on bench.py's perturbed Si
crystal (lattice 3.9 Å per 4-atom cell, 0.04 Å noise, seed 0). ``reps=8``
gives 2048 atoms; bench.py's own default is reps=16 (16384 atoms).
"""

from __future__ import annotations

import numpy as np

MACE_KW = dict(num_species=95, channels=128, l_max=3, a_lmax=3, hidden_lmax=1,
               correlation=3, num_interactions=2, num_bessel=8, radial_mlp=64,
               cutoff=5.0, avg_num_neighbors=14.0, remat=True,
               edge_chunk=32768, node_chunk=4096)


def bench_atoms(reps: int = 8, seed: int = 0):
    """bench.py's perturbed Si-like crystal of 4 * reps^3 atoms, and the
    generator that made it (callers draw the MD-like moves from it)."""
    from .. import geometry
    from ..calculators import Atoms

    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * 3.9, (reps, reps, reps))
    cart = geometry.frac_to_cart(frac, lattice) + rng.normal(0, 0.04, (len(frac), 3))
    return Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lattice), rng
