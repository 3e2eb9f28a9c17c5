"""The workloads ``chip_smoke.py`` and the profiling tools drive.

- MACE at the MACE-MP-0-medium widths (the values of ``bench_mace_config``
  in ``tools/bench_common.py``, copied as literals), float32, full remat,
  edge chunks of 32768 and node chunks of 4096. ``MACE_BF16_KW`` is the
  same at ``dtype="bfloat16"``: bench.py's own configuration, whose
  headline MD metric runs at ``BENCH_DTYPE=bfloat16`` by default
  (``bench.py:266``, its batched phase too, ``:348``).
- TensorNet at the matgl TensorNet-MatPES-PBE layout (89 species, 64
  channels, 32 RBF, 2 layers, cutoff 5.0 Å; the full-size layout that
  ``tests/test_convert_tensornet.py:228-240`` converts), float32.
  ``TENSORNET_BF16_KW`` is the same at ``dtype="bfloat16"``: the
  reference's own compute-dtype switch on that layout
  (``distmlip_tpu/models/tensornet.py:129``).
- CHGNet at the matgl MPtrj layout (89 species, 64 units, 31 RBF,
  max_f 4, 4 blocks, cutoff 6.0 Å, bond cutoff 3.0 Å; the full-size layout
  that ``tests/test_convert_chgnet.py:328-342`` converts), float32.
  ``CHGNET_BF16_KW`` is the same at ``dtype="bfloat16"``: the reference's
  own compute-dtype switch on that layout
  (``distmlip_tpu/models/chgnet.py:179``).

- eSCN at the repo's single-chip eSCN/UMA configuration
  (``examples/05_scale_ladder.py:188-190``: channels 128, l_max 4, 2
  layers, 8 experts, cutoff 5.0 Å, 40 average neighbours; the config's
  default 8 Bessel functions, 32 edge channels, edge chunks of 32768 and
  remat), with the example's conditioning (``ESCN_INFO``: charge 1, spin
  1, dataset 2) set on the atoms. Two changes from the example:
  ``num_species=95`` (the config's default) in place of 8, so Si (Z = 14)
  needs no species map (only the embedding tables' row counts change);
  and float32 in place of the example's bfloat16. ``ESCN_BF16_KW`` is the
  same at ``dtype="bfloat16"``: the example's own precision.
- ESCNMD (the fairchem-parameterized eSCN that UMA checkpoints convert
  onto) at the widths of fairchem's published UMA-S (``uma_sm``) backbone:
  sphere channels 128, lmax = mmax = 2, 4 layers, hidden and edge channels
  128, 64 gaussians, 32 MOLE experts, cutoff 6.0 Å, 100 elements, 4
  datasets (the four tasks ``UMA_TASK_DATASETS`` routes); the config's
  default charge/spin tables and avg_degree 14, edge chunks of 32768 and
  remat; float32. ``UMA_INFO`` (charge 1, spin 1) is set on the atoms and
  the ``omat`` task routes the dataset. ``UMA_BF16_KW`` is the same at
  ``dtype="bfloat16"``.

The batched and serving phases run on bench.py's batched/serving pool
(``batched_pool``: copies of the 32-atom reps=2 crystal, each with its own
0.04 Å noise, ``bench.py:343-365``, ``:407-414``) and on a mixed batch of
reps 2, 3 and 4 plus one atom alone in a 12 Å box (``mixed_batch``: 32,
108, 256 and 1 atoms; the lone atom has no edge).

The training phases run on bench.py's train set (``batched_pool(8,
reps=3)``: 8 copies of the 108-atom crystal, each with its own 0.04 Å
noise, ``bench.py:518-531``), labelled by a teacher of the same
architecture through ``BatchedPotential`` (``train_samples``).

All single-structure phases run on bench.py's perturbed Si crystal (lattice 3.9 Å per 4-atom
cell, 0.04 Å noise, seed 0): ``reps=8`` gives 2048 atoms; bench.py's own
default is reps=16 (16384 atoms). MACE and eSCN run at reps=8, cut from
bench.py's 16384 atoms to keep each step of ``chip_smoke.py`` short: at
l_max 4 and C 128 eSCN's SO(2) products alone are 4.75 MFLOP per edge row
per layer, and 16384 atoms would make every eSCN step ~8x longer.
"""

from __future__ import annotations

import numpy as np

MACE_KW = dict(num_species=95, channels=128, l_max=3, a_lmax=3, hidden_lmax=1,
               correlation=3, num_interactions=2, num_bessel=8, radial_mlp=64,
               cutoff=5.0, avg_num_neighbors=14.0, remat=True,
               edge_chunk=32768, node_chunk=4096)
TENSORNET_KW = dict(num_species=89, units=64, num_rbf=32, num_layers=2, cutoff=5.0)
CHGNET_KW = dict(num_species=89, units=64, num_rbf=31, num_angle=4, num_blocks=4,
                 cutoff=6.0, bond_cutoff=3.0)
ESCN_KW = dict(num_species=95, channels=128, l_max=4, num_layers=2, num_experts=8,
               cutoff=5.0, avg_num_neighbors=40.0, num_bessel=8, edge_channels=32,
               edge_chunk=32768, remat=True)
ESCN_INFO = {"charge": 1, "spin": 1, "dataset": 2}
UMA_KW = dict(max_num_elements=100, sphere_channels=128, lmax=2, mmax=2, num_layers=4,
              hidden_channels=128, edge_channels=128, num_distance_basis=64, num_experts=32,
              cutoff=6.0, num_datasets=4, edge_chunk=32768, remat=True)
UMA_INFO = {"charge": 1, "spin": 1}
UMA_BF16_KW = dict(UMA_KW, dtype="bfloat16")
MACE_BF16_KW = dict(MACE_KW, dtype="bfloat16")
ESCN_BF16_KW = dict(ESCN_KW, dtype="bfloat16")
TENSORNET_BF16_KW = dict(TENSORNET_KW, dtype="bfloat16")
CHGNET_BF16_KW = dict(CHGNET_KW, dtype="bfloat16")


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


def batched_pool(n: int, reps: int = 2, seed: int = 0):
    """bench.py's batched and serving pool: ``n`` copies of the 4 * reps^3
    atom Si crystal, each with its own 0.04 Å noise, and the generator."""
    from .. import geometry
    from ..calculators import Atoms

    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lattice = geometry.make_supercell(unit, np.eye(3) * 3.9, (reps, reps, reps))
    base = geometry.frac_to_cart(frac, lattice)
    pool = [Atoms(numbers=np.full(len(base), 14),
                  positions=base + rng.normal(0, 0.04, base.shape), cell=lattice)
            for _ in range(n)]
    return pool, rng


def mixed_batch(seed: int = 1):
    """Structures of 32, 108 and 256 atoms (reps 2, 3, 4 of the crystal) and
    one Si atom alone in a 12 Å cubic box, which has no edge."""
    from ..calculators import Atoms

    out = [batched_pool(1, reps, seed + reps)[0][0] for reps in (2, 3, 4)]
    out.append(Atoms(numbers=[14], positions=[[0.3, 0.2, 0.1]], cell=np.eye(3) * 12.0))
    return out


def train_samples(model, teacher, info=None, n: int = 8, reps: int = 3, seed: int = 0,
                  device="cuda"):
    """bench.py's train set (``batched_pool(n, reps)``) labelled with the
    energies, forces and stresses of ``model`` at the ``teacher``
    parameters through ``BatchedPotential`` on ``device``; ``info`` (the
    conditioning dict) is set on every structure. Returns ``list[Sample]``."""
    from ..calculators import BatchedPotential
    from ..train import Sample

    pool, _ = batched_pool(n, reps, seed)
    for a in pool:
        a.info = dict(info or {})
    results = BatchedPotential(model, teacher, device=device).calculate(pool)
    return [Sample(a, float(r["energy"]), np.asarray(r["forces"], dtype=np.float32),
                   np.asarray(r["stress"], dtype=np.float32))
            for a, r in zip(pool, results)]
