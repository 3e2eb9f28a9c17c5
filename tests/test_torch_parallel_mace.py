"""Slab graph parallelism end to end for MACE: ``DistPotential(
num_partitions=P)`` at P = 2, 3 and 4, JAX vs port and port vs port at
P = 1, on ``tests/test_torch_parallel.py``'s 64-atom cell with its
helpers and bar (rel dE < 1e-5, max |dF| < 1e-4 eV/Å with border atoms
apart, max |dS| < 1e-4 eV/Å^3). Edge chunks of 128 rows: the split layout
pads the interior and frontier segments to chunks of their own
(``ops.chunk.chunk_layout`` with ``e_split``), so no chunk straddles it.
"""

import pytest

from distmlip_tpu_torch.ops.chunk import chunk_layout
from tests.test_torch_parallel import FAMILIES, cases, check_family_at  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("P", [2, 3, 4])
def test_parallel_mace_matches_jax_and_p1(cases, P):  # noqa: F811
    check_family_at(cases, "mace", P)


def test_chunks_do_not_straddle_the_split():
    """With the split passed, every chunk lies inside one segment; without
    it one chunk would straddle the boundary."""
    chunk = FAMILIES["mace"][1]["edge_chunk"]
    e_cap, e_split = 1000, 300
    rows, valid, K, c = chunk_layout(e_cap, chunk, e_split)
    for k in range(K):
        seg = rows[k * c:(k + 1) * c]
        assert (seg < e_split).all() or (seg >= e_split).all()
    assert (valid.sum(), K) == (e_cap, 3 + 6)
    rows0 = chunk_layout(e_cap, chunk)[0]
    assert any((rows0[k * c:(k + 1) * c] < e_split).any()
               and (rows0[k * c:(k + 1) * c] >= e_split).any() for k in range(K))
