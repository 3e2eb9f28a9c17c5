"""Slab graph parallelism end to end for eSCN (charge, spin and dataset set,
4 experts): ``DistPotential(num_partitions=P)`` at P = 2, 3 and 4, JAX vs
port and port vs port at P = 1, on ``tests/test_torch_parallel.py``'s
64-atom cell with its helpers and bar. The MOLE gate pools the composition
over owned atoms of every partition (the JAX package's ``psum``): on the
flattened graph that sum already covers every partition, so ``psum`` is
the identity, and a gate computed per partition would show here.
"""

import pytest

from tests.test_torch_parallel import cases, check_family_at  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("P", [2, 3, 4])
def test_parallel_escn_matches_jax_and_p1(cases, P):  # noqa: F811
    check_family_at(cases, "escn", P)
