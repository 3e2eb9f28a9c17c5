"""bfloat16 compute for eSCN, port against the JAX package on the CPU:
``tests/test_torch_bf16.py``'s checks (c) and (d) for eSCN (C 16, l_max 2,
4 experts, charge/spin/dataset set), at P = 1 and P = 2, with that file's
bars and its shared results fixture. A file of its own so that the two
families' JAX compiles run on two test workers.
"""

import pytest

from tests.test_torch_bf16 import check_against_float32, check_matches_jax, results  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("P", [1, 2])
def test_bf16_matches_jax(results, P):  # noqa: F811
    check_matches_jax(results, "escn", P)


def test_bf16_against_the_ports_float32(results):  # noqa: F811
    check_against_float32(results, "escn")
