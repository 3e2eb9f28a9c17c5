"""PyTorch port tests that need an NVIDIA card, plus the shared kernel cases.

This file imports no JAX, so it also runs on a GPU machine without JAX
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Without a card every test here skips with its reason. The dst-sorted cases
are shared with ``tests/test_torch_segment.py``, which holds the port's
plain version against the JAX package on the same cases.
"""

import numpy as np
import pytest
import torch


def sorted_case(seed, e, n, pad, interior_masked=0, hi=None):
    """dst-sorted ids in [0, hi) with a repeated-tail padding block (mask
    false) and some masked interior rows."""
    rng = np.random.default_rng(seed)
    hi = n if hi is None else hi
    ids = np.sort(rng.integers(0, hi, e)).astype(np.int32)
    last = ids[-1] if e else 0
    ids = np.concatenate([ids, np.full(pad, last, np.int32)])
    mask = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])
    if interior_masked:
        mask[rng.choice(e, interior_masked, replace=False)] = False
    return ids, mask, n


CASES = {
    # name: (seed, e, n, pad, interior_masked, hi, trailing)
    "repeated_tail_padding": (0, 300, 37, 40, 0, None, (7,)),
    "empty_segments": (1, 120, 60, 10, 5, 20, (3,)),
    "e_not_multiple_of_256": (2, 517, 45, 3, 9, None, (4,)),
    "n_not_multiple_of_128": (3, 700, 131, 25, 11, None, (2,)),
    "trailing_q_c": (4, 260, 29, 12, 4, None, (5, 8)),
    "scalar_rows": (5, 90, 13, 6, 2, None, ()),
    "width_one": (6, 90, 13, 6, 2, None, (1,)),
    "long_padded_tail": (7, 400, 50, 5000, 3, None, (16,)),
}


def case_data(seed, e, trailing):
    return np.random.default_rng(100 + seed).normal(
        size=(e,) + trailing).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_on_card(card, name):
    """Kernel vs plain version on the card. float32 in two summation
    orders: each output may differ by up to 2 k u sum|x| (k = the row's
    edge count, u = 2^-24)."""
    from distmlip_tpu_torch.kernels import (launch_counts, segment_sum_cuda,
                                            segment_sum_reference)

    seed, e, n, pad, im, hi, trailing = CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    data = torch.from_numpy(case_data(seed, len(ids), trailing)).to(card)
    ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
    before = launch_counts["segment_sum"]
    got = segment_sum_cuda(data, ti, n, tm)
    want = segment_sum_reference(data, ti, n, tm)
    torch.cuda.synchronize()
    assert launch_counts["segment_sum"] == before + 1
    k = max(int(np.bincount(ids, minlength=n).max()), 1)
    bound = 2 * k * 2.0 ** -24 * segment_sum_reference(data.abs(), ti, n, tm)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= bound + 1e-30).all()), name


@pytest.mark.cuda
def test_cuda_kernel_edge_cases_on_card(card):
    from distmlip_tpu_torch.kernels import fused_segment_sum, segment_sum_cuda

    ids = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32, device=card)
    data = torch.arange(10, dtype=torch.float32, device=card).reshape(5, 2)
    none = torch.zeros(5, dtype=torch.bool, device=card)
    assert not segment_sum_cuda(data, ids, 4, none).any()
    out = segment_sum_cuda(data, ids, 4, None)
    torch.testing.assert_close(out.cpu(), torch.tensor(
        [[2.0, 4.0], [0.0, 0.0], [18.0, 21.0], [0.0, 0.0]]))
    assert segment_sum_cuda(data[:0], ids[:0], 3, none[:0]).shape == (3, 2)
    with pytest.raises(TypeError):
        segment_sum_cuda(data.double(), ids, 4, None)
    with pytest.raises(ValueError):
        segment_sum_cuda(data.t(), ids[:2], 4, None)
    # the Function's backward on the card: g[ids] * mask
    d = data.clone().requires_grad_(True)
    m = torch.tensor([True, False, True, True, False], device=card)
    (g,) = torch.autograd.grad(
        fused_segment_sum(d, ids, 4, m, indices_are_sorted=True).sum(), d)
    torch.testing.assert_close(g, m[:, None].float().expand(5, 2))


@pytest.mark.cuda
def test_mace_on_card_matches_cpu(card):
    """The slice at small size: the port on the card (kernels on) vs the
    port on the CPU (plain versions), same params and structure."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
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
    before = launch_counts["segment_sum"]
    gpu = DistPotential(model, params, device=card).calculate(atoms)
    assert launch_counts["segment_sum"] > before
    cpu = DistPotential(model, params, device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) < 1e-5 * abs(cpu["energy"])
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=1e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-4)
