"""PyTorch port tests that need an NVIDIA card, plus the shared kernel cases.

This file imports no JAX, so it also runs on a GPU machine without JAX
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Without a card every test here skips with its reason. The dst-sorted cases,
the TensorNet and CHGNet message inputs and the eSCN SO(2) inputs are
shared with ``tests/test_torch_segment.py``,
``tests/test_torch_edge_aggregate.py`` and ``tests/test_torch_so2_conv.py``,
which hold the port's plain versions against the JAX package on the same
cases.
"""

import contextlib
import signal
from unittest import mock

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


def embed_inputs(seed, e, c):
    """TensorNet embed inputs: Z, W1, W2, W3 (E, C); A_e, S_e (E, 3, 3, 1)."""
    rng = np.random.default_rng(200 + seed)
    rows = [rng.normal(size=(e, c)).astype(np.float32) for _ in range(4)]
    geo = [rng.normal(size=(e, 3, 3, 1)).astype(np.float32) for _ in range(2)]
    return rows + geo


def interaction_inputs(seed, e, n_node, c):
    """TensorNet interaction inputs: f (E, C, 3); the compact node rows
    i (N_node, C), a (N_node, 3, C), s (N_node, 6, C), every entry drawn
    on its own (so a swapped or mis-signed entry shows); src (E,) int32."""
    rng = np.random.default_rng(300 + seed)
    f = rng.normal(size=(e, c, 3)).astype(np.float32)
    nodes = [rng.normal(size=(n_node,) + k + (c,)).astype(np.float32)
             for k in ((), (3,), (6,))]
    src = rng.integers(0, n_node, e).astype(np.int32)
    return [f] + nodes + [src]


# name: (seed, e, n, pad, interior_masked, hi, channels)
EDGE_AGG_CASES = {
    "repeated_tail_padding": (0, 300, 37, 40, 0, None, 8),
    "empty_rows": (1, 120, 60, 10, 5, 20, 16),
    "e_not_multiple_of_block": (2, 517, 45, 3, 9, None, 5),
    "channels_not_multiple_of_4": (3, 260, 29, 12, 4, None, 7),
    "channels_past_a_block": (4, 90, 13, 6, 2, None, 300),
    "long_padded_tail": (5, 400, 50, 5000, 3, None, 4),
}


# name: (seed, e, n, pad, interior_masked, hi, channels, hidden)
CHGNET_CASES = {
    "repeated_tail_padding": (0, 300, 37, 40, 0, None, 8, 8),
    "empty_rows": (1, 120, 60, 10, 5, 20, 16, 16),
    "e_not_multiple_of_block": (2, 517, 45, 3, 9, None, 16, 12),
    "channels_7": (3, 260, 29, 12, 4, None, 7, 7),
    "long_padded_tail": (5, 400, 50, 5000, 3, None, 4, 6),
    "matgl_widths": (6, 700, 40, 30, 20, None, 64, 64),
    "hidden_32_channels_64": (8, 600, 50, 20, 10, None, 64, 32),
    "hidden_64_channels_24": (9, 333, 41, 7, 5, None, 24, 64),
}


def chgnet_inputs(seed, which, e, c, h, n_node=23):
    """Inputs of one CHGNet message at (E, C), hidden width H, in the order
    of its plain version up to ``weights``: the atom conv's node array
    (N, C) gathered at src and at dst, e and abw (E, C); the line conv's
    bond array (N, C) gathered at line_src and at line_dst, the angle rows
    (E, C) and the node array (N, C) at the centers. Then the gated MLP's
    8 weights (core w1 (K1, H), b1, w2 (H, C), b2, then the gate's) at the
    scale of a linear init."""
    rng = np.random.default_rng(400 + seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def idx():
        return rng.integers(0, n_node, e).astype(np.int32)

    if which == "atom":
        node = f32(n_node, c)
        arrays, k1 = [node, idx(), node, idx(), f32(e, c), f32(e, c)], 3 * c
    else:
        bond = f32(n_node, c)
        arrays, k1 = [bond, idx(), bond, idx(), f32(e, c), f32(n_node, c), idx()], 4 * c
    weights = []
    for _ in range(2):
        weights += [f32(k1, h) / k1 ** 0.5, f32(h) / k1 ** 0.5,
                    f32(h, c) / h ** 0.5, f32(c) / h ** 0.5]
    return arrays, [w.astype(np.float32) for w in weights]


def chgnet_rows(which, arrays):
    """(the concat rows (E, K1) of a CHGNet message, its abw or None) from
    torch tensors in ``chgnet_inputs``' order."""
    g = lambda node, i: node.index_select(0, i.long())  # noqa: E731
    if which == "atom":
        node_src, src, node_dst, dst, edge, abw = arrays
        return torch.cat([g(node_src, src), g(node_dst, dst), edge], -1), abw
    bond_src, ls, bond_dst, ld, angle, node, ctr = arrays
    return torch.cat([g(bond_src, ls), g(bond_dst, ld), angle, g(node, ctr)], -1), None


# name: (seed, e, l_max, channels): the slice's l_max 4 at small E, the
# ragged edges (E of 1, 37 and 1003, output widths that are no multiple of
# the kernel's 128-column tile) and C = 7, which takes the scalar-load path
SO2_CASES = {
    "e1_lmax1_c8": (0, 1, 1, 8),
    "e37_lmax2_c16": (1, 37, 2, 16),
    "e1003_lmax4_c8": (2, 1003, 4, 8),
    "e37_lmax6_c16": (3, 37, 6, 16),
    "e1003_lmax2_c128": (4, 1003, 2, 128),
    "e300_lmax4_c128": (5, 300, 4, 128),
    "e1003_lmax1_c7": (6, 1003, 1, 7),
}


def so2_inputs(seed, e, l_max, c):
    """eSCN SO(2) inputs: h (E, S, C) in the e3nn order, the model's m_idx
    (``CoeffLayout(l_max)``) and the weights [W0, W1r, W1i, ...], (d, d)
    with d = (l_max + 1 - m) C, at the init's 1/sqrt(d) scale."""
    from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout

    rng = np.random.default_rng(500 + seed)
    lay = CoeffLayout(l_max)
    m_idx = {m: (lay.plus_idx[m], lay.minus_idx[m]) for m in range(l_max + 1)}
    h = rng.normal(size=(e, (l_max + 1) ** 2, c)).astype(np.float32)
    weights = []
    for m in range(l_max + 1):
        d = (l_max + 1 - m) * c
        for _ in range(1 if m == 0 else 2):
            weights.append((rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32))
    return h, weights, m_idx


def edge_bound(ids, mask, n, abs_ref):
    """|kernel - plain| <= 2 (k + 3) u T per output element: k is the row's
    valid-edge count, u = 2^-24, T the plain version on |inputs| (the sum
    of |terms|); each term carries a few roundings, the sum k more."""
    k = np.bincount(ids[mask], minlength=n)[:n].astype(np.float64)
    k = torch.as_tensor(k, dtype=abs_ref.dtype, device=abs_ref.device)
    return 2 * (k + 3).reshape(-1, 1, 1, 1) * 2.0 ** -24 * abs_ref


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


def _edge_case_on_card(card, name, which):
    seed, e, n, pad, im, hi, c = EDGE_AGG_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    if which == "embed":
        arrays = embed_inputs(seed, len(ids), c)
    else:
        arrays = interaction_inputs(seed, len(ids), 23, c)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    return [to(x) for x in arrays], to(ids), to(mask), ids, mask, n


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["embed", "interaction"])
@pytest.mark.parametrize("name", sorted(EDGE_AGG_CASES))
def test_edge_aggregate_kernels_match_plain_on_card(card, name, which):
    """Both TensorNet kernels vs their plain versions on the card, within
    2 (k + 3) u T (``edge_bound``), on the shared cases and on an
    all-masked input."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_on_card(card, name, which)
    if which == "embed":
        cuda, ref = K.tensornet_embed_aggregate_cuda, K.tensornet_embed_aggregate_reference
        count = "tensornet_embed_aggregate"
    else:
        cuda = K.tensornet_interaction_aggregate_cuda
        ref = K.tensornet_interaction_aggregate_reference
        count = "tensornet_interaction_aggregate"
    before = K.launch_counts[count]
    got = cuda(*arrays, ti, n, tm)
    want = ref(*arrays, ti, n, tm)
    torch.cuda.synchronize()
    assert K.launch_counts[count] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    if which == "embed":
        abs_arrays = [x.abs() for x in arrays]
        bound = edge_bound(ids, mask, n, ref(*abs_arrays, ti, n, tm))
    else:
        bound = K.tensornet_interaction_error_bound(*arrays, ti, n, tm)
    assert bool(((got - want).abs() <= bound + 1e-30).all()), name
    none = torch.zeros_like(tm)
    assert not cuda(*arrays, ti, n, none).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_AGG_CASES))
def test_interaction_backward_kernel_matches_plain_on_card(card, name):
    """The interaction's backward kernel vs its plain version on the card,
    within ``tensornet_interaction_backward_error_bound``, on the shared
    cases (masked tail, empty rows, C = 5 and 300), then all masked (every
    output zero); a second call gives the same bits (fixed order)."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_on_card(card, name, "interaction")
    c = arrays[0].shape[1]
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(n, 3, 3, c)).astype(
        np.float32)).to(card)
    before = K.launch_counts["tensornet_interaction_backward"]
    got = K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm)
    want = K.tensornet_interaction_backward_reference(g, *arrays, ti, tm)
    torch.cuda.synchronize()
    assert K.launch_counts["tensornet_interaction_backward"] == before + 1
    bounds = K.tensornet_interaction_backward_error_bound(g, *arrays, ti, tm)
    for x, y, b in zip(got, want, bounds):
        assert x.shape == y.shape and x.dtype == torch.float32
        assert bool(((x - y).abs() <= b + 1e-30).all()), name
    assert not got[0][~tm].any()
    none = K.tensornet_interaction_backward_cuda(g, *arrays, ti, torch.zeros_like(tm))
    assert all(not x.any() for x in none)
    for x, y in zip(K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm), got):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_edge_aggregate_dispatch_on_card(card):
    """The Function on the card: kernels=True launches the forward and, in
    the backward, the backward kernel (no plain recompute); kernels=False
    runs the plain version; a message without a kernel raises; both
    backwards agree."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_on_card(card, "empty_rows", "interaction")
    f, node_i, node_a, node_s, src = arrays
    inputs = lambda *xs: (xs[0], K.Gather(xs[1], src), K.Gather(xs[2], src),  # noqa: E731
                          K.Gather(xs[3], src))
    leaves = [x.clone().requires_grad_(True) for x in (f, node_i, node_a, node_s)]
    fwd, bwd = "tensornet_interaction_aggregate", "tensornet_interaction_backward"
    before = dict(K.launch_counts)
    chunks = K.recompute_chunks.get(fwd, 0)
    out = K.fused_edge_aggregate(K.TENSORNET_INTERACTION, inputs(*leaves), ti, n, tm)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    assert K.launch_counts[fwd] == before[fwd] + 1
    assert K.launch_counts[bwd] == before[bwd] + 1
    assert K.recompute_chunks.get(fwd, 0) == chunks
    plain = K.fused_edge_aggregate(K.TENSORNET_INTERACTION, inputs(*leaves), ti, n, tm,
                                   kernels=False)
    want = torch.autograd.grad((plain ** 2).sum(), leaves)
    assert K.launch_counts[fwd] == before[fwd] + 1
    assert K.launch_counts[bwd] == before[bwd] + 1
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    no_kernel = K.EdgeMessage("no_kernel", K.TENSORNET_INTERACTION.fn)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        K.fused_edge_aggregate(no_kernel, inputs(f, node_i, node_a, node_s), ti, n, tm)


@pytest.mark.cuda
def test_interaction_double_backward_on_card_takes_the_plain_route(card):
    """Under create_graph (force-loss training) the backward is the plain
    chunked recompute, in differentiable ops, even with kernels=True; the
    second pass reaches the forward's Function once more, first order, and
    launches the backward kernel once. The second-order gradients match
    kernels=False."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_on_card(card, "repeated_tail_padding",
                                                      "interaction")
    src = arrays[4]

    def second_order(kernels):
        leaves = [x.clone().requires_grad_(True) for x in arrays[:4]]
        out = K.fused_edge_aggregate(
            K.TENSORNET_INTERACTION,
            [leaves[0]] + [K.Gather(x, src) for x in leaves[1:]], ti, n, tm,
            kernels=kernels, bwd_chunk=64)
        grads = torch.autograd.grad((out ** 2).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((x ** 2).sum() for x in grads), leaves)

    bwd = "tensornet_interaction_backward"
    before = K.launch_counts[bwd]
    chunks = K.recompute_chunks.get("tensornet_interaction_aggregate", 0)
    got = second_order(True)
    assert K.launch_counts[bwd] == before + 1
    assert K.recompute_chunks["tensornet_interaction_aggregate"] == chunks + 6  # 340 / 64
    # float32 in other summation orders, against each tensor's scale (its
    # entries reach ~5e5 here, some cancel to ~10): 1e-5 of the largest
    for a, b in zip(got, second_order(False)):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_tensornet_on_card_matches_cpu(card):
    """TensorNet at small size: the port on the card (kernels on) vs on the
    CPU (plain versions), same params and structure."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 4.0, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (32, 3))
    atoms = Atoms(numbers=rng.integers(0, 3, 32), positions=cart, cell=lat)
    model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=4.0))
    params = model.init(0)
    before = dict(launch_counts)
    gpu = DistPotential(model, params, device=card).calculate(atoms)
    for name in ("tensornet_interaction_aggregate", "tensornet_interaction_backward"):
        assert launch_counts[name] == before[name] + 2
    cpu = DistPotential(model, params, device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) < 1e-5 * abs(cpu["energy"])
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=1e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-4)


def _chgnet_case_on_card(card, name, which):
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    return [to(x) for x in arrays], [to(w) for w in weights], to(ids), to(mask), n


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_CASES))
def test_chgnet_kernels_match_plain_on_card(card, name, which):
    """Both CHGNet kernels vs their plain versions on the card, within the
    derived bound ``chgnet_aggregate_error_bound``, on the shared cases and
    on an all-masked input."""
    from distmlip_tpu_torch import kernels as K

    arrays, weights, ti, tm, n = _chgnet_case_on_card(card, name, which)
    if which == "atom":
        cuda, ref = K.chgnet_atom_conv_aggregate_cuda, K.chgnet_atom_conv_aggregate_reference
        count = "chgnet_atom_conv_aggregate"
    else:
        cuda, ref = K.chgnet_line_aggregate_cuda, K.chgnet_line_aggregate_reference
        count = "chgnet_line_aggregate"
    before = K.launch_counts[count]
    got = cuda(*arrays, weights, ti, n, tm)
    want = ref(*arrays, weights, ti, n, tm)
    torch.cuda.synchronize()
    assert K.launch_counts[count] == before + 1
    assert got.shape == want.shape == (n, arrays[4].shape[1]) and got.dtype == torch.float32
    x, abw = chgnet_rows(which, arrays)
    bound = K.chgnet_aggregate_error_bound(x, abw, weights, ti, n, tm)
    assert bool(((got - want).abs() <= bound + 1e-30).all()), name
    assert not cuda(*arrays, weights, ti, n, torch.zeros_like(tm)).any()
    if which == "atom":  # no per-edge weights (shared_bond_weights=None)
        got = cuda(*arrays[:5], None, weights, ti, n, tm)
        want = ref(*arrays[:5], None, weights, ti, n, tm)
        bound = K.chgnet_aggregate_error_bound(x, None, weights, ti, n, tm)
        assert bool(((got - want).abs() <= bound + 1e-30).all()), name


@pytest.mark.cuda
def test_chgnet_dispatch_on_card(card):
    """The Function on the card with weights: the kernel launches once, the
    backward (inputs and weights) matches the plain path's, and weights
    that need no gradient get none."""
    from distmlip_tpu_torch import kernels as K

    arrays, weights, ti, tm, n = _chgnet_case_on_card(card, "empty_rows", "line")
    bond, ls, _, ld, angle, node, ctr = arrays
    leaves = [x.clone().requires_grad_(True) for x in (bond, angle, node)]
    wl = [w.clone().requires_grad_(True) for w in weights]

    def run(kernels):
        b, a, v = leaves
        out = K.fused_edge_aggregate(
            K.CHGNET_LINE_CONV, [K.Gather(b, ls), K.Gather(b, ld), a, K.Gather(v, ctr)],
            ti, n, tm, kernels=kernels, weights=wl)
        return out, torch.autograd.grad((out ** 2).sum(), leaves + wl)

    before = K.launch_counts["chgnet_line_aggregate"]
    out, got = run(True)
    assert K.launch_counts["chgnet_line_aggregate"] == before + 1
    plain, want = run(False)
    assert K.launch_counts["chgnet_line_aggregate"] == before + 1
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_chgnet_on_card_matches_cpu(card):
    """CHGNet at small size with magmoms: the port on the card (kernels on)
    vs on the CPU (plain versions), same params and structure."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.1, (32, 3))
    atoms = Atoms(numbers=rng.integers(0, 4, 32), positions=cart, cell=lat)
    model = CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_blocks=3,
                                cutoff=3.2, bond_cutoff=2.6))
    params = model.init(0)
    before = dict(launch_counts)
    gpu = DistPotential(model, params, device=card, skin=0.5,
                        compute_magmom=True).calculate(atoms)
    assert launch_counts["chgnet_atom_conv_aggregate"] == before["chgnet_atom_conv_aggregate"] + 3
    assert launch_counts["chgnet_line_aggregate"] == before["chgnet_line_aggregate"] + 2
    # one row projection per atom conv (v at src and dst is one tensor), two
    # per line conv (the bond rows, the atom rows)
    assert launch_counts["chgnet_row_projection"] == before["chgnet_row_projection"] + 3 + 2 * 2
    cpu = DistPotential(model, params, device="cpu", skin=0.5,
                        compute_magmom=True).calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) < 1e-5 * abs(cpu["energy"])
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=1e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-4)
    np.testing.assert_allclose(gpu["magmoms"], cpu["magmoms"], atol=1e-4)


# name: (rows, K, M, bias): the row projection's tiles, ragged rows and
# columns, K not a multiple of 4 or of the 8-deep slice
PROJECTION_CASES = {
    "one_row": (1, 8, 48, True),
    "k7_ragged": (517, 7, 24, True),
    "k16_no_bias": (300, 16, 64, False),
    "matgl_node_table": (1003, 64, 256, True),
    "matgl_center_table": (129, 64, 128, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROJECTION_CASES))
def test_chgnet_row_projection_matches_plain_on_card(card, name):
    """The row projection kernel vs ``x @ w + bias`` within
    ``chgnet_projection_error_bound``; one launch counted."""
    from distmlip_tpu_torch import kernels as K

    rows, k, m, has_bias = PROJECTION_CASES[name]
    rng = np.random.default_rng(700 + rows)
    x = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(card) if has_bias else None
    before = K.launch_counts["chgnet_row_projection"]
    got = K.chgnet_row_projection_cuda(x, w, b)
    torch.cuda.synchronize()
    assert K.launch_counts["chgnet_row_projection"] == before + 1
    want = K.chgnet_row_projection_reference(x, w, b)
    bound = K.chgnet_projection_error_bound(x, w, b)
    assert got.shape == (rows, m) and bool(((got - want).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
def test_chgnet_kernels_nonfinite_unreached_rows_on_card(card, which):
    """NaN in the node and bond rows that no valid edge gathers: their
    partial rows are projected but never read, so the output stays finite
    and within the bound of the plain version."""
    from distmlip_tpu_torch import kernels as K

    seed, e, n, pad, im, hi, c, h = CHGNET_CASES["matgl_widths"]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h, n_node=2000)
    t = [torch.from_numpy(x).to(card) for x in arrays]
    t[2] = t[0]  # one node (bond) tensor at both ends, as the model calls it
    tw = [torch.from_numpy(w).to(card) for w in weights]
    ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
    gathers = {0: [1, 3]} if which == "atom" else {0: [1, 3], 5: [6]}
    for k, idx in gathers.items():
        used = torch.zeros(t[k].shape[0], dtype=torch.bool, device=card)
        for i in idx:
            used[t[i][tm].long()] = True
        assert not bool(used.all())
        t[k][~used] = float("nan")
    cuda, ref = ((K.chgnet_atom_conv_aggregate_cuda, K.chgnet_atom_conv_aggregate_reference)
                 if which == "atom" else
                 (K.chgnet_line_aggregate_cuda, K.chgnet_line_aggregate_reference))
    got = cuda(*t, tw, ti, n, tm)
    want = ref(*t, tw, ti, n, tm)
    torch.cuda.synchronize()
    x, abw = chgnet_rows(which, t)
    bound = K.chgnet_aggregate_error_bound(x, abw, tw, ti, n, tm)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
def test_chgnet_kernels_two_row_tensors_on_card(card, which):
    """Distinct tensors at the two gathered ends (node_src, node_dst; bond_src,
    bond_dst): one projection pass each, and the result within the bound;
    one tensor at both ends takes one pass for the two."""
    from distmlip_tpu_torch import kernels as K

    seed, e, n, pad, im, hi, c, h = CHGNET_CASES["hidden_32_channels_64"]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    t = [torch.from_numpy(x).to(card) for x in arrays]
    tw = [torch.from_numpy(w).to(card) for w in weights]
    ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
    cuda, ref = ((K.chgnet_atom_conv_aggregate_cuda, K.chgnet_atom_conv_aggregate_reference)
                 if which == "atom" else
                 (K.chgnet_line_aggregate_cuda, K.chgnet_line_aggregate_reference))
    extra = 0 if which == "atom" else 1  # the line conv's atom rows
    for same in (True, False):
        t[2] = t[0] if same else t[0].flip(0).contiguous() * 0.5
        before = K.launch_counts["chgnet_row_projection"]
        got = cuda(*t, tw, ti, n, tm)
        want = ref(*t, tw, ti, n, tm)
        torch.cuda.synchronize()
        assert K.launch_counts["chgnet_row_projection"] == before + (1 if same else 2) + extra
        x, abw = chgnet_rows(which, t)
        bound = K.chgnet_aggregate_error_bound(x, abw, tw, ti, n, tm)
        assert bool(((got - want).abs() <= bound + 1e-30).all()), same


@pytest.mark.cuda
def test_chgnet_kernels_refuse_widths_past_64_on_card(card):
    """C or H past 64 raises before any launch (the kernels keep W1's edge
    block and [W2c | W2g] in shared memory, one 128-column pass a layer)."""
    from distmlip_tpu_torch import kernels as K

    for c, h in ((65, 8), (8, 65)):
        ids, mask, n = sorted_case(1, 40, 9, 3)
        arrays, weights = chgnet_inputs(1, "atom", len(ids), c, h)
        t = [torch.from_numpy(x).to(card) for x in arrays]
        tw = [torch.from_numpy(w).to(card) for w in weights]
        before = dict(K.launch_counts)
        with pytest.raises(ValueError, match="too wide"):
            K.chgnet_atom_conv_aggregate_cuda(*t, tw, torch.from_numpy(ids).to(card), n,
                                              torch.from_numpy(mask).to(card))
        assert K.launch_counts == before


def _so2_case_on_card(card, name):
    from distmlip_tpu_torch.kernels import packed_m_layout

    seed, e, l_max, c = SO2_CASES[name]
    h, weights, m_idx = so2_inputs(seed, e, l_max, c)
    perm, inv, segments = packed_m_layout(m_idx)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    return to(h), [to(w) for w in weights], perm, inv, segments, c, m_idx


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SO2_CASES))
def test_so2_conv_kernel_matches_plain_on_card(card, name):
    """The SO(2) kernel vs its plain version on the card, in the packed
    order and reading/writing the e3nn order through its row table, within
    the derived bound ``so2_conv_error_bound`` (2 k u sum|terms|, k the
    contraction length)."""
    from distmlip_tpu_torch import kernels as K

    h, weights, perm, inv, segments, c, _ = _so2_case_on_card(card, name)
    hp = h[:, torch.as_tensor(perm, device=card).long()].contiguous()
    bound = K.so2_conv_error_bound(hp, weights, segments, c)
    before = K.launch_counts["so2_conv"]
    got = K.so2_conv_cuda(hp, weights, segments, c, np.arange(h.shape[1]))
    want = K.so2_conv_reference(hp, weights, segments, c)
    torch.cuda.synchronize()
    assert K.launch_counts["so2_conv"] == before + 1
    assert got.shape == want.shape == h.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all()), name
    # the model's order through the row table: the same values, permuted
    got_src = K.so2_conv_cuda(h, weights, segments, c, perm)
    inv_t = torch.as_tensor(inv, device=card).long()
    assert bool(((got_src - want[:, inv_t]).abs() <= bound[:, inv_t] + 1e-30).all())


@pytest.mark.cuda
def test_so2_conv_gradients_on_card(card):
    """fused_so2_conv on the card: the kernel launches once forward and once
    more in the backward for h's cotangent (the same Function on the
    transposed weight set; the plain path launches none), and the h and
    weight gradients through it match the plain path's within the kernel's
    bound; a force-style backward (weights without grad) asks for no weight
    cotangent."""
    from distmlip_tpu_torch import kernels as K

    h, weights, _, _, _, c, m_idx = _so2_case_on_card(card, "e1003_lmax4_c8")
    hl = h.clone().requires_grad_(True)
    wl = [w.clone().requires_grad_(True) for w in weights]

    def run(kernels):
        out = K.fused_so2_conv(hl, wl, m_idx, c, kernels=kernels)
        return out, torch.autograd.grad((out ** 2).sum(), [hl] + wl)

    before = K.launch_counts["so2_conv"]
    out, got = run(True)
    assert K.launch_counts["so2_conv"] == before + 2
    plain, want = run(False)
    assert K.launch_counts["so2_conv"] == before + 2
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    out = K.fused_so2_conv(hl, weights, m_idx, c)
    (gh,) = torch.autograd.grad(out.sum(), hl)
    assert gh.shape == h.shape
    assert K.launch_counts["so2_conv"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SO2_CASES))
def test_so2_conv_backward_route_matches_the_plain_vjp_on_card(card, name):
    """The backward's route: the kernel on the transposed weight set with the
    swapped packed buffers, against the plain VJP's input cotangent
    (``_so2_vjp``), within ``so2_conv_error_bound`` of that set; and the
    Function's own backward launches exactly that."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    h, weights, perm, inv, segments, c, m_idx = _so2_case_on_card(card, name)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=h.shape).astype(np.float32)).to(card)
    perm_t = torch.as_tensor(perm, device=card).long()
    inv_t = torch.as_tensor(inv, device=card).long()
    packed = K.pack_so2_weights(weights, segments, c)
    wt = dispatch._so2_transposed_weights(weights, segments)
    got = K.so2_conv_cuda(g, wt, segments, c, perm, packed=packed.transposed())
    want = dispatch._so2_vjp(h, weights, g, perm_t, inv_t, segments, c, True,
                             [False] * len(weights))[0]
    bound = K.so2_conv_error_bound(g[:, perm_t], wt, segments, c)[:, inv_t]
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= bound + 1e-30).all()), name
    hl = h.clone().requires_grad_(True)
    (gh,) = torch.autograd.grad(K.fused_so2_conv(hl, weights, m_idx, c, packed=packed), hl, g)
    torch.testing.assert_close(gh, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_so2_conv_wrapper_refuses_what_it_does_not_take(card):
    from distmlip_tpu_torch import kernels as K

    h, weights, perm, _, segments, c, _ = _so2_case_on_card(card, "e37_lmax2_c16")
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.so2_conv_cuda(h.cpu(), [w.cpu() for w in weights], segments, c, perm)
    with pytest.raises(ValueError, match="contiguous"):
        K.so2_conv_cuda(h.transpose(0, 1).contiguous().transpose(0, 1), weights,
                        segments, c, perm)
    with pytest.raises(TypeError, match="float32"):
        K.so2_conv_cuda(h.double(), weights, segments, c, perm)
    with pytest.raises(ValueError, match="weight"):
        K.so2_conv_cuda(h, weights[:-1] + [weights[-1].t()[:, :1].contiguous()],
                        segments, c, perm)
    with pytest.raises(ValueError, match="permutation"):
        K.so2_conv_cuda(h, weights, segments, c, np.zeros(len(perm), np.int32))
    # packed for 8 channels, not h's 16
    other = K.pack_so2_weights([w[:w.shape[0] // 2, :w.shape[1] // 2] for w in weights],
                               segments, 8)
    with pytest.raises(ValueError, match="packed weights"):
        K.so2_conv_cuda(h, weights, segments, c, perm, packed=other)
    with pytest.raises(ValueError, match="packed weights"):
        K.so2_conv_cuda(h, weights, segments, c, perm,
                        packed=K.pack_so2_weights([w.cpu() for w in weights], segments, c))
    assert K.so2_conv_cuda(h[:0], weights, segments, c, perm).shape == (0,) + h.shape[1:]


@pytest.mark.cuda
def test_escn_on_card_matches_cpu(card):
    """A small eSCN (C 16, l_max 2, 4 experts, conditioning set) on the card
    with kernels vs on the CPU with the plain versions, and its launches:
    per calculate, each layer's SO(2) kernel and each of the 1 + num_layers
    segment sums once per chunk forward and once in the backward's
    recompute of the checkpointed chunk body, and the SO(2) kernel once
    more per chunk for its input cotangent."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import ESCN, ESCNConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.1, (32, 3))
    atoms = Atoms(numbers=rng.integers(0, 4, 32), positions=cart, cell=lat,
                  info={"charge": 1, "spin": 2, "dataset": 3})
    cfg = ESCNConfig(num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6,
                     num_experts=4, cutoff=3.2, avg_num_neighbors=12.0, edge_chunk=256)
    model = ESCN(cfg)
    params = model.init(0)
    before = dict(launch_counts)
    pot = DistPotential(model, params, device=card, skin=0.5)
    gpu = pot.calculate(atoms)
    k = chunk_layout(pot.last_stats["e_cap"], cfg.edge_chunk)[2]
    assert k > 1
    assert launch_counts["so2_conv"] - before["so2_conv"] == cfg.num_layers * 3 * k
    assert (launch_counts["segment_sum"] - before["segment_sum"]
            == (1 + cfg.num_layers) * 2 * k)
    cpu = DistPotential(model, params, device="cpu", skin=0.5).calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) < 1e-5 * abs(cpu["energy"])
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=1e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-4)


@pytest.mark.cuda
def test_device_refresh_on_card_matches_cpu(card):
    """The on-device neighbor rebuild on card tensors against the same
    rebuild on the CPU: identical arrays (its float arithmetic is
    elementwise and in a fixed order, so both devices round alike). The
    cell list on a triclinic cell, a cell smaller than the cutoff and
    padded rows, then the refresh of a 2048-atom graph moved by ~0.2 Å."""
    from distmlip_tpu_torch.neighbors import (build_cell_list_spec, device_neighbor_list,
                                              neighbor_list_numpy)
    from distmlip_tpu_torch.partition import (build_partitioned_graph, build_plan,
                                              device_refresh_graph)
    from distmlip_tpu_torch.tools.workload import bench_atoms

    rng = np.random.default_rng(0)
    tri = np.array([[8.0, 0, 0], [2.5, 7.0, 0], [1.5, -2.0, 6.5]])
    for cart, lat, r, n_cap in ((rng.random((30, 3)) @ tri, tri, 3.2, 30),
                                (np.array([[0.5, 0.5, 0.5], [1.2, 0.4, 1.7]]),
                                 np.eye(3) * 2.0, 2.9, 2),
                                (rng.random((25, 3)) @ (np.eye(3) * 7.0), np.eye(3) * 7.0,
                                 2.8, 64)):
        pos = np.zeros((n_cap, 3), np.float32)
        pos[:len(cart)] = cart
        static, arrays = build_cell_list_spec(lat, [1, 1, 1], r, len(cart), n_cap, 8192,
                                              positions=cart)
        cpu = device_neighbor_list(static, arrays, torch.from_numpy(pos))
        gpu = device_neighbor_list(static, arrays, torch.from_numpy(pos).to(card))
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())

    atoms, _ = bench_atoms(8)
    r = 5.5
    nl = neighbor_list_numpy(atoms.positions, atoms.cell, atoms.pbc, r)
    plan = build_plan(nl, atoms.cell, atoms.pbc, 1, r)
    graph, host = build_partitioned_graph(plan, nl, atoms.numbers, atoms.cell)
    static, arrays = build_cell_list_spec(atoms.cell, atoms.pbc, r, len(atoms), graph.n_cap,
                                          graph.e_cap, positions=atoms.positions)
    moved = atoms.positions + rng.normal(0, 0.12, atoms.positions.shape)
    pos = torch.from_numpy(host.scatter_global(moved.astype(np.float32), graph.n_cap))
    outs = []
    for dev in ("cpu", card):
        g, n_edges, overflow = device_refresh_graph(
            static, {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
            graph.to(dev), pos.to(dev))
        assert not bool(overflow)
        outs.append((g, int(n_edges)))
    (gc, nc), (gg, ng) = outs
    assert nc == ng > 0
    for name in ("edge_src", "edge_dst", "edge_offset", "edge_mask"):
        assert torch.equal(getattr(gc, name), getattr(gg, name).cpu()), name


@pytest.mark.cuda
def test_mace_nve_on_card_matches_cpu(card):
    """10 nve steps of a small MACE on light atoms, with skin-cache
    invalidations refreshed on the device: the card's run (kernels) and the
    CPU's (plain) take the same refreshes and drift in total energy alike,
    within the float32 bar (1e-5 of the potential energy)."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential, MolecularDynamics
    from distmlip_tpu_torch.models import MACE, MACEConfig

    rng = np.random.default_rng(0)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 4.0, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (32, 3))
    model = MACE(MACEConfig(num_species=4, channels=16, l_max=3, a_lmax=3,
                            hidden_lmax=1, correlation=3, cutoff=4.0,
                            edge_chunk=64, node_chunk=16))
    params = model.init(0)
    runs = []
    for dev in (card, "cpu"):
        atoms = Atoms(numbers=np.arange(32) % 3 + 1, positions=cart, cell=lat)
        atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(3))
        pot = DistPotential(model, params, device=dev, skin=0.5)
        md = MolecularDynamics(atoms, pot, ensemble="nve", timestep=1.0)
        e0 = md.results["energy"] + atoms.kinetic_energy()
        md.run(10)
        drift = md.results["energy"] + atoms.kinetic_energy() - e0
        runs.append((drift, md.results["energy"], atoms.positions.copy(),
                     pot.rebuild_on_device_count, pot.rebuild_count))
    (dg, eg, pg, rg, cg), (dc, ec, pc, rc, cc) = runs
    assert rg >= 1 and (rg, cg) == (rc, cc) and cg == 1 + rg
    assert abs(dg - dc) < 1e-5 * abs(ec)
    assert abs(eg - ec) < 1e-5 * abs(ec)
    np.testing.assert_allclose(pg, pc, rtol=0, atol=1e-4)


def _long_cell(n_species=4, seed=1):
    """64 rattled fcc atoms (a = 3.5 Å, 1 x 2 x 8 cells): 28 Å along the
    slab axis, so P = 2 slabs are wider than twice a 3.0 Å cutoff."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (1, 2, 8))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.08, (len(frac), 3))
    return Atoms(numbers=rng.integers(0, n_species, len(cart)), positions=cart, cell=lat)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tensornet", "chgnet", "mace", "escn"])
def test_parallel_on_card_matches_cpu(card, family):
    """``DistPotential(num_partitions=2)`` on the card (kernels on, the two
    partitions as one flattened graph) against the same at P = 2 on the CPU
    (plain versions), and its launches: every edge aggregation once per
    segment (interior, frontier); the CHGNet line graph is one segment; the
    CHGNet atom conv projects v once in the interior (both ends read the
    pre-exchange rows) and twice in the frontier (src the exchanged rows,
    dst the pre-exchange ones); MACE and eSCN chunk each segment on its
    own."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    atoms = _long_cell()
    kw = {}
    if family == "tensornet":
        model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.0))
    elif family == "chgnet":
        model = CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_blocks=3,
                                    cutoff=3.0, bond_cutoff=2.6))
        kw = dict(compute_magmom=True)
    elif family == "mace":
        model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2,
                                hidden_lmax=1, correlation=2, cutoff=3.0, edge_chunk=128))
    else:
        model = ESCN(ESCNConfig(num_species=4, channels=16, l_max=2, num_layers=2,
                                num_bessel=6, num_experts=4, cutoff=3.0,
                                avg_num_neighbors=12.0, edge_chunk=128))
        atoms.info = {"charge": 1, "spin": 2, "dataset": 3}
    params = model.init(0)
    pot = DistPotential(model, params, device=card, num_partitions=2, **kw)
    before = dict(launch_counts)
    gpu = pot.calculate(atoms)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    st = pot.last_stats
    assert st["num_partitions"] == 2 and st["e_split"] < st["e_cap"]
    want = {k: 0 for k in got}
    if family == "tensornet":
        layers = model.cfg.num_layers
        want.update(tensornet_embed_aggregate=2, tensornet_interaction_aggregate=2 * layers,
                    tensornet_interaction_backward=2 * layers)
    elif family == "chgnet":
        blocks = model.cfg.num_blocks
        want.update(chgnet_atom_conv_aggregate=2 * blocks,
                    chgnet_line_aggregate=blocks - 1,
                    chgnet_row_projection=3 * blocks + 2 * (blocks - 1))
    else:
        k = chunk_layout(2 * st["e_cap"], model.cfg.edge_chunk, 2 * st["e_split"])[2]
        if family == "mace":
            want["segment_sum"] = model.cfg.num_interactions * 2 * k
        else:
            want.update(so2_conv=model.cfg.num_layers * 3 * k,
                        segment_sum=(1 + model.cfg.num_layers) * 2 * k)
    assert got == want
    cpu = DistPotential(model, params, device="cpu", num_partitions=2, **kw).calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) < 1e-5 * abs(cpu["energy"])
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], rtol=0, atol=1e-4)
    if "magmoms" in cpu:
        np.testing.assert_allclose(gpu["magmoms"], cpu["magmoms"], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_split_segments_on_card_match_plain(card):
    """B1 and the B2 kernels on the segment slices (``x[:s]``, ``x[s:]``) of
    a flattened P = 2 graph on the card, through the LocalGraph methods the
    models call, against the same methods with ``kernels=False`` on the
    card: each launches its kernel once per segment, and the results and
    the node-row cotangents (the TensorNet interaction's backward kernel
    on each segment) agree."""
    import dataclasses

    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.neighbors import neighbor_list_numpy
    from distmlip_tpu_torch.ops.nn import gated_mlp_weights
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.partition import build_partitioned_graph, build_plan

    atoms = _long_cell()
    nl = neighbor_list_numpy(atoms.positions, atoms.cell, atoms.pbc, 3.0, bond_r=2.6)
    plan = build_plan(nl, atoms.cell, atoms.pbc, 2, 3.0, 2.6, True)
    graph, _ = build_partitioned_graph(plan, nl, atoms.numbers, atoms.cell)
    lg = local_graph_from_stacked(graph.to(card))
    plain = dataclasses.replace(lg, kernels=False)
    s, n, e, c = lg.e_split, lg.n_cap, lg.e_cap, 16
    assert 0 < s < e and n == 2 * graph.n_cap
    rng = np.random.default_rng(0)
    to = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(card)

    def launched(name, fn):
        before = K.launch_counts[name]
        out = fn(lg)
        assert K.launch_counts[name] - before == 2, name  # interior, frontier
        torch.testing.assert_close(out, fn(plain), rtol=1e-5, atol=1e-4)
        assert K.launch_counts[name] - before == 2, name

    data = to(e, 12)
    launched("segment_sum", lambda g: g.aggregate_edges(data, g.edge_mask))
    embed = [to(e, c) for _ in range(4)] + [to(e, 3, 3, 1) for _ in range(2)]
    launched("tensornet_embed_aggregate",
             lambda g: g.aggregate_edge_messages(K.TENSORNET_EMBED, embed, g.edge_mask))
    f = to(e, c, 3)
    rows = [to(n, c), to(n, 3, c), to(n, 6, c)]

    def interaction(g):
        leaves = [r.clone().requires_grad_(True) for r in rows]
        out = g.aggregate_edge_messages(
            K.TENSORNET_INTERACTION, [f] + [K.Gather(r, g.edge_src) for r in leaves],
            g.edge_mask)
        grads = torch.autograd.grad((out * out.detach()).sum(), leaves)
        return torch.cat([out.reshape(-1)] + [x.reshape(-1) for x in grads])

    before = K.launch_counts["tensornet_interaction_backward"]
    launched("tensornet_interaction_aggregate", interaction)
    assert K.launch_counts["tensornet_interaction_backward"] - before == 2
    weights = tuple(w.to(card) for w in gated_mlp_weights(
        CHGNet(CHGNetConfig(num_species=4, units=c)).init(0)["atom_blocks"][0]["node_update"]))
    v = to(n, c)
    v_post = lg.halo_exchange(v)
    edge = to(e, c)
    launched("chgnet_atom_conv_aggregate",
             lambda g: g.overlapped_edge_sum(K.CHGNET_ATOM_CONV, v, v_post, (edge,),
                                             g.edge_mask, weights))


def _packed_batch(n_species=4, seed=2):
    """3 structures in 4 slots: 32 rattled fcc atoms, one atom alone in a
    12 Å box (no edge) and 16 atoms in a sheared cell."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    out = []
    for reps, shear in (((2, 2, 2), 0.0), ((2, 2, 1), 0.15)):
        frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, reps)
        cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.1, (len(frac), 3))
        m = np.eye(3)
        m[1, 0] = shear
        out.append(Atoms(numbers=rng.integers(0, n_species, len(cart)), positions=cart @ m,
                         cell=lat @ m))
    out.insert(1, Atoms(numbers=[1], positions=[[0.3, 0.2, 0.1]], cell=np.eye(3) * 12.0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tensornet", "chgnet", "mace", "escn"])
def test_batched_on_card_matches_cpu(card, family):
    """``BatchedPotential`` on the card (kernels on, one packed graph) against
    the same on the CPU (plain versions), and its launches per calculate:
    as a single-structure calculate of the packed graph, except eSCN with
    experts, whose per-structure gate mixes the experts' outputs per edge
    and so runs the SO(2) kernel once per expert. The first calculate after
    a reset of the allocator's peak is measured for the bytes model."""
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    structs = _packed_batch()
    kw = {}
    if family == "tensornet":
        model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.2))
    elif family == "chgnet":
        model = CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_blocks=3,
                                    cutoff=3.2, bond_cutoff=2.6))
        kw = dict(compute_magmom=True)
    elif family == "mace":
        model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2,
                                hidden_lmax=1, correlation=2, cutoff=3.2, edge_chunk=128))
    else:
        model = ESCN(ESCNConfig(num_species=4, channels=16, l_max=2, num_layers=2,
                                num_bessel=6, num_experts=4, cutoff=3.2,
                                avg_num_neighbors=12.0, edge_chunk=128))
    params = model.init(0)
    pot = BatchedPotential(model, params, device=card, skin=0.5, **kw)
    before = dict(launch_counts)
    torch.cuda.reset_peak_memory_stats()
    gpu = pot.calculate(structs)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    st = pot.last_stats
    assert st["batch_slots"] == 4 and pot.hbm_budget_bytes > 0
    assert st["batch_peak_bytes"] > 0 and pot.estimate_batch_bytes(len(structs[0])) > 0
    want = {k: 0 for k in got}
    if family == "tensornet":
        layers = model.cfg.num_layers
        want.update(tensornet_embed_aggregate=1, tensornet_interaction_aggregate=layers,
                    tensornet_interaction_backward=layers)
    elif family == "chgnet":
        blocks = model.cfg.num_blocks
        want.update(chgnet_atom_conv_aggregate=blocks, chgnet_line_aggregate=blocks - 1,
                    chgnet_row_projection=blocks + 2 * (blocks - 1))
    else:
        k = chunk_layout(st["e_cap"], model.cfg.edge_chunk)[2]
        if family == "mace":
            want["segment_sum"] = model.cfg.num_interactions * 2 * k
        else:
            want["segment_sum"] = (1 + model.cfg.num_layers) * 2 * k
            want["so2_conv"] = model.cfg.num_layers * 3 * k * model.cfg.num_experts
    assert got == want
    cpu = BatchedPotential(model, params, device="cpu", **kw).calculate(structs)
    for g, c in zip(gpu, cpu):
        assert abs(g["energy"] - c["energy"]) <= 1e-5 * max(abs(c["energy"]), 1e-6)
        np.testing.assert_allclose(g["forces"], c["forces"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["stress"], c["stress"], rtol=0, atol=1e-4)
        if "magmoms" in c:
            np.testing.assert_allclose(g["magmoms"], c["magmoms"], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_packed_refresh_on_card_matches_cpu(card):
    """The packed search on card tensors against the same on the CPU
    (identical arrays: elementwise float arithmetic in a fixed order), and
    a ``BatchedPotential`` refresh on the card against a host repack."""
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig
    from distmlip_tpu_torch.neighbors.device import (build_packed_spec,
                                                     device_packed_neighbor_list)
    from distmlip_tpu_torch.partition import BucketPolicy, pack_structures

    structs = _packed_batch()
    graph, host = pack_structures(structs, 3.2, skin=0.5, caps=BucketPolicy())
    static, arrays = build_packed_spec(host.cells, host.pbcs, host.n_atoms, host.node_offsets,
                                       3.7, graph.n_cap, graph.e_cap)
    pos = torch.from_numpy(host.scatter_positions([a.positions for a in structs])[0])
    for a, b in zip(device_packed_neighbor_list(static, arrays, pos),
                    device_packed_neighbor_list(static, arrays, pos.to(card))):
        assert torch.equal(a, b.cpu())
    model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.2))
    params = model.init(0)
    pot = BatchedPotential(model, params, device=card, skin=0.5)
    pot.calculate(structs)
    rng = np.random.default_rng(1)
    for a in structs:
        a.positions = a.positions + rng.normal(0, 0.2, a.positions.shape)
    res = pot.calculate(structs)
    assert pot.rebuild_on_device_count == 1
    ref = BatchedPotential(model, params, device=card).calculate(structs)
    for g, c in zip(res, ref):
        assert abs(g["energy"] - c["energy"]) <= 1e-5 * max(abs(c["energy"]), 1e-6)
        np.testing.assert_allclose(g["forces"], c["forces"], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_packed_kernels_on_card_match_plain(card):
    """B1 and the B2 kernels on a packed graph (one unsplit segment, a
    lone atom's empty dst row, padding at the tail) through the LocalGraph
    methods the models call, against the same with ``kernels=False`` on
    the card: each launches its kernel once."""
    import dataclasses

    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig
    from distmlip_tpu_torch.ops.nn import gated_mlp_weights
    from distmlip_tpu_torch.parallel import local_graph_from_stacked
    from distmlip_tpu_torch.partition import BucketPolicy, pack_structures

    graph, _ = pack_structures(_packed_batch(), 3.2, bond_cutoff=2.6, use_bond_graph=True,
                               caps=BucketPolicy())
    lg = local_graph_from_stacked(graph.to(card))
    plain = dataclasses.replace(lg, kernels=False)
    n, e, c = lg.n_cap, lg.e_cap, 16
    assert not lg.has_frontier_split and lg.batch_size == 4
    rng = np.random.default_rng(0)
    to = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(card)

    def launched(name, fn):
        before = K.launch_counts[name]
        out = fn(lg)
        assert K.launch_counts[name] - before == 1, name
        torch.testing.assert_close(out, fn(plain), rtol=1e-5, atol=1e-4)

    data = to(e, 12)
    launched("segment_sum", lambda g: g.aggregate_edges(data, g.edge_mask))
    embed = [to(e, c) for _ in range(4)] + [to(e, 3, 3, 1) for _ in range(2)]
    launched("tensornet_embed_aggregate",
             lambda g: g.aggregate_edge_messages(K.TENSORNET_EMBED, embed, g.edge_mask))
    f, rows = to(e, c, 3), [to(n, c), to(n, 3, c), to(n, 6, c)]
    launched("tensornet_interaction_aggregate",
             lambda g: g.aggregate_edge_messages(
                 K.TENSORNET_INTERACTION, [f] + [K.Gather(r, g.edge_src) for r in rows],
                 g.edge_mask))
    blocks = CHGNet(CHGNetConfig(num_species=4, units=c)).init(0)
    weights = tuple(w.to(card) for w in gated_mlp_weights(blocks["atom_blocks"][0]["node_update"]))
    v, edge = to(n, c), to(e, c)
    launched("chgnet_atom_conv_aggregate",
             lambda g: g.overlapped_edge_sum(K.CHGNET_ATOM_CONV, v, v, (edge,), g.edge_mask,
                                             weights))
    b, angle = to(lg.b_cap, c), to(lg.line_dst.shape[0], c)
    k1 = 4 * c  # the line conv's gated MLP reads [b_src | b_dst | angle | v_center]
    lw = (to(k1, c) / k1 ** 0.5, to(c) / k1 ** 0.5, to(c, c) / c ** 0.5, to(c) / c ** 0.5,
          to(k1, c) / k1 ** 0.5, to(c) / k1 ** 0.5, to(c, c) / c ** 0.5, to(c) / c ** 0.5)

    def line(g):
        items = [K.Gather(b, g.line_src), K.Gather(b, g.line_dst), angle,
                 K.Gather(v, g.line_center)]
        return K.fused_edge_aggregate(K.CHGNET_LINE_CONV, items, g.line_dst, g.b_cap,
                                      g.line_mask, indices_are_sorted=True, kernels=g.kernels,
                                      weights=lw)

    launched("chgnet_line_aggregate", line)


@pytest.mark.cuda
def test_prefetch_adopted_on_the_side_stream_on_card(card, monkeypatch):
    """The background prefetch rebuild of a P = 2 TensorNet on the card: the
    worker uploads on its own stream and records an event after the upload;
    the invalidating step adopts the build, making its stream wait on that
    event, and agrees with a fresh build on the card and with the CPU
    within the float32 bar."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig

    model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.0))
    params = model.init(0)
    waited = []
    wait_event = torch.cuda.Stream.wait_event

    def spy(stream, event):
        waited.append((stream, event))
        return wait_event(stream, event)

    monkeypatch.setattr(torch.cuda.Stream, "wait_event", spy)
    atoms = _long_cell()
    pot = DistPotential(model, params, device=card, skin=0.5, num_partitions=2)
    pot.calculate(atoms)
    moved = atoms.copy()
    moved.positions[0, 0] += 0.15  # 0.6 of the 0.25 Å budget: starts the build
    pot.calculate(moved)
    graph, _, event = pot._prefetch[0].result(timeout=120)
    assert isinstance(event, torch.cuda.Event)
    assert pot._upload_stream != torch.cuda.current_stream(card)
    assert all(t.is_cuda for t in graph.tensors())
    moved.positions[0, 0] += 0.15  # past the build's budget, inside the snapshot's
    res = pot.calculate(moved)
    assert pot.prefetch_hits == 1 and pot.rebuild_count == 2
    assert [e for s, e in waited] == [event]
    assert waited[0][0] == torch.cuda.current_stream(card)
    pot.close()
    for ref in (DistPotential(model, params, device=card, num_partitions=2).calculate(moved),
                DistPotential(model, params, device="cpu", num_partitions=2).calculate(moved)):
        assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
        np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mace_zbl_on_card_matches_plain(card):
    """MACE with ``zbl=True`` on the card: the pair term's width-1 edge sum
    launches the segment-sum kernel once per calculate beside the density
    projection's n_interactions x 2K; the result agrees with
    ``kernels=False`` on the card and with the CPU."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    rng = np.random.default_rng(7)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.0, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.1, (32, 3))
    atoms = Atoms(numbers=rng.integers(0, 4, 32), positions=cart, cell=lat)
    model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                            correlation=2, cutoff=3.2, edge_chunk=128, zbl=True,
                            atomic_numbers=(14, 14, 8, 8)))
    params = model.init(0)
    pot = DistPotential(model, params, device=card)
    before = launch_counts["segment_sum"]
    gpu = pot.calculate(atoms)
    k = chunk_layout(pot.last_stats["e_cap"], model.cfg.edge_chunk)[2]
    assert launch_counts["segment_sum"] - before == model.cfg.num_interactions * 2 * k + 1
    for ref in (DistPotential(model, params, device=card, kernels=False).calculate(atoms),
                DistPotential(model, params, device="cpu").calculate(atoms)):
        assert abs(gpu["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
        np.testing.assert_allclose(gpu["forces"], ref["forces"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(gpu["stress"], ref["stress"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the segment sum fitted to its width, one launch a call, and the row
# projection with W resident in shared memory
# ---------------------------------------------------------------------------

# row widths in floats: the narrow mapping (a warp per dst row, lanes split
# into edge and column groups) up to 16 columns, floats or float4s; the
# column mapping (a warp per row and 32-column chunk) past that
SEGMENT_WIDTHS = (1, 2, 3, 4, 8, 16, 31, 32, 33, 100, 800, 3200)


def _segment_sum_on_card(card, data, ids, n, mask):
    """The kernel against its plain version within 2 k u sum|x| (k = the
    largest row's valid-edge count, u = 2^-24), exactly one launch."""
    from distmlip_tpu_torch.kernels import (launch_counts, segment_sum_cuda,
                                            segment_sum_reference)

    before = launch_counts["segment_sum"]
    got = segment_sum_cuda(data, ids, n, mask)
    torch.cuda.synchronize()
    assert launch_counts["segment_sum"] == before + 1
    want = segment_sum_reference(data, ids, n, mask)
    ids_np, k = ids.cpu().numpy(), 1
    keep = (ids_np >= 0) & (ids_np < n) & (True if mask is None else mask.cpu().numpy())
    if keep.any():
        k = max(int(np.bincount(ids_np[keep], minlength=n).max()), 1)
    bound = 2 * k * 2.0 ** -24 * segment_sum_reference(data.abs(), ids, n, mask)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("width", SEGMENT_WIDTHS)
def test_segment_sum_widths_on_card(card, width, id_dtype):
    """Every mapping of the kernel against its plain version: ~10 edges a
    row with empty rows, masked interior edges and a padded tail."""
    ids, mask, n = sorted_case(20 + width, 500, 60, 40, 30, hi=50)
    data = torch.from_numpy(case_data(20 + width, len(ids), (width,))).to(card)
    ti = torch.from_numpy(ids.astype(id_dtype)).to(card)
    _segment_sum_on_card(card, data, ti, n, torch.from_numpy(mask).to(card))
    _segment_sum_on_card(card, data, ti, n, None)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 100, 3200])
@pytest.mark.parametrize("case", ["ids_out_of_range", "empty_rows", "all_masked",
                                  "nan_in_masked_rows", "long_padded_tail", "unaligned"])
def test_segment_sum_edge_cases_on_card(card, case, width):
    """Ids outside [0, N) are dropped; empty rows and an all-masked input
    give zeros; NaN in masked rows never reaches a sum; a padded tail of
    thousands of masked edges on the last real row; data and mask views
    that start off a 16-byte boundary."""
    ids, mask, n = sorted_case(40 + width, 400, 50, 20, 25)
    if case == "ids_out_of_range":
        ids = np.sort(np.concatenate([ids, np.full(7, -3), np.full(9, n + 2)])).astype(np.int32)
        mask = np.ones(len(ids), bool)
    elif case == "empty_rows":
        ids, mask, n = sorted_case(40 + width, 300, 200, 10, 5, hi=30)
    elif case == "all_masked":
        mask[:] = False
    elif case == "long_padded_tail":
        ids, mask, n = sorted_case(40 + width, 300, 40, 9000, 3)
    data = case_data(40 + width, len(ids), (width,))
    if case == "nan_in_masked_rows":
        data[~mask] = np.nan
    t = torch.from_numpy(data).to(card)
    tm = torch.from_numpy(mask).to(card)
    if case == "unaligned":
        buf = torch.zeros(t.numel() + 1, device=card)
        buf[1:] = t.reshape(-1)
        t = buf[1:].view(t.shape)
        mbuf = torch.zeros(len(mask) + 3, dtype=torch.bool, device=card)
        mbuf[3:] = tm
        tm = mbuf[3:]
    got = _segment_sum_on_card(card, t, torch.from_numpy(ids).to(card), n, tm)
    if case in ("all_masked", "empty_rows"):
        present = np.zeros(n, bool)
        present[ids[mask]] = True
        assert not bool(got[torch.from_numpy(~present).to(card)].any())


@pytest.mark.cuda
def test_segment_sum_is_deterministic_on_card(card):
    """Two calls give the same bits: fixed-order sums, no atomics."""
    from distmlip_tpu_torch.kernels import segment_sum_cuda

    ids, mask, n = sorted_case(60, 3000, 40, 100, 50)
    ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
    for width in (1, 16, 800):
        data = torch.from_numpy(case_data(60, len(ids), (width,))).to(card)
        assert torch.equal(segment_sum_cuda(data, ti, n, tm), segment_sum_cuda(data, ti, n, tm))


def _projection_on_card(card, rows, k, m, bias=True, seed=0):
    """The row projection kernel against ``x @ w + b`` within
    ``chgnet_projection_error_bound``, exactly one launch."""
    from distmlip_tpu_torch import kernels as K

    rng = np.random.default_rng(800 + seed)
    x = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(card) if bias else None
    before = K.launch_counts["chgnet_row_projection"]
    got = K.chgnet_row_projection_cuda(x, w, b)
    torch.cuda.synchronize()
    assert K.launch_counts["chgnet_row_projection"] == before + 1
    want = K.chgnet_row_projection_reference(x, w, b)
    bound = K.chgnet_projection_error_bound(x, w, b)
    assert got.shape == (rows, m) and bool(((got - want).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256])
def test_row_projection_atom_tables_on_card(card, m):
    """CHGNet's atom tables on the main path: 19,712 rows of 64."""
    _projection_on_card(card, 19712, 64, m)


def _rows_at_height(card, m, rows_per_thread, case):
    """The fewest rows of the form j tiles + d (d = 0, -1 or +1; more than
    two passes of the persistent grid for ``past_the_grid``) at which the
    launch plan picks ``rows_per_thread`` rows a thread, and that plan. A
    tile is 4 RT rows a warp, 8 warps over M / 64 column strips."""
    from distmlip_tpu_torch import kernels as K

    tile = 32 * rows_per_thread // ((128 if m <= 128 else 256) // 64)
    d = {"tile": 0, "tile-1": -1, "tile+1": 1, "past_the_grid": tile // 2}[case]
    for j in range(1, 8192):
        n = j * tile + d
        plan = K.chgnet_projection_plan(n, 64, m, card)
        if plan["rows_per_thread"] != rows_per_thread:
            continue
        if case != "past_the_grid" or plan["tiles"] > 2 * plan["blocks"]:
            return n, plan
    raise AssertionError(f"the plan never picks {rows_per_thread} rows a thread at M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_thread", [5, 8])
@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("rows", ["tile", "tile-1", "tile+1", "past_the_grid"])
def test_row_projection_tiles_on_card(card, rows, m, rows_per_thread):
    """Rows a whole number of tiles, a tile +- 1, and more rows than the
    persistent grid covers in one pass, at each tile height, reached through
    row counts at which the launch plan picks that height."""
    n, plan = _rows_at_height(card, m, rows_per_thread, rows)
    tile = plan["tile_rows"]
    assert plan["rows_per_thread"] == rows_per_thread and plan["tiles"] == -(-n // tile)
    _projection_on_card(card, n, 64, m, seed=n)


@pytest.mark.cuda
def test_row_projection_plan_heights_on_card(card):
    """The tile height follows the row count: 5 rows a thread at the
    19,712-row atom tables, 8 at the 236,032-row bond table (and +- 1)."""
    from distmlip_tpu_torch import kernels as K

    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the plan's choices at these shapes are for the H100's 132 SMs")
    for rows, m, rt in ((19712, 128, 5), (19712, 256, 5), (236031, 256, 8),
                        (236032, 256, 8), (236033, 256, 8)):
        assert K.chgnet_projection_plan(rows, 64, m, card)["rows_per_thread"] == rt, (rows, m)


@pytest.mark.cuda
def test_row_projection_on_a_second_card(card):
    """The projection on one card, then on another with the first one
    current and with the other current: the shared-memory limit and the SM
    count are the device's own, not the first launch's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    _projection_on_card(torch.device("cuda", 0), 19712, 64, 256)
    with torch.cuda.device(0):
        _projection_on_card(torch.device("cuda", 1), 19712, 64, 256, seed=1)
    with torch.cuda.device(1):
        _projection_on_card(torch.device("cuda", 1), 236032, 64, 256, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,bias", [(7, 24, True), (7, 256, False), (64, 4, True),
                                      (16, 256, True), (1, 8, False), (64, 132, True)])
def test_row_projection_shapes_on_card(card, k, m, bias):
    """K not a multiple of 4 (the 4-byte copies), M = 4, M = 256, M past
    128 but not 256."""
    _projection_on_card(card, 1003, k, m, bias, seed=k * 1000 + m)


@pytest.mark.cuda
def test_row_projection_refuses_what_it_does_not_take_on_card(card):
    """K past 64 or M past 256 (W would not fit shared memory), M not a
    multiple of 4, and a misaligned w raise ValueError before any launch."""
    from distmlip_tpu_torch import kernels as K

    x = torch.zeros((10, 64), device=card)
    before = dict(K.launch_counts)
    for xs, ws in (((10, 65), (65, 8)), ((10, 64), (64, 260)), ((10, 64), (64, 6))):
        with pytest.raises(ValueError):
            K.chgnet_row_projection_cuda(torch.zeros(xs, device=card), torch.zeros(ws, device=card))
    with pytest.raises(ValueError):
        K.chgnet_row_projection_cuda(x, torch.zeros(64 * 8 + 1, device=card)[1:].view(64, 8))
    assert K.launch_counts == before


# ---------------------------------------------------------------------------
# bfloat16 (compute_dtype="bfloat16"): B1 and B3's bf16 kernels
# ---------------------------------------------------------------------------

def bf16_segment_bound(data, ids, n, mask):
    """|kernel - plain| for bf16 rows: both sum the same bf16 values in fp32
    (orders differ: e = 2 k u T, k the largest row's valid-edge count, T the
    sum of |terms|), then round once to bf16 (8 significant bits, each
    within 2^-8 of its value): e + 2^-7 (|y| + e), one bf16 ulp where the
    two fp32 sums straddle a rounding boundary, y the plain side's sum."""
    from distmlip_tpu_torch.kernels import segment_sum_reference

    ids_np = ids.cpu().numpy()
    keep = (ids_np >= 0) & (ids_np < n) & (True if mask is None else mask.cpu().numpy())
    k = max(int(np.bincount(ids_np[keep], minlength=n).max()), 1) if keep.any() else 1
    e = 2 * k * 2.0 ** -24 * segment_sum_reference(data.float().abs(), ids, n, mask)
    y = segment_sum_reference(data.float(), ids, n, mask)
    return e + 2.0 ** -7 * (y.abs() + e)


def _segment_sum_bf16_on_card(card, data, ids, n, mask):
    from distmlip_tpu_torch.kernels import (launch_counts, segment_sum_cuda,
                                            segment_sum_reference)

    before = dict(launch_counts)
    got = segment_sum_cuda(data, ids, n, mask)
    torch.cuda.synchronize()
    assert launch_counts["segment_sum_bf16"] == before["segment_sum_bf16"] + 1
    assert launch_counts["segment_sum"] == before["segment_sum"]
    want = segment_sum_reference(data, ids, n, mask)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    bound = bf16_segment_bound(data, ids, n, mask)
    assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("width", SEGMENT_WIDTHS)
def test_segment_sum_bf16_widths_on_card(card, width, id_dtype):
    """The bf16 kernel at every mapping (pairs where the width is even,
    single values where it is odd) against its plain version: fp32 sums of
    the same bf16 rows, each rounded once."""
    ids, mask, n = sorted_case(20 + width, 500, 60, 40, 30, hi=50)
    data = torch.from_numpy(case_data(20 + width, len(ids), (width,))).to(card)
    ti = torch.from_numpy(ids.astype(id_dtype)).to(card)
    _segment_sum_bf16_on_card(card, data.bfloat16(), ti, n, torch.from_numpy(mask).to(card))
    _segment_sum_bf16_on_card(card, data.bfloat16(), ti, n, None)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 100, 3200])
@pytest.mark.parametrize("case", ["all_masked", "nan_in_masked_rows", "long_padded_tail",
                                  "unaligned", "many_edges"])
def test_segment_sum_bf16_edge_cases_on_card(card, case, width):
    """All masked gives zeros; NaN in masked rows never reaches a sum; a
    9000-edge padded tail; a view off a 4-byte boundary (single values);
    rows of ~500 edges, where a bf16 accumulator would lose ~5 bits and the
    fp32 one keeps the sum within one bf16 rounding."""
    ids, mask, n = sorted_case(70 + width, 400, 50, 20, 25)
    if case == "long_padded_tail":
        ids, mask, n = sorted_case(70 + width, 300, 40, 9000, 3)
    elif case == "many_edges":
        ids, mask, n = sorted_case(70 + width, 20000, 40, 10, 100)
    elif case == "all_masked":
        mask[:] = False
    data = case_data(70 + width, len(ids), (width,))
    if case == "nan_in_masked_rows":
        data[~mask] = np.nan
    t = torch.from_numpy(data).to(card).bfloat16()
    if case == "unaligned":
        buf = torch.zeros(t.numel() + 1, dtype=torch.bfloat16, device=card)
        buf[1:] = t.reshape(-1)
        t = buf[1:].view(t.shape)
    got = _segment_sum_bf16_on_card(card, t, torch.from_numpy(ids).to(card), n,
                                    torch.from_numpy(mask).to(card))
    if case == "all_masked":
        assert not bool(got.any())
    if case == "many_edges":
        exact = torch.zeros((n, width), dtype=torch.float64, device=card)
        keep = torch.from_numpy(mask).to(card)
        ik = torch.from_numpy(ids).to(card).long()[keep]
        exact.index_add_(0, ik, t.double()[keep])
        terms = torch.zeros_like(exact).index_add_(0, ik, t.double()[keep].abs())
        # one bf16 rounding of the exact sum, plus the fp32 sum's own error
        k = int(np.bincount(ids[mask], minlength=n).max())
        tol = 2.0 ** -8 * exact.abs() + 2 * k * 2.0 ** -24 * terms
        assert bool(((got.double() - exact).abs() <= tol).all())


@pytest.mark.cuda
def test_segment_sum_bf16_backward_and_refusals_on_card(card):
    """The Function's backward keeps data's dtype (the gather g[ids] * mask
    is exact in bf16); float16 and float64 are refused."""
    from distmlip_tpu_torch.kernels import fused_segment_sum, segment_sum_cuda

    ids = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32, device=card)
    data = torch.arange(10, dtype=torch.bfloat16, device=card).reshape(5, 2)
    m = torch.tensor([True, False, True, True, False], device=card)
    d = data.clone().requires_grad_(True)
    out = fused_segment_sum(d, ids, 4, m, indices_are_sorted=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float().cpu(), torch.tensor(
        [[0.0, 1.0], [0.0, 0.0], [10.0, 12.0], [0.0, 0.0]]))
    (g,) = torch.autograd.grad(out.float().sum(), d)
    assert g.dtype == torch.bfloat16
    torch.testing.assert_close(g.float(), m[:, None].float().expand(5, 2))
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16"):
            segment_sum_cuda(data.to(dt), ids, 4, None)


def _so2_bf16_case_on_card(card, name):
    h, weights, perm, inv, segments, c, m_idx = _so2_case_on_card(card, name)
    return h.bfloat16(), [w.bfloat16() for w in weights], perm, inv, segments, c, m_idx


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SO2_CASES))
def test_so2_conv_bf16_kernel_matches_plain_on_card(card, name):
    """The bf16 SO(2) kernel (one bf16 wgmma a product, fp32 accumulation,
    one rounding) vs its plain version (the same products in fp32, rounded
    once) within ``so2_conv_error_bound``'s bf16 form, in the packed order
    and through the row table. C 128 takes the TMA rows, C 8 and 16 the
    16-byte copies, C 7 the element copies."""
    from distmlip_tpu_torch import kernels as K

    h, weights, perm, inv, segments, c, _ = _so2_bf16_case_on_card(card, name)
    hp = h[:, torch.as_tensor(perm, device=card).long()].contiguous()
    bound = K.so2_conv_error_bound(hp, weights, segments, c)
    before = dict(K.launch_counts)
    got = K.so2_conv_cuda(hp, weights, segments, c, np.arange(h.shape[1]))
    want = K.so2_conv_reference(hp, weights, segments, c)
    torch.cuda.synchronize()
    assert K.launch_counts["so2_conv_bf16"] == before["so2_conv_bf16"] + 1
    assert K.launch_counts["so2_conv"] == before["so2_conv"]
    assert got.shape == want.shape == h.shape and got.dtype == want.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all()), name
    got_src = K.so2_conv_cuda(h, weights, segments, c, perm)
    inv_t = torch.as_tensor(inv, device=card).long()
    assert bool(((got_src.float() - want[:, inv_t].float()).abs()
                 <= bound[:, inv_t] + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SO2_CASES))
def test_so2_conv_bf16_backward_route_on_card(card, name):
    """bf16 backward route: the kernel on the transposed weight set with the
    swapped bf16 buffers against the plain VJP's input cotangent, which for
    bf16 also takes its products in fp32 and rounds once."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    h, weights, perm, inv, segments, c, m_idx = _so2_bf16_case_on_card(card, name)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=h.shape).astype(np.float32))
    g = g.to(card).bfloat16()
    perm_t = torch.as_tensor(perm, device=card).long()
    inv_t = torch.as_tensor(inv, device=card).long()
    packed = K.pack_so2_weights(weights, segments, c)
    assert packed.fwd.dtype == torch.bfloat16 and packed.fwd.shape[0] == 1
    wt = dispatch._so2_transposed_weights(weights, segments)
    got = K.so2_conv_cuda(g, wt, segments, c, perm, packed=packed.transposed())
    want = dispatch._so2_vjp(h, weights, g, perm_t, inv_t, segments, c, True,
                             [False] * len(weights))[0]
    bound = K.so2_conv_error_bound(g[:, perm_t], wt, segments, c)[:, inv_t]
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all()), name
    hl = h.clone().requires_grad_(True)
    before = K.launch_counts["so2_conv_bf16"]
    (gh,) = torch.autograd.grad(K.fused_so2_conv(hl, weights, m_idx, c, packed=packed), hl, g)
    assert K.launch_counts["so2_conv_bf16"] == before + 2
    torch.testing.assert_close(gh, got, rtol=0, atol=0)


@pytest.mark.cuda
def test_so2_conv_bf16_refuses_mixed_dtypes_on_card(card):
    """bf16 h with float32 weights, or a float32 packing, raises before a
    launch; the wrapper takes float32 or bfloat16 only."""
    from distmlip_tpu_torch import kernels as K

    h, weights, perm, _, segments, c, _ = _so2_case_on_card(card, "e37_lmax2_c16")
    before = dict(K.launch_counts)
    with pytest.raises(ValueError, match="weight"):
        K.so2_conv_cuda(h.bfloat16(), weights, segments, c, perm)
    with pytest.raises(ValueError, match="packed weights"):
        K.so2_conv_cuda(h.bfloat16(), [w.bfloat16() for w in weights], segments, c, perm,
                        packed=K.pack_so2_weights(weights, segments, c))
    with pytest.raises(TypeError, match="bfloat16"):
        K.so2_conv_cuda(h.half(), [w.half() for w in weights], segments, c, perm)
    assert K.launch_counts == before


def _bf16_model(family):
    from distmlip_tpu_torch.models import (CHGNet, CHGNetConfig, ESCN, ESCNConfig, MACE,
                                           MACEConfig, TensorNet, TensorNetConfig)

    if family == "chgnet":
        return CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_blocks=3, cutoff=3.0,
                                   bond_cutoff=2.6, dtype="bfloat16"))
    if family == "mace":
        return MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                               correlation=2, cutoff=3.0, edge_chunk=128, dtype="bfloat16"))
    if family == "tensornet":
        return TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.0,
                                         dtype="bfloat16"))
    return ESCN(ESCNConfig(num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6,
                           num_experts=4, cutoff=3.0, avg_num_neighbors=12.0, edge_chunk=128,
                           dtype="bfloat16"))


def _bf16_close(got, want, tag):
    """bf16 against bf16 across the kernel and plain routes, or the card and
    the CPU (each rounds its bf16 values at other ulps where the fp32 sums
    straddle a boundary, and the model carries the flips on): the bf16 bar
    of ``tests/test_torch_bf16.py``, |dE| / atom <= 1e-3 eV and max |dF|,
    |dS| (and CHGNet's |dm|) <= 0.05 of the largest."""
    n = len(want["forces"])
    assert abs(got["energy"] - want["energy"]) <= 1e-3 * n, tag
    f_scale = np.abs(want["forces"]).max()
    assert np.abs(got["forces"] - want["forces"]).max() <= 0.05 * f_scale, tag
    s_scale = np.abs(want["stress"]).max()
    assert np.abs(got["stress"] - want["stress"]).max() <= 0.05 * s_scale, tag
    assert got["forces"].dtype == np.float32 and isinstance(got["energy"], float)
    if "magmoms" in want:
        m_scale = np.abs(want["magmoms"]).max()
        assert np.abs(got["magmoms"] - want["magmoms"]).max() <= 0.05 * m_scale, tag
        assert got["magmoms"].dtype == np.float32


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("family", ["mace", "escn", "tensornet", "chgnet"])
def test_bf16_on_card_launches_the_bf16_kernels(card, family, P):
    """``DistPotential(compute_dtype="bfloat16")`` on the card launches the
    bf16 kernels, and only them, as many times as the float32 path launches
    its own (per segment and edge chunk), and agrees with ``kernels=False``
    on the card and with the CPU's plain bf16 path."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    atoms = _long_cell()
    if family == "escn":
        atoms.info = {"charge": 1, "spin": 2, "dataset": 3}
    model = _bf16_model(family)
    f32 = type(model)(type(model.cfg)(**dict(vars(model.cfg), dtype="float32")))
    params = model.init(0)
    kw = {"compute_magmom": True} if family == "chgnet" else {}
    pot = DistPotential(f32, params, device=card, num_partitions=P, compute_dtype="bfloat16",
                        **kw)
    assert pot.model.cfg.dtype == "bfloat16" and pot.compute_dtype == "bfloat16"
    before = dict(launch_counts)
    gpu = pot.calculate(atoms)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    st = pot.last_stats
    want = {name: 0 for name in got}
    if family == "tensornet":  # once per sorted segment: P of them here
        layers = model.cfg.num_layers
        want.update(tensornet_embed_aggregate_bf16=P,
                    tensornet_interaction_aggregate_bf16=layers * P,
                    tensornet_interaction_backward_bf16=layers * P)
    elif family == "chgnet":  # the atom conv once per segment, the line graph one
        blocks = model.cfg.num_blocks
        want.update(chgnet_atom_conv_aggregate_bf16=P * blocks,
                    chgnet_line_aggregate_bf16=blocks - 1,
                    chgnet_row_projection_bf16=(1 if P == 1 else 3) * blocks
                    + 2 * (blocks - 1))
    elif P == 2:
        k = chunk_layout(2 * st["e_cap"], model.cfg.edge_chunk, 2 * st["e_split"])[2]
    else:
        k = chunk_layout(st["e_cap"], model.cfg.edge_chunk)[2]
    if family == "mace":
        want["segment_sum_bf16"] = model.cfg.num_interactions * 2 * k
    elif family == "escn":
        want.update(so2_conv_bf16=model.cfg.num_layers * 3 * k,
                    segment_sum_bf16=(1 + model.cfg.num_layers) * 2 * k)
    assert got == want
    plain = DistPotential(model, params, device=card, num_partitions=P, kernels=False, **kw)
    _bf16_close(gpu, plain.calculate(atoms), "kernels vs plain on the card")
    assert {k: launch_counts[k] - before[k] for k in launch_counts} == want
    cpu = DistPotential(model, params, device="cpu", num_partitions=P, **kw).calculate(atoms)
    _bf16_close(gpu, cpu, "card vs CPU")


@pytest.mark.cuda
def test_bf16_batched_mace_on_card(card):
    """``BatchedPotential`` over a bf16 MACE on the card: the bf16 segment
    sum per chunk, the bytes model calibrated under "bfloat16" only, and
    each structure with edges within the bf16 bar of the CPU's plain bf16
    path."""
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    structs = _packed_batch()
    model = _bf16_model("mace")
    params = model.init(0)
    pot = BatchedPotential(model, params, device=card, skin=0.5)
    before = dict(launch_counts)
    torch.cuda.reset_peak_memory_stats()
    gpu = pot.calculate(structs)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    k = chunk_layout(pot.last_stats["e_cap"], model.cfg.edge_chunk)[2]
    assert got == dict({n: 0 for n in got}, segment_sum_bf16=model.cfg.num_interactions * 2 * k)
    n = sum(len(a) for a in structs)
    assert pot.caps.has_calibrated_rung(n, "bfloat16")
    assert not pot.caps.has_calibrated_rung(n, "float32")
    cpu = BatchedPotential(model, params, device="cpu").calculate(structs)
    for g, c, a in zip(gpu, cpu, structs):
        if len(a) > 1:  # the lone atom has no edge: nothing to compare
            _bf16_close(g, c, "batched card vs CPU")


def _edge_case_bf16_on_card(card, name, which):
    """``_edge_case_on_card``'s inputs rounded to bf16 once."""
    arrays, ti, tm, ids, mask, n = _edge_case_on_card(card, name, which)
    return ([x.bfloat16() if x.is_floating_point() else x for x in arrays], ti, tm, ids, mask,
            n)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["embed", "interaction"])
@pytest.mark.parametrize("name", sorted(EDGE_AGG_CASES))
def test_edge_aggregate_bf16_kernels_match_plain_on_card(card, name, which):
    """TensorNet's bf16 embed and interaction kernels (bf16 loads, fp32
    arithmetic and accumulation, one rounding an output element) vs their
    plain bf16 versions (the message in bf16 ops, the sum in fp32), within
    ``tensornet_embed_error_bound`` / ``tensornet_interaction_error_bound``
    at bf16 data; one ``*_bf16`` launch a call and no float32 one; all
    masked gives zeros."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_bf16_on_card(card, name, which)
    if which == "embed":
        cuda, ref = K.tensornet_embed_aggregate_cuda, K.tensornet_embed_aggregate_reference
        bound_fn, count = K.tensornet_embed_error_bound, "tensornet_embed_aggregate"
    else:
        cuda = K.tensornet_interaction_aggregate_cuda
        ref = K.tensornet_interaction_aggregate_reference
        bound_fn, count = K.tensornet_interaction_error_bound, "tensornet_interaction_aggregate"
    before = dict(K.launch_counts)
    got = cuda(*arrays, ti, n, tm)
    want = ref(*arrays, ti, n, tm)
    torch.cuda.synchronize()
    assert K.launch_counts[count + "_bf16"] == before[count + "_bf16"] + 1
    assert K.launch_counts[count] == before[count]
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    bound = bound_fn(*arrays, ti, n, tm)
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound + 1e-30).all()) and bool(torch.isfinite(got).all()), name
    assert not cuda(*arrays, ti, n, torch.zeros_like(tm)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_AGG_CASES))
def test_interaction_backward_bf16_kernel_matches_plain_on_card(card, name):
    """The bf16 backward kernel (d f per edge and each src row's d i, d a,
    d s summed in fp32 over its src-sorted edges, each rounded once) vs its
    plain bf16 version (the JAX dispatcher's semantics), within
    ``tensornet_interaction_backward_error_bound`` at bf16 data; masked
    edges' d f rows zero; deterministic."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_bf16_on_card(card, name, "interaction")
    c = arrays[0].shape[1]
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(n, 3, 3, c)).astype(
        np.float32)).to(card).bfloat16()
    count = "tensornet_interaction_backward_bf16"
    before = K.launch_counts[count]
    got = K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm)
    want = K.tensornet_interaction_backward_reference(g, *arrays, ti, tm)
    torch.cuda.synchronize()
    assert K.launch_counts[count] == before + 1
    bounds = K.tensornet_interaction_backward_error_bound(g, *arrays, ti, tm)
    for x, y, b in zip(got, want, bounds):
        assert x.shape == y.shape and x.dtype == y.dtype == torch.bfloat16
        assert bool(((x.float() - y.float()).abs() <= b + 1e-30).all()), name
    assert not got[0][~tm].any()
    for x, y in zip(K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm), got):
        assert torch.equal(x, y)


def _chgnet_case_bf16_on_card(card, name, which, n_node=23):
    """``_chgnet_case_on_card``'s inputs and weights rounded to bf16 once,
    the node (bond) tensor one at both gathered ends, as the model passes
    it."""
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h, n_node=n_node)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    t = [to(x).bfloat16() if x.dtype == np.float32 else to(x) for x in arrays]
    t[2] = t[0]
    return t, [to(w).bfloat16() for w in weights], to(ids), to(mask), n


def _upcast(arrays, weights):
    """A bf16 case's float tensors upcast to float32 (exactly); one tensor
    at both gathered ends stays one tensor."""
    seen = {}
    up = [x if x is None or not x.is_floating_point() else seen.setdefault(id(x), x.float())
          for x in arrays]
    return up, [w.float() for w in weights]


def _bf16_tables(x, w, bias):
    """The bf16 call's row projection for a float32 call on upcast bf16
    inputs: the same (exactly representable) values through the bf16
    tensor-core kernel, so both calls' per-edge kernels read one set of
    float32 tables."""
    from distmlip_tpu_torch import kernels as K

    return K.chgnet_row_projection_cuda(x.bfloat16(), w.bfloat16(), bias)


def _chgnet_bf16_check(which, arrays, weights, ti, tm, n, projections):
    """One bf16 call of a CHGNet kernel against its plain bf16 version
    within ``chgnet_aggregate_error_bound``'s bf16 form: a bf16 output, one
    ``*_bf16`` launch and ``projections`` bf16 row projections, no float32
    launch. Then the bf16 per-edge kernel (its products on the tensor
    cores) against the float32 per-edge kernel on the upcast inputs and the
    same float32 tables (the float32 call given the bf16 projection in the
    place of ``edge_aggregate.chgnet_row_projection_cuda``) within
    ``chgnet_tensor_core_error_bound``, and bit for bit against a second
    call. (The tables themselves come from the tensor cores in another
    summation order than the float32 projection's; the projection is held
    to its own bar in ``test_chgnet_row_projection_bf16_*``.)"""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import edge_aggregate

    if which == "atom":
        cuda, ref = K.chgnet_atom_conv_aggregate_cuda, K.chgnet_atom_conv_aggregate_reference
        count = "chgnet_atom_conv_aggregate_bf16"
    else:
        cuda, ref = K.chgnet_line_aggregate_cuda, K.chgnet_line_aggregate_reference
        count = "chgnet_line_aggregate_bf16"
    before = dict(K.launch_counts)
    got = cuda(*arrays, weights, ti, n, tm)
    want = ref(*arrays, weights, ti, n, tm)
    torch.cuda.synchronize()
    launched = {k: K.launch_counts[k] - before[k] for k in before}
    assert launched == dict({k: 0 for k in launched}, **{count: 1},
                            chgnet_row_projection_bf16=projections)
    assert torch.equal(got, cuda(*arrays, weights, ti, n, tm))
    f32_arrays, f32_weights = _upcast(arrays, weights)
    with mock.patch.object(edge_aggregate, "chgnet_row_projection_cuda", _bf16_tables):
        f32 = cuda(*f32_arrays, f32_weights, ti, n, tm)
    assert got.shape == want.shape == (n, arrays[4].shape[1])
    assert got.dtype == want.dtype == torch.bfloat16
    x, abw = chgnet_rows(which, arrays)
    bar = K.chgnet_tensor_core_error_bound(x, abw, weights, ti, n, tm)
    err = (got.float() - f32).abs()
    assert bool((err <= bar + 1e-30).all()), float((err / (bar + 1e-30)).max())
    bound = K.chgnet_aggregate_error_bound(x, abw, weights, ti, n, tm)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all()) and bool((err <= bound + 1e-30).all()), float(
        (err / (bound + 1e-30)).max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_CASES))
def test_chgnet_bf16_kernels_match_plain_on_card(card, name, which):
    """Both CHGNet bf16 kernels (bf16 rows, float32 tables, the per-edge
    products on the tensor cores, fp32 accumulation, one rounding an output
    element) vs their plain bf16 versions (the message in bf16 ops, the sum
    in fp32) on the shared cases (and within their bar of the float32
    kernel on the upcast inputs):
    C % 8 == 0 takes the 16-byte copies, C = 4 and C = 7 the plain loads;
    empty rows; one launch a call; all masked gives zeros; the
    atom conv without abw."""
    from distmlip_tpu_torch import kernels as K

    arrays, weights, ti, tm, n = _chgnet_case_bf16_on_card(card, name, which)
    proj = 1 if which == "atom" else 2
    _chgnet_bf16_check(which, arrays, weights, ti, tm, n, proj)
    cuda = (K.chgnet_atom_conv_aggregate_cuda if which == "atom"
            else K.chgnet_line_aggregate_cuda)
    assert not cuda(*arrays, weights, ti, n, torch.zeros_like(tm)).any()
    if which == "atom":
        _chgnet_bf16_check(which, arrays[:5] + [None], weights, ti, tm, n, proj)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
def test_chgnet_bf16_kernels_nonfinite_masked_on_card(card, which):
    """NaN in the masked and padded edges' per-edge rows (edge and abw, or
    the angle rows) and in the node (bond) rows no valid edge gathers: never
    read into a sum, so the output stays finite and within the bound of the
    plain version, which screens them with a select; then distinct tensors
    at the two gathered ends, one bf16 projection pass each."""
    arrays, weights, ti, tm, n = _chgnet_case_bf16_on_card(card, "matgl_widths", which,
                                                           n_node=2000)
    for k in ((4, 5) if which == "atom" else (4,)):
        arrays[k][~tm] = float("nan")
    gathers = {0: (1, 3)} if which == "atom" else {0: (1, 3), 5: (6,)}
    for k, idx in gathers.items():
        used = torch.zeros(arrays[k].shape[0], dtype=torch.bool, device=card)
        for i in idx:
            used[arrays[i][tm].long()] = True
        assert not bool(used.all())
        arrays[k][~used] = float("nan")
    proj = 1 if which == "atom" else 2
    _chgnet_bf16_check(which, arrays, weights, ti, tm, n, proj)
    arrays, weights, ti, tm, n = _chgnet_case_bf16_on_card(card, "hidden_32_channels_64", which)
    arrays[2] = (arrays[0].flip(0) * 0.5).contiguous()
    _chgnet_bf16_check(which, arrays, weights, ti, tm, n, proj + 1)


# the bf16 tensor-core kernels' own cases, as CHGNET_CASES: C and H that
# are not multiples of 16 (the widths padded to whole k16 steps, C to whole
# n8 tiles: an odd count of them takes ldmatrix.x2), fewer edges than a
# 16-edge tile
CHGNET_TC_CASES = {
    "c4_h4": (21, 300, 37, 20, 5, None, 4, 4),
    "c7_h5": (22, 517, 45, 3, 9, None, 7, 5),
    "c20_h36": (23, 600, 50, 20, 10, None, 20, 36),
    "c36_h20": (24, 400, 41, 7, 5, None, 36, 20),
    "c40_h64": (25, 333, 30, 5, 4, None, 40, 64),
    "fewer_edges_than_a_tile": (26, 11, 4, 2, 1, None, 64, 64),
}


def _chgnet_tc_case(card, which, seed, ids, mask, n, c, h):
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    t = [to(x).bfloat16() if x.dtype == np.float32 else to(x) for x in arrays]
    t[2] = t[0]
    return t, [to(w).bfloat16() for w in weights], to(ids), to(mask), n


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_TC_CASES) + ["range_ends_mid_tile"])
def test_chgnet_bf16_tensor_core_cases_on_card(card, name, which):
    """The bf16 tensor-core kernels on their own edge cases, each against the
    plain bf16 version and within ``chgnet_tensor_core_error_bound`` of the
    float32 kernel, two calls bit for bit, all masked giving zeros:
    ``CHGNET_TC_CASES``, and warp ranges that end mid-tile (3000 one-edge
    rows, one row of 10,000 edges, 3000 one-edge rows: the row cut puts the
    long row in one warp, the others' ranges end in partial tiles)."""
    from distmlip_tpu_torch import kernels as K

    if name == "range_ends_mid_tile":
        rng = np.random.default_rng(27)
        ids = np.concatenate([np.arange(3000), np.full(10000, 3000),
                              np.arange(3001, 6001)]).astype(np.int32)
        mask = rng.random(len(ids)) > 0.05
        t, tw, ti, tm, n = _chgnet_tc_case(card, which, 27, ids, mask, 6001, 64, 64)
    else:
        seed, e, n, pad, im, hi, c, h = CHGNET_TC_CASES[name]
        ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
        t, tw, ti, tm, n = _chgnet_tc_case(card, which, seed, ids, mask, n, c, h)
    proj = 1 if which == "atom" else 2
    _chgnet_bf16_check(which, t, tw, ti, tm, n, proj)
    cuda = (K.chgnet_atom_conv_aggregate_cuda if which == "atom"
            else K.chgnet_line_aggregate_cuda)
    assert not cuda(*t, tw, ti, n, torch.zeros_like(tm)).any()
    if which == "atom":
        _chgnet_bf16_check(which, t[:5] + [None], tw, ti, tm, n, proj)


def test_chgnet_tc_cases_are_what_they_say():
    """CHGNET_TC_CASES (on the CPU): widths off whole k16 steps and an odd
    n8 tile count among them, and a case of fewer valid edges than a
    tile."""
    widths = [(v[6], v[7]) for v in CHGNET_TC_CASES.values()]
    assert any(c % 16 and h % 16 for c, h in widths)
    assert any(-(-c // 8) % 2 for c, _ in widths)
    seed, e, n, pad, im, hi, c, h = CHGNET_TC_CASES["fewer_edges_than_a_tile"]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    assert 0 < mask.sum() < 16


# the row projection's cases at bf16 rows, plus an even K that is not a
# multiple of 8 (plain loads, as K = 7)
PROJECTION_BF16_CASES = dict(PROJECTION_CASES, k6=(300, 6, 24, True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROJECTION_BF16_CASES))
def test_chgnet_row_projection_bf16_matches_plain_on_card(card, name):
    """The bf16 row projection (bf16 rows and W, bf16 products on the
    tensor cores, the bias and the table float32) vs its plain version, the
    float32 product of the same values, within
    ``chgnet_projection_error_bound``'s bf16 form, bitwise the same on a
    second call; one ``*_bf16`` launch and no float32 one: K % 8 == 0 takes
    the 16-byte copies, K = 6 and 7 the plain loads. A float32 W with bf16
    rows is refused (nothing is rounded quietly)."""
    from distmlip_tpu_torch import kernels as K

    rows, k, m, has_bias = PROJECTION_BF16_CASES[name]
    rng = np.random.default_rng(800 + rows)
    x = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)).to(card).bfloat16()
    w = torch.from_numpy((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)).to(card)
    w = w.bfloat16()
    b = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(card) if has_bias else None
    before = dict(K.launch_counts)
    got = K.chgnet_row_projection_cuda(x, w, b)
    torch.cuda.synchronize()
    launched = {key: K.launch_counts[key] - before[key] for key in before}
    assert launched == dict({key: 0 for key in launched}, chgnet_row_projection_bf16=1)
    want = K.chgnet_row_projection_reference(x, w, b)
    bound = K.chgnet_projection_error_bound(x, w, b)
    assert got.shape == (rows, m) and got.dtype == want.dtype == torch.float32
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    assert torch.equal(got, K.chgnet_row_projection_cuda(x, w, b))
    with pytest.raises(TypeError, match="x's dtype"):
        K.chgnet_row_projection_cuda(x, w.float(), b)


@pytest.mark.cuda
def test_bf16_b2_routes_and_refusals_on_card(card):
    """bf16 through the dispatcher on the card: TensorNet's interaction
    launches its bf16 forward and backward kernels (no plain recompute,
    no float32 launch) and agrees with ``kernels=False``; CHGNet's atom conv
    launches its bf16 kernel and one bf16 row projection (its backward the
    plain chunked recompute) and agrees with ``kernels=False``; a call
    mixing float32 and bf16 raises before any launch, as does float16, for
    both families."""
    from distmlip_tpu_torch import kernels as K

    arrays, ti, tm, ids, mask, n = _edge_case_bf16_on_card(card, "empty_rows", "interaction")
    f, node_i, node_a, node_s, src = arrays
    leaves = [x.clone().requires_grad_(True) for x in (f, node_i, node_a, node_s)]
    inputs = lambda xs: [xs[0]] + [K.Gather(x, src) for x in xs[1:]]  # noqa: E731
    before = dict(K.launch_counts)
    out = K.fused_edge_aggregate(K.TENSORNET_INTERACTION, inputs(leaves), ti, n, tm)
    got = torch.autograd.grad(out.float().square().sum(), leaves)
    launched = {k: K.launch_counts[k] - before[k] for k in before}
    assert launched == dict({k: 0 for k in launched}, tensornet_interaction_aggregate_bf16=1,
                            tensornet_interaction_backward_bf16=1)
    plain = K.fused_edge_aggregate(K.TENSORNET_INTERACTION, inputs(leaves), ti, n, tm,
                                   kernels=False)
    want = torch.autograd.grad(plain.float().square().sum(), leaves)
    for a, b in zip([out] + list(got), [plain] + list(want)):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= 0.02 * float(b.abs().max())
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in got)
    before = dict(K.launch_counts)
    with pytest.raises(TypeError, match="one dtype"):
        K.fused_edge_aggregate(K.TENSORNET_INTERACTION, inputs([f.float(), node_i, node_a,
                                                                node_s]), ti, n, tm)
    with pytest.raises(NotImplementedError):
        K.fused_edge_aggregate(K.TENSORNET_INTERACTION,
                               inputs([x.half() for x in (f, node_i, node_a, node_s)]), ti, n, tm)
    carrays, weights, cti, ctm, cn = _chgnet_case_on_card(card, "repeated_tail_padding", "atom")
    node_src, src_c, _, dst_c, edge, abw = carrays
    cleaves = [x.bfloat16().requires_grad_(True) for x in (node_src, edge, abw)]
    bw = tuple(w.bfloat16() for w in weights)

    def chgnet(xs, kernels=True, ws=bw):
        v, e_, a_ = xs
        return K.fused_edge_aggregate(K.CHGNET_ATOM_CONV, [K.Gather(v, src_c), K.Gather(v, dst_c),
                                                           e_, a_], cti, cn, ctm,
                                      kernels=kernels, weights=ws)

    with pytest.raises(TypeError, match="one dtype"):
        chgnet(cleaves, ws=tuple(weights))
    with pytest.raises(NotImplementedError):
        chgnet([x.detach().half() for x in cleaves], ws=tuple(w.half() for w in weights))
    assert dict(K.launch_counts) == before
    K.recompute_chunks.clear()
    out = chgnet(cleaves)
    got = torch.autograd.grad(out.float().square().sum(), cleaves)
    launched = {k: K.launch_counts[k] - before[k] for k in before}
    assert launched == dict({k: 0 for k in launched}, chgnet_atom_conv_aggregate_bf16=1,
                            chgnet_row_projection_bf16=1)
    assert K.recompute_chunks == {"chgnet_atom_conv_aggregate": 1}
    plain = chgnet(cleaves, kernels=False)
    want = torch.autograd.grad(plain.float().square().sum(), cleaves)
    for a, b in zip([out] + list(got), [plain] + list(want)):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= 0.02 * float(b.abs().max())
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in got)


# ---------------------------------------------------------------------------
# the bf16 kernels on the tensor cores: the row projection's shapes and
# persistent grid; B3 bf16's plan, A modes and persistent grid
# ---------------------------------------------------------------------------

def _projection_bf16_on_card(card, rows, k, m, bias, seed, offset=0):
    """One bf16 row projection against its plain version within
    ``chgnet_projection_error_bound``'s bf16 form, one launch (none at 0
    rows); x is a view ``offset`` elements into its buffer (an odd offset
    is off the 16-byte boundary: the plain loads)."""
    from distmlip_tpu_torch import kernels as K

    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.normal(size=rows * k + offset).astype(np.float32)).to(card)
    x = buf.bfloat16()[offset:].view(rows, k)
    w = torch.from_numpy((rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)).to(card)
    w = w.bfloat16()
    b = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(card) if bias else None
    before = K.launch_counts["chgnet_row_projection_bf16"]
    got = K.chgnet_row_projection_cuda(x, w, b)
    torch.cuda.synchronize()
    assert K.launch_counts["chgnet_row_projection_bf16"] == before + (1 if rows else 0)
    want = K.chgnet_row_projection_reference(x, w, b)
    bound = K.chgnet_projection_error_bound(x, w, b)
    assert got.shape == (rows, m) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all()), (rows, k, m, bias, offset)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128, 132, 256])
@pytest.mark.parametrize("k", [1, 6, 7, 16, 63, 64])
def test_chgnet_row_projection_bf16_shapes_on_card(card, k, m):
    """The bf16 projection at K from 1 to 64 (one to four k16 steps, K % 8
    != 0 on the plain loads), M from 4 to 256 (both column plans), rows 0,
    1 and a tile +- 1, with and without bias, on aligned and unaligned
    views of x."""
    from distmlip_tpu_torch import kernels as K

    tile = K.chgnet_projection_plan(1, k, m, card, torch.bfloat16)["tile_rows"]
    assert tile == (64 if m > 128 else 128)
    for rows in (0, 1, tile - 1, tile + 1):
        for bias in (True, False):
            for offset in (0, 3):
                _projection_bf16_on_card(card, rows, k, m, bias, 10 * rows + k + m, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256])
def test_chgnet_row_projection_bf16_persistent_grid_on_card(card, m):
    """The persistent grid at 1, grid - 1, grid and grid + 1 tiles and past
    two rounds, whole and with a ragged last tile (the plan's tiles and
    blocks checked); the bond table's shape; the same bits on a second
    call."""
    from distmlip_tpu_torch import kernels as K

    plan = K.chgnet_projection_plan(10 ** 6, 64, m, card, torch.bfloat16)
    tile, grid = plan["tile_rows"], plan["blocks"]
    assert grid == torch.cuda.get_device_properties(card).multi_processor_count
    for tiles in (1, grid - 1, grid, grid + 1, 2 * grid + 3):
        for rows in (tiles * tile, tiles * tile - 5):
            p = K.chgnet_projection_plan(rows, 64, m, card, torch.bfloat16)
            assert p["tiles"] == tiles and p["blocks"] == min(tiles, grid)
            _projection_bf16_on_card(card, rows, 64, m, True, rows)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(236032, 64)).astype(np.float32)).to(card).bfloat16()
    w = torch.from_numpy(rng.normal(size=(64, m)).astype(np.float32) / 8).to(card).bfloat16()
    b = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(card)
    got = K.chgnet_row_projection_cuda(x, w, b)
    assert torch.equal(got, K.chgnet_row_projection_cuda(x, w, b))
    bound = K.chgnet_projection_error_bound(x, w, b)
    assert bool(((got - K.chgnet_row_projection_reference(x, w, b)).abs() <= bound).all())


def _so2_one_segment(card, e, c, seed):
    """h (E, 1, C) bf16 and one m = 0 block W0 (C, C): a single column tile
    at C <= 256, so the walk's tiles are the row-tile pairs."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(e, 1, c)).astype(np.float32)).to(card).bfloat16()
    w0 = torch.from_numpy((rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32))
    return h, [w0.to(card).bfloat16()], ((0, 0, 1),)


@pytest.mark.cuda
def test_so2_conv_bf16_plan_on_card(card):
    """The bf16 plan at eSCN's chunk: 128 x 256 tiles, the TMA rows, 13
    column tiles x 256 row tiles walked by a grid of one block an SM, 1.85
    GB from L2 (the first design's 192 x 128 tiles: 2.03 GB); one row tile
    is 13 tiles on 13 blocks; C 8 and 7 take the copies."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.ops.so3_e3nn import CoeffLayout

    lay = CoeffLayout(4)
    _, _, segments = K.packed_m_layout({m: (lay.plus_idx[m], lay.minus_idx[m])
                                        for m in range(5)})
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = K.so2_bf16_plan(32768, segments, 128, card)
    assert (plan["tile_rows"], plan["tile_cols"], plan["a_mode"]) == (128, 256, 0)
    assert (plan["row_tiles"], plan["col_tiles"], plan["tiles"]) == (256, 13, 256 * 13)
    assert plan["blocks"] == sms
    assert plan["l2_bytes_a"] + plan["l2_bytes_b"] == 1_845_493_760
    one = K.so2_bf16_plan(128, segments, 128, card)
    assert (one["row_tiles"], one["tiles"], one["blocks"]) == (1, 13, 13)
    assert K.so2_bf16_plan(300, segments, 8, card)["a_mode"] == 1
    assert K.so2_bf16_plan(300, segments, 7, card)["a_mode"] == 2


@pytest.mark.cuda
def test_so2_conv_bf16_persistent_grid_on_card(card):
    """B3 bf16's persistent walk at 1, grid - 1, grid and grid + 1 tiles
    (row tiles of one column tile), whole and with a ragged last tile:
    within the bf16 bound, the same bits on a second call."""
    from distmlip_tpu_torch import kernels as K

    c = 128
    h, w, segments = _so2_one_segment(card, 1, c, 0)
    grid = K.so2_bf16_plan(10 ** 7, segments, c, card)["blocks"]
    for tiles in (1, grid - 1, grid, grid + 1):
        for e in (128 * tiles, 128 * tiles - 37):
            plan = K.so2_bf16_plan(e, segments, c, card)
            assert plan["tiles"] == tiles and plan["blocks"] == min(tiles, grid)
            h, w, _ = _so2_one_segment(card, e, c, e)
            got = K.so2_conv_cuda(h, w, segments, c, [0])
            want = K.so2_conv_reference(h, w, segments, c)
            bound = K.so2_conv_error_bound(h, w, segments, c)
            torch.cuda.synchronize()
            assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all()), e
            assert torch.equal(got, K.so2_conv_cuda(h, w, segments, c, [0]))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 8, 7])
@pytest.mark.parametrize("l_max", [1, 2, 4, 6])
def test_so2_conv_bf16_a_modes_on_card(card, l_max, c):
    """Every A mode of B3 bf16 (C 64: TMA boxes; 8: 16-byte copies; 7:
    element copies) at l_max 1, 2, 4, 6, E = 300 (three row tiles, the
    last ragged), forward through the row table and the
    backward's route on the transposed weights, against the plain forward
    and the plain VJP's input cotangent within the bf16 bound."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.kernels import dispatch

    h, weights, m_idx = so2_inputs(40 + l_max, 300, l_max, c)
    h = torch.from_numpy(h).to(card).bfloat16()
    weights = [torch.from_numpy(x).to(card).bfloat16() for x in weights]
    perm, inv, segments = K.packed_m_layout(m_idx)
    assert K.so2_bf16_plan(300, segments, c, card)["a_mode"] == {64: 0, 8: 1, 7: 2}[c]
    perm_t = torch.as_tensor(perm, device=card).long()
    inv_t = torch.as_tensor(inv, device=card).long()
    got = K.so2_conv_cuda(h, weights, segments, c, perm)
    hp = h[:, perm_t]
    want = K.so2_conv_reference(hp, weights, segments, c)[:, inv_t]
    bound = K.so2_conv_error_bound(hp, weights, segments, c)[:, inv_t]
    assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all())
    g = torch.from_numpy(np.random.default_rng(l_max).normal(size=h.shape).astype(
        np.float32)).to(card).bfloat16()
    packed = K.pack_so2_weights(weights, segments, c)
    wt = dispatch._so2_transposed_weights(weights, segments)
    got = K.so2_conv_cuda(g, wt, segments, c, perm, packed=packed.transposed())
    want = dispatch._so2_vjp(h, weights, g, perm_t, inv_t, segments, c, True,
                             [False] * len(weights))[0]
    bound = K.so2_conv_error_bound(g[:, perm_t], wt, segments, c)[:, inv_t]
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= bound + 1e-30).all())


# ---------------------------------------------------------------------------
# bfloat16: B1's row kernel on 16-byte lanes and TensorNet's bf16 backward
# kernel (channel pairs a lane, edge indices loaded by the warp)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def time_limit(seconds):
    """Fails the enclosed code past ``seconds`` of wall time (SIGALRM: the
    card tests run in one process)."""
    def expire(signum, frame):
        raise TimeoutError(f"past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def sequential_bf16_sum(data, ids, n, mask):
    """B1's bf16 output as its column paths form it: each column's valid
    edges (ids in [0, n), mask true) added one at a time in edge order into
    a float32 accumulator, rounded once to bf16. Step k adds every row's
    k-th valid edge (one ``index_add_`` of distinct rows: one float32
    addition an element)."""
    ids_np = ids.cpu().numpy().astype(np.int64)
    keep = (ids_np >= 0) & (ids_np < n)
    if mask is not None:
        keep &= mask.cpu().numpy()
    idx = np.nonzero(keep)[0]
    rows = ids_np[idx]
    rank = np.arange(len(rows)) - np.searchsorted(rows, rows, side="left")
    acc = torch.zeros((n,) + tuple(data.shape[1:]), dtype=torch.float32, device=data.device)
    flat = data.float()
    for k in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = idx[rank == k]
        acc.index_add_(0, torch.from_numpy(ids_np[sel]).to(data.device),
                       flat[torch.from_numpy(sel).to(data.device)])
    return acc.bfloat16()


ROW_PATH = "rows of 16-byte lanes, a block a dst row"


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("width", [8, 24, 128, 136, 2048, 3200, 5120])
def test_segment_sum_bf16_vector_path_on_card(card, width, id_dtype):
    """bf16 rows at widths that are multiples of 8: past 32 columns the row
    kernel (16-byte lanes, one block a dst row) takes them and equals, bit
    for bit, each column's valid edges added in edge order in float32 and
    rounded once; at 8 and 24 the narrow pair kernel keeps its shuffle tree.
    Both within the bf16 bound of the plain version."""
    from distmlip_tpu_torch.kernels import segment_sum_bf16_plan

    with time_limit(60):
        ids, mask, n = sorted_case(90 + width, 3000, 80, 200, 40, hi=70)
        data = torch.from_numpy(case_data(90 + width, len(ids), (width,))).to(card).bfloat16()
        ti = torch.from_numpy(ids.astype(id_dtype)).to(card)
        tm = torch.from_numpy(mask).to(card)
        plan = segment_sum_bf16_plan(data, ti)
        assert plan["path"] == (ROW_PATH if width > 32 else "narrow, pairs"), plan
        got = _segment_sum_bf16_on_card(card, data, ti, n, tm)
        if width > 32:
            assert plan["elements_a_load"] == 8 and plan["searches_a_row"] == 1
            assert torch.equal(got, sequential_bf16_sum(data, ti, n, tm))
            assert torch.equal(_segment_sum_bf16_on_card(card, data, ti, n, None),
                               sequential_bf16_sum(data, ti, n, None))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,path", [(1, "wide, single values"), (2, "wide, pairs"),
                                         (8, ROW_PATH)])
@pytest.mark.parametrize("width", [136, 3200])
def test_segment_sum_bf16_misaligned_views_on_card(card, width, offset, path):
    """A view off a 16-byte boundary never takes the 16-byte loads: one
    element off takes single values, two elements off bf16 pairs, eight
    (16 bytes, aligned again) the row kernel; every route adds each
    column's edges in edge order, so all three equal the sequential sum bit
    for bit."""
    from distmlip_tpu_torch.kernels import segment_sum_bf16_plan

    with time_limit(60):
        ids, mask, n = sorted_case(110 + width, 1500, 50, 100, 30)
        t = torch.from_numpy(case_data(110 + width, len(ids), (width,))).to(card).bfloat16()
        buf = torch.zeros(t.numel() + offset, dtype=torch.bfloat16, device=card)
        buf[offset:] = t.reshape(-1)
        view = buf[offset:].view(t.shape)
        assert segment_sum_bf16_plan(view)["path"] == path
        ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
        got = _segment_sum_bf16_on_card(card, view, ti, n, tm)
        assert torch.equal(got, sequential_bf16_sum(t, ti, n, tm))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [264, 8448])
def test_segment_sum_bf16_row_kernel_long_rows_on_card(card, width):
    """Rows of thousands of valid edges (more than one round of 1024 staged
    edges) broken by masked stretches past 512 edges (windows skipped with
    no data load), ids outside [0, N), a width whose last warp holds one
    vector (264) and one past 16 warps (8448: a second slab on grid.y):
    bit for bit the sequential sum."""
    with time_limit(120):
        rng = np.random.default_rng(width)
        ids = np.sort(np.concatenate([np.full(3, -2), rng.integers(0, 6, 7000),
                                      np.full(2600, 6), np.full(5, 9)])).astype(np.int32)
        mask = rng.random(len(ids)) > 0.2
        mask[np.nonzero(ids == 6)[0][:1500]] = False  # a masked stretch inside row 6
        data = torch.from_numpy(case_data(7, len(ids), (width,))).to(card).bfloat16()
        ti, tm = torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)
        got = _segment_sum_bf16_on_card(card, data, ti, 8, tm)
        assert torch.equal(got, sequential_bf16_sum(data, ti, 8, tm))


@pytest.mark.cuda
def test_segment_sum_bf16_padding_only_chunk_on_card(card):
    """The padding-only chunk (every edge masked, one dst id) gives zeros;
    with its last five edges valid, their sum on that row; two calls equal
    bit for bit."""
    from distmlip_tpu_torch.kernels import segment_sum_cuda

    with time_limit(60):
        e = 8192
        ids = torch.full((e,), 2047, dtype=torch.int32, device=card)
        data = torch.from_numpy(case_data(8, e, (3200,))).to(card).bfloat16()
        none = torch.zeros(e, dtype=torch.bool, device=card)
        got = _segment_sum_bf16_on_card(card, data, ids, 2560, none)
        assert not bool(got.any())
        last5 = torch.arange(e, device=card) >= e - 5
        got = _segment_sum_bf16_on_card(card, data, ids, 2560, last5)
        assert torch.equal(got, sequential_bf16_sum(data, ids, 2560, last5))
        assert torch.equal(got, segment_sum_cuda(data, ids, 2560, last5))


def _backward_bf16_case(card, c, e=3000, n_node=23, n=40, pad=100, masked=50):
    """A bf16 backward case: ~e / n_node edges a src row (several turns of
    32 edge indices), dst-sorted ids with a padded tail and masked edges."""
    ids, mask, n = sorted_case(130 + c, e, n, pad, masked)
    arrays = interaction_inputs(130 + c, len(ids), n_node, c)
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    t = [to(x).bfloat16() if x.dtype == np.float32 else to(x) for x in arrays]
    g = to(np.random.default_rng(c).normal(size=(n, 3, 3, c)).astype(np.float32)).bfloat16()
    return g, t, to(ids), to(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("c,pairs", [(7, False), (64, True), (65, False), (300, True)])
def test_interaction_backward_bf16_channels_on_card(card, c, pairs):
    """The bf16 backward at C = 7, 64, 65, 300: channel pairs where C is
    even (64 channels a warp, 300 on grid.y slabs), one channel a lane where
    it is odd. Within the bf16 bound of the plain version; equal bit for bit
    to the float32 kernel on the upcast inputs rounded once (the same
    arithmetic in the same order); NaN in masked f rows changes nothing
    (never read: d f zero there, d x finite); two calls equal; all masked
    writes zeros."""
    from distmlip_tpu_torch import kernels as K

    with time_limit(60):
        g, arrays, ti, tm = _backward_bf16_case(card, c)
        plan = K.tensornet_interaction_backward_bf16_plan(g, *arrays[:4])
        assert plan["channels_a_lane"] == (2 if pairs else 1)
        assert plan["warps_a_row"] == -(-c // (64 if pairs else 32))
        before = dict(K.launch_counts)
        got = K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm)
        torch.cuda.synchronize()
        launched = {k: K.launch_counts[k] - before[k] for k in before}
        assert launched == dict({k: 0 for k in launched}, tensornet_interaction_backward_bf16=1)
        want = K.tensornet_interaction_backward_reference(g, *arrays, ti, tm)
        bounds = K.tensornet_interaction_backward_error_bound(g, *arrays, ti, tm)
        for x, y, b in zip(got, want, bounds):
            assert x.dtype == y.dtype == torch.bfloat16 and x.shape == y.shape
            assert bool(((x.float() - y.float()).abs() <= b + 1e-30).all())
        f32 = K.tensornet_interaction_backward_cuda(
            g.float(), *(x.float() if x.is_floating_point() else x for x in arrays), ti, tm)
        for x, y in zip(got, f32):
            assert torch.equal(x, y.bfloat16())
        nan_f = arrays[0].clone()
        nan_f[~tm] = float("nan")
        again = K.tensornet_interaction_backward_cuda(g, nan_f, *arrays[1:], ti, tm)
        for x, y in zip(again, got):
            assert torch.equal(x, y)
        assert not bool(again[0][~tm].any())
        assert all(bool(torch.isfinite(x.float()).all()) for x in again[1:])
        none = torch.zeros_like(tm)
        for x in K.tensornet_interaction_backward_cuda(g, *arrays, ti, none):
            assert not bool(x.any())


@pytest.mark.cuda
def test_interaction_backward_bf16_misaligned_view_on_card(card):
    """An f view one element off a 4-byte boundary takes the single-channel
    path at even C and gives the same bits as the aligned call."""
    from distmlip_tpu_torch import kernels as K

    with time_limit(60):
        g, arrays, ti, tm = _backward_bf16_case(card, 64)
        f = arrays[0]
        buf = torch.zeros(f.numel() + 1, dtype=torch.bfloat16, device=card)
        buf[1:] = f.reshape(-1)
        view = buf[1:].view(f.shape)
        assert K.tensornet_interaction_backward_bf16_plan(g, view, *arrays[1:4])[
            "channels_a_lane"] == 1
        got = K.tensornet_interaction_backward_cuda(g, view, *arrays[1:], ti, tm)
        for x, y in zip(got, K.tensornet_interaction_backward_cuda(g, *arrays, ti, tm)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mace", "escn", "tensornet"])
def test_bf16_main_paths_take_the_new_kernels_on_card(card, family):
    """MACE, eSCN and TensorNet at bf16 through ``DistPotential`` on the
    card: the launch counts are the float32 paths' (one B1 call per
    interaction and chunk, twice with remat; TensorNet's backward once a
    layer), every bf16 B1 call takes the row kernel on 16-byte lanes and
    TensorNet's embed, interactions and backward the channel-pair path."""
    from distmlip_tpu_torch import kernels as K
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.kernels import dispatch, edge_aggregate
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    with time_limit(180):
        atoms = _long_cell()
        if family == "escn":
            atoms.info = {"charge": 1, "spin": 2, "dataset": 3}
        model = _bf16_model(family)
        pot = DistPotential(model, model.init(0), device=card)
        paths = []
        real_sum = dispatch.segment_sum_cuda
        real_bwd = edge_aggregate.tensornet_interaction_backward_cuda

        def spy_sum(data, *a, **kw):
            paths.append(("B1", K.segment_sum_bf16_plan(data, a[0] if a else None)["path"]))
            return real_sum(data, *a, **kw)

        def spy_bwd(g, f, *a, **kw):
            paths.append(("bwd", K.tensornet_interaction_backward_bf16_plan(g, f, *a[:3])[
                "path"]))
            return real_bwd(g, f, *a, **kw)

        def spy_forward(which, real, plan):
            def spy(*a, **kw):
                paths.append((which, plan(*a[:4])["path"]))
                return real(*a, **kw)
            return spy

        forwards = {name: spy_forward(which, getattr(edge_aggregate, name), plan)
                    for which, name, plan in (
                        ("embed", "tensornet_embed_aggregate_cuda", K.tensornet_embed_bf16_plan),
                        ("interaction", "tensornet_interaction_aggregate_cuda",
                         K.tensornet_interaction_bf16_plan))}
        before = dict(K.launch_counts)
        with mock.patch.object(dispatch, "segment_sum_cuda", spy_sum), \
                mock.patch.object(edge_aggregate, "tensornet_interaction_backward_cuda",
                                  spy_bwd), \
                mock.patch.multiple(edge_aggregate, **forwards):
            pot.calculate(atoms)
        got = {k: K.launch_counts[k] - before[k] for k in before if K.launch_counts[k] > before[k]}
        if family == "tensornet":
            layers = model.cfg.num_layers
            assert got == {"tensornet_embed_aggregate_bf16": 1,
                           "tensornet_interaction_aggregate_bf16": layers,
                           "tensornet_interaction_backward_bf16": layers}
            assert sorted(paths) == sorted([("bwd", "channel pairs")] * layers
                                           + [("embed", "channel pairs")]
                                           + [("interaction", "channel pairs")] * layers)
            return
        k = chunk_layout(pot.last_stats["e_cap"], model.cfg.edge_chunk)[2]
        if family == "mace":
            want = {"segment_sum_bf16": model.cfg.num_interactions * 2 * k}
        else:
            want = {"segment_sum_bf16": (1 + model.cfg.num_layers) * 2 * k,
                    "so2_conv_bf16": model.cfg.num_layers * 3 * k}
        assert got == want
        assert paths == [("B1", ROW_PATH)] * want["segment_sum_bf16"]


# ---------------------------------------------------------------------------
# bfloat16: TensorNet's embed and interaction forwards (a warp a dst row, a
# channel pair a lane, edge indices and masks loaded by the warp)
# ---------------------------------------------------------------------------

FORWARDS = {"embed": ("tensornet_embed_aggregate", "tensornet_embed_bf16_plan"),
            "interaction": ("tensornet_interaction_aggregate", "tensornet_interaction_bf16_plan")}


def _forward_bf16_case(card, which, c, seed=0, e=3000, n=40, pad=100, masked=50, hi=None):
    """A bf16 forward case: ~e / n edges a dst row (several turns of 32 edge
    indices), dst-sorted ids with a padded tail and masked interior edges;
    the inputs drawn in float32 and rounded to bf16 once."""
    ids, mask, n = sorted_case(170 + seed, e, n, pad, masked, hi)
    draw = embed_inputs if which == "embed" else (
        lambda s, ee, cc: interaction_inputs(s, ee, 23, cc))
    to = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    arrays = [to(x).bfloat16() if x.dtype == np.float32 else to(x)
              for x in draw(170 + seed, len(ids), c)]
    return arrays, to(ids), to(mask), n


def _forward_bf16_call(which, arrays, ti, n, tm):
    """One bf16 forward call; checks that it launched its bf16 kernel once
    and nothing else."""
    from distmlip_tpu_torch import kernels as K

    count = FORWARDS[which][0]
    cuda = getattr(K, count + "_cuda")
    before = dict(K.launch_counts)
    got = cuda(*arrays, ti, n, tm)
    torch.cuda.synchronize()
    launched = {k: K.launch_counts[k] - before[k] for k in before}
    assert launched == dict({k: 0 for k in launched}, **{count + "_bf16": 1})
    return got


def _forward_float32_bits(which, arrays, ti, n, tm):
    """The float32 kernel on the upcast inputs, rounded once to bf16."""
    from distmlip_tpu_torch import kernels as K

    cuda = getattr(K, FORWARDS[which][0] + "_cuda")
    up = [x.float() if x.is_floating_point() else x for x in arrays]
    return cuda(*up, ti, n, tm).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("c,pairs", [(7, False), (64, True), (65, False), (300, True)])
@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_tensornet_forward_bf16_channels_on_card(card, which, c, pairs):
    """The bf16 embed and interaction at C = 7, 64, 65, 300: channel pairs
    where C is even (64 channels a warp, 300 on grid.y slabs), one channel a
    lane where it is odd, as the plan reports. Bit for bit the float32
    kernel on the upcast inputs rounded once (the same arithmetic in the same
    order); within the bf16 bound of the plain version; the ten empty dst
    rows (ids in [0, 30) of 40) are zeros; NaN in the masked edges' rows changes nothing (never read); two
    calls equal; all masked gives zeros."""
    from distmlip_tpu_torch import kernels as K

    with time_limit(60):
        arrays, ti, tm, n = _forward_bf16_case(card, which, c, seed=c, hi=30)
        plan = getattr(K, FORWARDS[which][1])(*arrays[:4], n)
        assert plan["channels_a_lane"] == (2 if pairs else 1)
        assert plan["channels_a_warp"] == 32 * plan["channels_a_lane"]
        assert plan["warps_a_row"] == -(-c // (64 if pairs else 32))
        assert plan["blocks"] == -(-n // plan["warps_a_block"])
        assert plan["path"] == ("channel pairs" if pairs else "single channels")
        got = _forward_bf16_call(which, arrays, ti, n, tm)
        assert got.dtype == torch.bfloat16 and got.shape == (n, 3, 3, c)
        assert torch.equal(got, _forward_float32_bits(which, arrays, ti, n, tm))
        ref = getattr(K, FORWARDS[which][0] + "_reference")(*arrays, ti, n, tm)
        bound = getattr(K, {"embed": "tensornet_embed_error_bound",
                            "interaction": "tensornet_interaction_error_bound"}[which])(
            *arrays, ti, n, tm)
        assert bool(((got.float() - ref.float()).abs() <= bound + 1e-30).all())
        empty = torch.ones(n, dtype=torch.bool, device=card)
        empty[ti[tm].long()] = False
        assert bool(empty.any()) and not bool(got[empty].any())
        nan = [x.clone() if x.is_floating_point() else x for x in arrays]
        for x in (nan[:4] + nan[4:6]) if which == "embed" else nan[:1]:
            x[~tm] = float("nan")
        assert torch.equal(_forward_bf16_call(which, nan, ti, n, tm), got)
        assert torch.equal(_forward_bf16_call(which, arrays, ti, n, tm), got)
        none = _forward_bf16_call(which, arrays, ti, n, torch.zeros_like(tm))
        assert not bool(none.any())


@pytest.mark.cuda
@pytest.mark.parametrize("offset,pairs", [(1, False), (2, True)])
@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_tensornet_forward_bf16_views_on_card(card, which, offset, pairs):
    """A first input viewed ``offset`` bf16 elements into its buffer: one
    element off a 4-byte boundary takes the single-channel path at even C,
    two keep channel pairs; both give the aligned call's bits. The embed's
    A_e and S_e viewed 1 and 3 elements off (read from an aligned-down base)
    keep the route and the bits."""
    from distmlip_tpu_torch import kernels as K

    def view(x, off):
        buf = torch.zeros(x.numel() + off, dtype=x.dtype, device=card)
        buf[off:] = x.reshape(-1)
        return buf[off:].view(x.shape)

    with time_limit(60):
        arrays, ti, tm, n = _forward_bf16_case(card, which, 64, seed=offset)
        want = _forward_bf16_call(which, arrays, ti, n, tm)
        moved = [view(arrays[0], offset)] + arrays[1:]
        plan = getattr(K, FORWARDS[which][1])(*moved[:4], n)
        assert plan["channels_a_lane"] == (2 if pairs else 1)
        assert torch.equal(_forward_bf16_call(which, moved, ti, n, tm), want)
        if which == "embed":
            geo = arrays[:4] + [view(arrays[4], 1), view(arrays[5], 3)]
            assert getattr(K, FORWARDS[which][1])(*geo[:4], n)[
                "channels_a_lane"] == 2
            assert torch.equal(_forward_bf16_call(which, geo, ti, n, tm), want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_tensornet_forward_bf16_long_rows_on_card(card, which):
    """Rows of thousands of edges (hundreds of turns of 32) broken by masked
    stretches longer than a turn, at C = 64 and 300: bit for bit the float32
    kernel on the upcast inputs rounded once."""
    with time_limit(120):
        for c in (64, 300):
            arrays, ti, tm, n = _forward_bf16_case(card, which, c, seed=7, e=9000, n=3,
                                                   pad=40, masked=0)
            rows = ti.cpu().numpy()
            first = np.nonzero(rows == 1)[0]
            stretch = torch.zeros_like(tm)
            stretch[int(first[100]):int(first[100]) + 500] = True  # 500 masked edges in row 1
            tm = tm & ~stretch
            got = _forward_bf16_call(which, arrays, ti, n, tm)
            assert torch.equal(got, _forward_float32_bits(which, arrays, ti, n, tm))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["embed", "interaction"])
def test_tensornet_forward_bf16_padding_only_tail_on_card(card, which):
    """Every edge on the last dst row: all masked gives zeros (the clamped
    CSR offsets walk nothing); its last five valid, their sum on that row
    only, bit for bit the float32 kernel's rounded once."""
    with time_limit(60):
        arrays, ti, tm, n = _forward_bf16_case(card, which, 64, seed=9, e=4000, n=50)
        one_row = torch.full_like(ti, n - 1)
        none = torch.zeros_like(tm)
        assert not bool(_forward_bf16_call(which, arrays, one_row, n, none).any())
        last5 = torch.arange(len(ti), device=card) >= len(ti) - 5
        got = _forward_bf16_call(which, arrays, one_row, n, last5)
        assert torch.equal(got, _forward_float32_bits(which, arrays, one_row, n, last5))
        assert not bool(got[:-1].any()) and bool(got[-1].any())


ESCN_MD_CFG = dict(max_num_elements=10, sphere_channels=16, lmax=2, mmax=1, num_layers=2,
                   hidden_channels=16, edge_channels=8, num_distance_basis=12, cutoff=3.5,
                   avg_degree=12.0, num_experts=3, edge_chunk=64)


def _close(got, want, tag):
    """The repo's float32 bar: rel dE < 1e-5, max |dF|, |dS|, |dm| < 1e-4."""
    assert abs(got["energy"] - want["energy"]) < 1e-5 * abs(want["energy"]), tag
    for k in ("forces", "stress", "magmoms"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=tag)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 2])
def test_escn_md_on_card_matches_plain(card, P, dtype):
    """``ESCNMD`` (3 MOLE experts, mmax 1, edge chunks of 64, so K > 1)
    through ``UMAPredictor`` on the card against ``kernels=False`` on the
    card, with charge and spin set: B1 launches (1 + num_layers) x 2K per
    calculate (the edge-degree pass and each layer, once per chunk and once
    more in the backward's recompute of the checkpointed chunk body), the
    count of ``tests/test_torch_escn_md.py``'s
    ``test_segment_sum_calls_per_calculate``."""
    from distmlip_tpu_torch.calculators import UMAPredictor
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import ESCNMD, ESCNMDConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    atoms = _long_cell(n_species=3)
    atoms.info = {"charge": 1, "spin": 2}
    model = ESCNMD(ESCNMDConfig(**ESCN_MD_CFG, dtype=dtype))
    params = model.init(0)
    pred = UMAPredictor(model, params, task_name="oc20", device=card, num_partitions=P)
    before = dict(launch_counts)
    gpu = pred.calculate(atoms)
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    st = pred.potential.last_stats
    if P == 2:
        k = chunk_layout(2 * st["e_cap"], ESCN_MD_CFG["edge_chunk"], 2 * st["e_split"])[2]
    else:
        k = chunk_layout(st["e_cap"], ESCN_MD_CFG["edge_chunk"])[2]
    assert k > 1
    name = "segment_sum" if dtype == "float32" else "segment_sum_bf16"
    want = {n: 0 for n in got}
    want[name] = (1 + ESCN_MD_CFG["num_layers"]) * 2 * k
    assert got == want
    plain = UMAPredictor(model, params, task_name="oc20", device=card, num_partitions=P,
                         kernels=False).calculate(atoms)
    assert {n: launch_counts[n] - before[n] for n in launch_counts} == want
    if dtype == "float32":
        _close(gpu, plain, f"ESCNMD P={P}")
    else:
        _bf16_close(gpu, plain, f"ESCNMD bf16 P={P}")


def _light_cell():
    """32 rattled fcc Li atoms (a = 3.5 Å) with 1000 K velocities from a
    seed: a 0.3 Å skin is spent within a few 1 fs steps."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(4)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (len(frac), 3))
    atoms = Atoms(numbers=np.full(len(cart), 3), positions=cart, cell=lat)
    atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(5))
    return atoms


@pytest.mark.cuda
def test_device_md_on_card_matches_plain(card):
    """10 ``DeviceMD`` steps of a small TensorNet with the in-loop refresh
    on the card (kernels) against ``kernels=False`` on the card: the same
    refreshes, positions within 1e-4 Å; one host read a step plus one a
    refresh; B2 launches 1 embed + L interactions + L backwards per force
    evaluation, one evaluation per step and one at the chunk's start."""
    from distmlip_tpu_torch.calculators import DeviceMD, DistPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import TensorNet, TensorNetConfig

    model = TensorNet(TensorNetConfig(num_species=4, units=16, num_rbf=8, cutoff=3.0))
    params = model.init(0)
    params["data_std"] = torch.tensor(10.0)  # forces of eV/Å, not meV/Å
    runs = []
    for kernels in (True, False):
        atoms = _light_cell()
        md = DeviceMD(DistPotential(model, params, device=card, skin=0.3, kernels=kernels),
                      atoms, timestep=1.0)
        before = dict(launch_counts)
        md.run(10)
        runs.append((md, atoms, {k: launch_counts[k] - before[k] for k in launch_counts}))
    (md, atoms, got), (ref, ref_atoms, plain_launches) = runs
    assert md.device_rebuild and md.steps_done == 10 and md.rebuilds_on_device >= 1
    assert [md.rebuilds, md.rebuilds_on_device, md.rebuild_overflows] == [
        ref.rebuilds, ref.rebuilds_on_device, ref.rebuild_overflows]
    assert md.host_reads == 10 + md.rebuilds_on_device
    evaluations, layers = 11, model.cfg.num_layers
    want = {k: 0 for k in got}
    want.update(tensornet_embed_aggregate=evaluations,
                tensornet_interaction_aggregate=layers * evaluations,
                tensornet_interaction_backward=layers * evaluations)
    assert got == want and not any(plain_launches.values())
    np.testing.assert_allclose(atoms.positions, ref_atoms.positions, rtol=0, atol=1e-4)
    assert abs(md.results["energy"] - ref.results["energy"]) < 1e-5 * abs(ref.results["energy"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mace", "chgnet"])
def test_ensemble_on_card_stacked_matches_sequential(card, family):
    """``EnsemblePotential`` on the card: the stacked route (one graph, the
    members through one force program in turn) against the sequential one
    (a ``DistPotential`` per member) within the float32 bar, member by
    member, and M times one member's launches."""
    from distmlip_tpu_torch.calculators import EnsemblePotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, MACE, MACEConfig

    atoms = _long_cell()
    if family == "mace":
        model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                                correlation=2, cutoff=3.0, edge_chunk=128))
        members, kw = [model.init(s) for s in range(3)], {}
    else:
        model = CHGNet(CHGNetConfig(num_species=4, units=16, num_rbf=6, num_blocks=3,
                                    cutoff=3.0, bond_cutoff=2.6))
        members, kw = [model.init(s) for s in range(2)], {"compute_magmom": True}
    counts = []
    results = []
    for stacked in (True, False):
        ens = EnsemblePotential(model, members, stacked=stacked, device=card, **kw)
        before = dict(launch_counts)
        results.append(ens.calculate(atoms))
        counts.append({k: launch_counts[k] - before[k] for k in launch_counts})
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    got, want = results
    for m in range(len(members)):
        one = {"energy": got["energies"][m], "forces": got["forces_all"][m]}
        ref = {"energy": want["energies"][m], "forces": want["forces_all"][m]}
        if "magmoms_all" in want:
            one["magmoms"], ref["magmoms"] = got["magmoms_all"][m], want["magmoms_all"][m]
        _close(one, ref, f"{family} member {m}")
    _close(got, want, f"{family} means")
    assert got["energy_var"] > 0


# the four families at small widths for the training step on the card, with
# the kernels each must launch (the CPU tests' widths,
# tests/torch_train_common.py; MACE and eSCN with edge chunks of 128, so
# K > 1 and remat's recompute run under the double backward)
TRAIN_CASES = {
    "mace": ("MACE", dict(num_species=3, channels=8, l_max=1, a_lmax=1, hidden_lmax=1,
                          correlation=2, num_interactions=2, num_bessel=4, radial_mlp=8,
                          cutoff=3.2, avg_num_neighbors=12.0, edge_chunk=128, remat=True),
             ("segment_sum",)),
    "mace-bf16": ("MACE", dict(num_species=3, channels=8, l_max=1, a_lmax=1, hidden_lmax=1,
                               correlation=2, num_interactions=2, num_bessel=4,
                               radial_mlp=8, cutoff=3.2, avg_num_neighbors=12.0,
                               edge_chunk=128, remat=True, dtype="bfloat16"),
                  ("segment_sum_bf16",)),
    "tensornet": ("TensorNet", dict(num_species=3, units=8, num_rbf=4, num_layers=1,
                                    cutoff=3.2),
                  ("tensornet_embed_aggregate", "tensornet_interaction_aggregate")),
    "chgnet": ("CHGNet", dict(num_species=3, units=8, num_rbf=4, num_blocks=2, cutoff=3.2,
                              bond_cutoff=2.6),
               ("chgnet_atom_conv_aggregate", "chgnet_line_aggregate")),
    "escn": ("ESCN", dict(num_species=3, channels=8, l_max=2, num_layers=2, num_bessel=4,
                          num_experts=2, cutoff=3.2, avg_num_neighbors=12.0, edge_chunk=128,
                          remat=True),
             ("so2_conv", "segment_sum")),
}


def _train_grads(model, params, graph, targets, kernels, cfg):
    """Loss terms and the flat parameter gradient of one packed micro-batch
    from a fresh fp32 master copy of ``params`` on the card."""
    import functools

    from distmlip_tpu_torch.train import init_train_state, make_packed_loss_fn
    from distmlip_tpu_torch.train.step import param_leaves

    state = init_train_state(functools.partial(torch.optim.SGD, lr=0.0), params, config=cfg,
                             device="cuda")
    loss, comps = make_packed_loss_fn(model.energy_fn, config=cfg, kernels=kernels)(
        state.params, graph, targets)
    leaves = param_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    vec = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                     for p, g in zip(leaves, grads)])
    return {k: float(v) for k, v in comps.items()}, vec.double().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(TRAIN_CASES))
def test_train_step_on_card_matches_plain(card, family):
    """One training step's loss terms and parameter gradient (forces and
    stress through ``create_graph``, then the parameter gradient: every
    kernel under the double backward) with the kernels against
    ``kernels=False`` on the card, on 4 packed 32-atom cells with stress
    on. float32: loss terms within rel 1e-5, gradient within rel L2 1e-4.
    bf16: the kernel route no further from the float32 model's gradient
    than the plain bf16 route is (x 1.25 + 1e-3), and within rel L2 5e-3 of
    the plain bf16 route's gradient and rel 1e-3 of its loss. The path's
    kernels launch."""
    import dataclasses

    import distmlip_tpu_torch.models as models
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.calculators import Atoms
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.train import PackedBatchLoader, Sample, TrainConfig

    name, kw, kernels = TRAIN_CASES[family]
    model = getattr(models, name)(getattr(models, name + "Config")(**kw))
    rng = np.random.default_rng(7)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.6, (2, 2, 2))
    samples = []
    for _ in range(4):
        cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (len(frac), 3))
        atoms = Atoms(numbers=rng.integers(0, 3, len(frac)), positions=cart, cell=lat)
        if family == "escn":
            atoms.info = {"charge": 1, "spin": 1, "dataset": 2}
        samples.append(Sample(atoms, float(rng.normal()),
                              rng.normal(0, 0.1, (len(frac), 3)).astype(np.float32),
                              rng.normal(0, 0.01, (3, 3)).astype(np.float32)))
    extra = {"use_bond_graph": True, "bond_cutoff": 2.6} if family == "chgnet" else {}
    loader = PackedBatchLoader(samples, 3.2, micro_batch_size=4, shuffle=False, prefetch=0,
                               **extra)
    batch = loader.next_batch().to(card)
    loader.close()
    params = model.init(0)
    cfg = TrainConfig(w_stress=10.0, precision="bf16" if family.endswith("bf16") else "fp32")
    before = dict(launch_counts)
    got, g_k = _train_grads(model, params, batch.graphs[0], batch.targets[0], True, cfg)
    launched = {k: launch_counts[k] - before[k] for k in kernels}
    assert all(launched.values()), launched
    want, g_p = _train_grads(model, params, batch.graphs[0], batch.targets[0], False, cfg)
    assert torch.isfinite(g_k).all() and float(g_p.norm()) > 0
    if not family.endswith("bf16"):
        for k in ("loss", "energy", "force", "stress"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
        assert float((g_k - g_p).norm() / g_p.norm()) < 1e-4
        return
    ref = getattr(models, name)(dataclasses.replace(model.cfg, dtype="float32"))
    _, g_32 = _train_grads(ref, params, batch.graphs[0], batch.targets[0], False,
                           TrainConfig(w_stress=10.0))
    d_k = float((g_k - g_32).norm() / g_32.norm())
    d_p = float((g_p - g_32).norm() / g_32.norm())
    d_kp = float((g_k - g_p).norm() / g_p.norm())
    dl_kp = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    assert d_k <= 1.25 * d_p + 1e-3, (d_k, d_p)
    # and the two bf16 routes directly: an H100 run measured the gradients
    # 1.1e-3 apart (rel L2) and the losses equal; the distance to float32
    # alone (~8e-3 here) would let an added error of that size through
    assert d_kp <= 5e-3 and dl_kp <= 1e-3, (d_kp, dl_kp)


@pytest.mark.cuda
def test_telemetry_record_on_card(card):
    """A small MACE's calculates on the card with a hub: one record each,
    the kernels' routing (``kernel_mode`` "cuda"), the card's memory under
    the JAX key names, 0 < mfu < 1; the numbers equal a run without the hub
    under deterministic algorithms."""
    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.telemetry import Telemetry, TelemetrySink

    class Keep(TelemetrySink):
        def __init__(self):
            self.records = []

        def emit(self, record):
            self.records.append(record)

    model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                            correlation=2, cutoff=3.0, edge_chunk=64))
    params = model.init(0)
    out = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for hub in (None, Telemetry([Keep()])):
            pot = DistPotential(model, params, device=card, skin=0.3, telemetry=hub)
            atoms = _light_cell()
            res = [pot.calculate(atoms)]
            atoms.positions = atoms.positions + 0.01
            res.append(pot.calculate(atoms))
            out.append((res, hub))
    finally:
        torch.use_deterministic_algorithms(was)
    (plain, _), (got, hub) = out
    for a, b in zip(plain, got):
        assert a["energy"] == b["energy"] and np.array_equal(a["forces"], b["forces"])
    recs = hub.sinks[0].records
    assert len(recs) == 2 and recs[0].rebuild and recs[1].graph_reused
    for r in recs:
        assert r.kernel_mode == "cuda" and 0 < r.kernel_coverage <= 1
        assert {"dev0_bytes_in_use", "dev0_peak_bytes_in_use", "dev0_bytes_limit"} <= set(
            r.device_memory)
        assert 0 < r.mfu < 1 and r.flops_per_step > 0 and r.n_atoms == len(atoms)


@pytest.mark.cuda
def test_attribution_of_a_captured_step(card, tmp_path):
    """One warm calculate of a small MACE under a CPU + CUDA profile: the
    Chrome trace's ``custom_kernel`` bucket equals the B1 kernels' device
    time from ``key_averages`` (within 2%), and the interaction scopes and
    their backward carry device time."""
    from torch.profiler import ProfilerActivity, profile

    from distmlip_tpu_torch.calculators import DistPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.obs import attribution

    model = MACE(MACEConfig(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                            correlation=2, cutoff=3.0, edge_chunk=64))
    pot = DistPotential(model, model.init(0), device=card, skin=0.3)
    atoms = _light_cell()
    pot.calculate(atoms)
    atoms.positions = atoms.positions + 0.01
    pot.calculate(atoms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pot.calculate(atoms)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    own = sum(e.self_device_time_total for e in prof.key_averages()
              if attribution.is_port_kernel(e.key)) * 1e-6
    bd = attribution.attribute(0.0, trace=path, program="mace")
    assert own > 0 and abs(bd.by_category["custom_kernel"] - own) <= 0.02 * own
    layers = attribution.by_layer(bd)
    assert layers.get("mace/interaction0", 0) > 0 and layers.get("mace/interaction1", 0) > 0
    assert any(k.endswith("/backward") for k in bd.by_scope)
    assert bd.by_category.get("gradient_transpose", 0) > 0


# the fleet and the active lane on the card: a small MACE with edge chunks
# of 128 (K > 1), the 64-atom long cell and rattled copies of it
FLEET_MACE = dict(num_species=4, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                  correlation=2, cutoff=3.0, edge_chunk=128)


def _fleet_pool(n):
    base = _long_cell()
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        a = base.copy()
        a.positions = a.positions + rng.normal(0, 0.02, a.positions.shape)
        out.append(a)
    return out


@pytest.mark.cuda
def test_fleet_replicas_share_the_card(card):
    """Two replicas on one card, each on its own scheduler thread, sharing
    one ``BucketPolicy``: the launch counts add up to the sum over every
    calculate's own (2 interactions x 2K for its e_cap); the bytes model
    they calibrate equals a lone potential's over the same structures (no
    replica's measured peak counts the other's work); the budgets sum to at
    most the card's room."""
    import threading

    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.fleet import ResultCache, make_fleet
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.ops.chunk import chunk_layout
    from distmlip_tpu_torch.partition import BucketPolicy

    model = MACE(MACEConfig(**FLEET_MACE))
    params = model.init(0)
    pool = _fleet_pool(16)
    caps = BucketPolicy()
    e_caps, lock = [], threading.Lock()

    def factory(i):
        pot = BatchedPotential(model, params, device=card, caps=caps)
        real = pot.calculate

        def call(structures):
            out = real(structures)
            with lock:
                e_caps.append(pot.last_stats["e_cap"])
            return out
        pot.calculate = call
        return pot

    router = make_fleet(2, factory, engine_kwargs=dict(max_batch=1, max_wait_s=0.001),
                        result_cache=ResultCache(), model_id="mace")
    pots = [r.engine.potential for r in router.replicas.values()]
    assert sum(p.hbm_budget_bytes for p in pots) <= 0.8 * torch.cuda.mem_get_info(card)[1]
    for rep in router.replicas.values():   # each scheduler thread's first-use work
        rep.engine.submit(pool[0]).result(timeout=600)
    torch.cuda.synchronize(card)
    caps._bytes_by_cap.clear()
    torch.cuda.reset_peak_memory_stats(card)
    e_caps.clear()
    for k in launch_counts:
        launch_counts[k] = 0
    for f in [router.submit(a) for a in pool]:
        assert np.isfinite(f.result(timeout=600)["energy"])
    router.drain(timeout=600)
    launched = dict(launch_counts)
    measured = dict(caps._bytes_by_cap)
    assert all(r["dispatched_total"] > 1 for r in router.snapshot()["replicas"].values())
    router.close()
    want = sum(2 * 2 * chunk_layout(e, FLEET_MACE["edge_chunk"])[2] for e in e_caps)
    assert len(e_caps) == len(pool) and launched["segment_sum"] == want
    lone_caps = BucketPolicy()
    lone = BatchedPotential(model, params, device=card, caps=lone_caps)
    lone.calculate([pool[0]])
    torch.cuda.synchronize(card)
    lone_caps._bytes_by_cap.clear()
    torch.cuda.reset_peak_memory_stats(card)
    for a in pool:
        lone.calculate([a])
    assert measured and measured == lone_caps._bytes_by_cap


@pytest.mark.cuda
def test_replica_calibrates_after_a_finetune(card):
    """A fine-tune on the card between a replica's batches leaves the
    allocator's mark far above a batch's; the replica's next batch on a new
    bucket still measures its own peak and calibrates its rung, and
    ``device.peak_allocated`` still reads the fine-tune's mark."""
    from distmlip_tpu_torch.active import run_finetune
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.device import peak_allocated, reset_peak
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.partition import BucketPolicy
    from distmlip_tpu_torch.train import Sample

    model = MACE(MACEConfig(**FLEET_MACE))
    params = model.init(0)
    pool = _fleet_pool(8)
    caps = BucketPolicy()
    pot = BatchedPotential(model, params, device=card, caps=caps)
    reset_peak(card)
    base = torch.cuda.memory_allocated(card)
    pot.calculate(pool[:1])
    first = pot.last_stats["batch_peak_bytes"]
    assert first > 0 and caps.has_calibrated_rung(len(pool[0]))
    rng = np.random.default_rng(3)
    samples = [Sample(a, float(rng.normal()), rng.normal(0, 0.1, (len(a), 3)).astype(np.float32),
                      np.zeros((3, 3), np.float32)) for a in pool]
    run_finetune(model, params, samples, steps=1, micro_batch_size=4, device=card)
    high = peak_allocated(card)
    assert high > base + first
    n = 3 * len(pool[0])
    assert not caps.has_calibrated_rung(n)
    pot.calculate(pool[:3])
    assert pot.last_stats["batch_peak_bytes"] > 0 and caps.has_calibrated_rung(n)
    assert peak_allocated(card) >= high


@pytest.mark.cuda
def test_ensemble_lane_on_card_matches_plain(card):
    """``EnsembleBatchedPotential.calculate_with_variance`` with the kernels
    against ``kernels=False`` on the card, member by member, within the
    float32 bar, and M times one member's launches."""
    from distmlip_tpu_torch.active import EnsembleBatchedPotential
    from distmlip_tpu_torch.kernels import launch_counts
    from distmlip_tpu_torch.models import MACE, MACEConfig

    model = MACE(MACEConfig(**FLEET_MACE))
    members = [model.init(s) for s in range(3)]
    pool = _fleet_pool(3)
    out = []
    counts = []
    for kernels in (True, False):
        ens = EnsembleBatchedPotential(model, members, device=card, kernels=kernels)
        before = dict(launch_counts)
        out.append(ens.calculate_with_variance(pool))
        counts.append({k: launch_counts[k] - before[k] for k in launch_counts})
    assert counts[0]["segment_sum"] > 0 and not any(counts[1].values())
    one = EnsembleBatchedPotential(model, members[:1], device=card)
    before = dict(launch_counts)
    one.calculate_with_variance(pool)
    assert counts[0]["segment_sum"] == 3 * (launch_counts["segment_sum"]
                                            - before["segment_sum"])
    for got, want in zip(*out):
        for m in range(3):
            _close({"energy": got["energies"][m], "forces": got["forces_all"][m]},
                   {"energy": want["energies"][m], "forces": want["forces_all"][m]},
                   f"member {m}")
        _close(got, want, "means")


@pytest.mark.cuda
def test_hot_swap_on_card(card):
    """A hot swap into a live engine on the card: no new serving bucket,
    the weights land on the card as a copy, and the post-swap result
    equals a fresh potential at the new weights within the float32 bar."""
    from distmlip_tpu_torch.active import hot_swap_engine
    from distmlip_tpu_torch.calculators import BatchedPotential
    from distmlip_tpu_torch.models import MACE, MACEConfig
    from distmlip_tpu_torch.serve import ServeEngine

    model = MACE(MACEConfig(**FLEET_MACE))
    p0, p1 = model.init(0), model.init(1)
    # batches of one: every request lands in the bucket the warm round made
    engine = ServeEngine(BatchedPotential(model, p0, device=card), max_batch=1,
                         max_wait_s=0.001)
    pool = _fleet_pool(4)
    for f in [engine.submit(a) for a in pool]:
        f.result(timeout=600)
    compiles = engine.compile_count
    report = hot_swap_engine(engine, p1)
    got = [engine.submit(a).result(timeout=600) for a in pool]
    assert report["compile_count"] == engine.compile_count == compiles
    leaf = engine.potential.params["species_emb"]["w"]
    assert leaf.is_cuda and leaf.data_ptr() != p1["species_emb"]["w"].data_ptr()
    ref = BatchedPotential(model, p1, device=card).calculate(pool)
    for a, b in zip(got, ref):
        _close(a, b, "post-swap")
    engine.close()
