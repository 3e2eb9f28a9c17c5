"""The layer-1 split of the port's CHGNet kernels, on the CPU.

The CUDA kernels take layer 1 of the gated MLP apart: a linear layer
distributes over the concat row, so each gathered segment's product is taken
once per node or bond row (the row projection) and the per-edge kernel adds
the gathered partial rows to the edge segment's own product. The packing of
the weights (``kernels.chgnet_pack_weights``) and the plan of the row tables
(``kernels.chgnet_row_tables``) are plain torch that the CUDA wrappers run
too; here a torch emulation of the kernels' arithmetic uses exactly those
packed buffers and tables (with the projection's plain version) and is held
against the plain versions (``chgnet_*_aggregate_reference``) and the JAX
package's dispatcher through the interpret-mode Pallas kernel
(``fused_edge_aggregate(kernels="interpret")``).

Inputs are numpy from a fixed seed at small widths (C = 8 and 16, H != C),
with the atom conv's node rows gathered from one tensor and from two, and
abw present and absent. float32 within ``chgnet_aggregate_error_bound`` (the
kernels' tolerance: the split only reorders layer 1's dot product of length
K1 plus its bias, and the bound holds for any order); float64 to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distmlip_tpu_torch.kernels import (chgnet_aggregate_error_bound,
                                        chgnet_atom_conv_aggregate_reference,
                                        chgnet_line_aggregate_reference, chgnet_pack_weights,
                                        chgnet_row_projection_reference, chgnet_row_tables)
from distmlip_tpu_torch.ops.segment import masked_segment_sum
from tests.test_torch_cuda import chgnet_rows, sorted_case
from tests.test_torch_edge_aggregate import _jax_chgnet, _jax_gated
from tests.torch_threads import one_intra_op_thread  # noqa: F401

WIDTHS = [(8, 12), (16, 10)]


def split_inputs(seed, which, c, h, same, abw=True, n_node=23):
    """numpy inputs of one CHGNet message in its plain version's order (up
    to ``weights``), dst-sorted ids with a padded tail and masked interior
    rows. ``same``: the two gathered row arrays (node at src and dst, or
    bond at both ends) are one array; else a second one with other rows."""
    ids, mask, n = sorted_case(seed, 260, 29, 12, 4)
    rng = np.random.default_rng(600 + seed)
    e = len(ids)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def idx(rows):
        return rng.integers(0, rows, e).astype(np.int32)

    first = f32(n_node, c)
    second = first if same else f32(n_node + 5, c)
    if which == "atom":
        arrays = [first, idx(n_node), second, idx(second.shape[0]), f32(e, c),
                  f32(e, c) if abw else None]
        k1 = 3 * c
    else:
        arrays = [first, idx(n_node), second, idx(second.shape[0]), f32(e, c),
                  f32(n_node + 3, c), idx(n_node + 3)]
        k1 = 4 * c
    weights = []
    for _ in range(2):
        weights += [f32(k1, h) / k1 ** 0.5, f32(h) / k1 ** 0.5, f32(h, c) / h ** 0.5,
                    f32(c) / h ** 0.5]
    return arrays, weights, ids, mask, n


def to_torch(arrays, dtype=torch.float32):
    """numpy -> torch; an array that appears twice becomes one tensor."""
    out = []
    for x in arrays:
        prev = next((t for a, t in zip(arrays, out) if a is x), None)
        if prev is not None:
            out.append(prev)
        elif x is None:
            out.append(None)
        elif x.dtype == np.int32:
            out.append(torch.from_numpy(x))
        else:
            out.append(torch.from_numpy(x).to(dtype))
    return out


def emulate(which, t, weights, ids, n, mask, project=chgnet_row_projection_reference):
    """The kernels' arithmetic in torch, on the packed buffers and the row
    tables the CUDA wrappers build: project the gathered segments' rows
    (the layer-1 bias folded into the first), gather the partial rows, add
    the edge segment's product, then silu, layer 2 of core and gate on the
    padded blocks, the gating (and abw) and the masked dst sum."""
    if which == "atom":
        node_src, src, node_dst, dst, edge, abw = t
        gathered = [(node_src, src), (node_dst, dst)]
    else:
        bond_src, ls, bond_dst, ld, edge, node, ctr = t
        gathered, abw = [(bond_src, ls), (bond_dst, ld), (node, ctr)], None
    c = edge.shape[1]
    packed = chgnet_pack_weights(weights, len(gathered) + 1, 2, c)
    tables = chgnet_row_tables([g for g, _ in gathered], packed, project)
    w1s, cp = packed.b1.shape[0], packed.w1e.shape[0]
    hp = w1s // 2
    z = tables[0][0][:, tables[0][1]:tables[0][1] + w1s].index_select(0, gathered[0][1].long())
    z = z + F.pad(edge, (0, cp - c)) @ packed.w1e
    for (table, off), (_, idx) in zip(tables[1:], gathered[1:]):
        z = z + table[:, off:off + w1s].index_select(0, idx.long())
    hidden = F.silu(z)
    core = hidden[:, :hp] @ packed.w2[:, :cp] + packed.b2[:cp]
    gate = hidden[:, hp:] @ packed.w2[:, cp:] + packed.b2[cp:]
    m = F.silu(core)[:, :c] * torch.sigmoid(gate)[:, :c]
    if abw is not None:
        m = m * abw
    return masked_segment_sum(m, ids, n, mask)


def plain(which, t, weights, ids, n, mask):
    ref = (chgnet_atom_conv_aggregate_reference if which == "atom"
           else chgnet_line_aggregate_reference)
    return ref(*t, weights, ids, n, mask)


def _cases():
    for c, h in WIDTHS:
        for same in (True, False):
            for abw in (True, False):
                yield pytest.param("atom", c, h, same, abw,
                                   id=f"atom-c{c}-h{h}-{'one' if same else 'two'}_tensors-"
                                      f"{'abw' if abw else 'no_abw'}")
            yield pytest.param("line", c, h, same, False,
                               id=f"line-c{c}-h{h}-{'one' if same else 'two'}_tensors")


@pytest.mark.parametrize("which,c,h,same,abw", list(_cases()))
def test_split_matches_plain_and_jax_float32(which, c, h, same, abw):
    """The emulation vs the plain version and vs the JAX dispatcher through
    the interpret-mode Pallas kernel, each within the derived bound."""
    arrays, weights, ids, mask, n = split_inputs(3, which, c, h, same, abw)
    t = to_torch(arrays)
    tw = [torch.from_numpy(w) for w in weights]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got = emulate(which, t, tw, ti, n, tm)
    want = plain(which, t, tw, ti, n, tm)
    x, ab = chgnet_rows(which, t)
    bound = chgnet_aggregate_error_bound(x, ab, tw, ti, n, tm)
    assert got.shape == want.shape == (n, c)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    jarrays = list(arrays)
    if which == "atom" and not abw:  # the JAX edge_fn multiplies by abw: ones
        jarrays[5] = np.ones((len(ids), c), np.float32)
    jax_out = np.asarray(_jax_chgnet(which, [jnp.asarray(a) for a in jarrays],
                                     _jax_gated(weights), ids, mask, n, "interpret"))
    assert bool(((got - torch.from_numpy(np.array(jax_out))).abs() <= bound + 1e-30).all())


@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("same", [True, False], ids=["one_tensor", "two_tensors"])
def test_split_matches_plain_float64(which, same):
    """In float64 the split and the plain version agree to 1e-12."""
    arrays, weights, ids, mask, n = split_inputs(5, which, 16, 10, same)
    t = to_torch(arrays, torch.float64)
    tw = [torch.from_numpy(w).double() for w in weights]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got = emulate(which, t, tw, ti, n, tm)
    want = plain(which, t, tw, ti, n, tm)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("same", [True, False], ids=["one_tensor", "two_tensors"])
def test_row_tables_take_one_pass_per_tensor(which, same):
    """Segments that gather one tensor share one projection pass with their
    blocks side by side; the bias goes on the first segment only; every
    table has the layout (rows, passes x 2 hp)."""
    arrays, weights, ids, mask, n = split_inputs(7, which, 8, 12, same)
    t = to_torch(arrays)
    tw = [torch.from_numpy(w) for w in weights]
    calls = []

    def spy(x, w, bias):
        calls.append((x, w.shape, bias))
        return chgnet_row_projection_reference(x, w, bias)

    nodes = [t[0], t[2]] + ([t[5]] if which == "line" else [])
    packed = chgnet_pack_weights(tw, len(nodes) + 1, 2, 8)
    tables = chgnet_row_tables(nodes, packed, spy)
    w1s = packed.b1.shape[0]
    assert w1s == 2 * 12
    expected = (1 if same else 2) + (1 if which == "line" else 0)
    assert len(calls) == expected
    assert calls[0][2] is not None and all(b is None for _, _, b in calls[1:])
    if same:
        assert calls[0][1] == (8, 2 * w1s)
        assert tables[0][0] is tables[1][0] and (tables[0][1], tables[1][1]) == (0, w1s)
        assert not bool(calls[0][2][w1s:].any())  # the dst block carries no bias
    else:
        assert tables[0][0] is not tables[1][0] and tables[1][1] == 0
    for (table, off), node in zip(tables, nodes):
        assert table.shape[0] == node.shape[0] and off + w1s <= table.shape[1]


def test_pack_weights_layout():
    """The packed blocks rebuild W1 segment by segment, core and gate side
    by side with zero padding to multiples of 4; the edge block, W2 and the
    biases the same way."""
    c, h = 7, 10
    rng = np.random.default_rng(11)
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((3 * c, h), (h,), (h, c), (c,)) * 2]
    p = chgnet_pack_weights(w, 3, 2, c)
    hp, cp = 12, 8
    assert len(p.blocks) == 2 and all(b.shape == (c, 2 * hp) for b in p.blocks)
    for s, b in enumerate(p.blocks):
        assert torch.equal(b[:, :h], w[0][s * c:(s + 1) * c])
        assert torch.equal(b[:, hp:hp + h], w[4][s * c:(s + 1) * c])
        assert not bool(b[:, h:hp].any()) and not bool(b[:, hp + h:].any())
    assert p.w1e.shape == (cp, 2 * hp) and not bool(p.w1e[c:].any())
    assert torch.equal(p.w1e[:c, :h], w[0][2 * c:]) and torch.equal(p.w1e[:c, hp:hp + h],
                                                                     w[4][2 * c:])
    assert torch.equal(p.b1[:h], w[1]) and torch.equal(p.b1[hp:hp + h], w[5])
    assert p.w2.shape == (hp, 2 * cp) and not bool(p.w2[h:].any())
    assert torch.equal(p.w2[:h, :c], w[2]) and torch.equal(p.w2[:h, cp:cp + c], w[6])
    assert torch.equal(p.b2[:c], w[3]) and torch.equal(p.b2[cp:cp + c], w[7])
    assert all(x.is_contiguous() for x in (*p.blocks, p.b1, p.w1e, p.w2, p.b2))


@pytest.mark.parametrize("which", ["atom", "line"])
def test_split_nonfinite_rows_no_valid_edge_gathers(which):
    """Node and bond rows that only masked edges (or no edge) gather may be
    NaN: the projection writes NaN partial rows, which no valid edge reads,
    so the sum stays finite and equal to the plain version's."""
    arrays, weights, ids, mask, n = split_inputs(9, which, 16, 10, True, n_node=400)
    t = to_torch(arrays)
    tw = [torch.from_numpy(w) for w in weights]
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    gathered = [(0, 1), (2, 3)] + ([(5, 6)] if which == "line" else [])
    used = {}
    for k, i in gathered:  # rows of one tensor gathered at several ids: the union
        u = used.setdefault(id(t[k]), torch.zeros(t[k].shape[0], dtype=torch.bool))
        u[t[i][tm].long()] = True
    for k, _ in gathered:
        u = used[id(t[k])]
        assert not bool(u.all())
        t[k][~u] = float("nan")
    got = emulate(which, t, tw, ti, n, tm)
    want = plain(which, t, tw, ti, n, tm)
    x, ab = chgnet_rows(which, t)
    bound = chgnet_aggregate_error_bound(x, ab, tw, ti, n, tm)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(bound).all())
    assert bool(((got - want).abs() <= bound + 1e-30).all())
