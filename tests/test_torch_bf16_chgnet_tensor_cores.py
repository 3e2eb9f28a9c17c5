"""CHGNet's bf16 per-edge kernels on the tensor cores, on the CPU: what of
them runs here.

``csrc/chgnet_aggregate.cu``'s ``chgnet_{atom,line}_conv_bf16_kernel`` take
the edge segment's layer 1 and layer 2 of the gated MLP as mma.sync bf16
products with fp32 accumulators, the hidden rounded once to bf16 between
them, from the float32 tables of the row projection. Here:

- the packing: bf16 weights give as ``w1e`` and ``w2`` their transposes
  W1e^T and W2^T in bf16, equal to the float32 packing's values,
  zero-padded to whole k16 steps (and C to 8 rows a half), at (C, H) of
  (4, 4), (7, 5), (20, 36) and (64, 64);
- the bar: an emulation of the kernel's arithmetic (the partial rows of
  the tables summed in fp32, each mma layer as ``truncating_k16_product``
  of ``tests/test_torch_bf16_tensor_cores.py`` takes it, silu in fp32, the
  hidden rounded once to bf16, silu and sigmoid in fp32, the gate and abw
  products, fp32 row sums in edge order, one rounding of each output) lies
  within ``chgnet_tensor_core_error_bound`` of the float32 route and within
  today's bf16 ``chgnet_aggregate_error_bound`` of the plain bf16 route, on
  ``tests/test_torch_cuda.py``'s CHGNet cases, random, cancelling (core
  outputs near zero) and with saturated gates, with and without abw, with
  NaN in the masked edges' rows; and the new bar is no looser than the
  bf16 bound on each of them;
- the dispatcher's plain route (``kernels=False``, the CPU's) zeroes the
  masked edges' rows as the plain versions do, and agrees with them bit for
  bit;
- the wrappers hand each kernel its dtype's packed operands (the C
  functions stood in by a recorder that reads the host pointers).

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from distmlip_tpu_torch.kernels import (chgnet_aggregate_error_bound,
                                        chgnet_atom_conv_aggregate_cuda,
                                        chgnet_atom_conv_aggregate_reference,
                                        chgnet_line_aggregate_cuda,
                                        chgnet_line_aggregate_reference, chgnet_message_terms,
                                        chgnet_pack_weights, chgnet_row_projection_reference,
                                        chgnet_row_tables, chgnet_tensor_core_error_bound)
from distmlip_tpu_torch.kernels.edge_aggregate import TANH_ERR
from tests.test_torch_bf16_tensor_cores import truncating_k16_product
from tests.test_torch_cuda import CHGNET_CASES, chgnet_inputs, chgnet_rows, sorted_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _up(x, m):
    return -(-x // m) * m


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()


# ---- the packing ----------------------------------------------------------------

@pytest.mark.parametrize("n_seg", [3, 4])
@pytest.mark.parametrize("c,h", [(4, 4), (7, 5), (20, 36), (64, 64)])
def test_pack_weights_gives_the_transposed_bf16_operands(c, h, n_seg):
    rng = np.random.default_rng(10 * c + h + n_seg)
    shapes = ((n_seg * c, h), (h,), (h, c), (c,)) * 2
    wb = [_bf16(rng.normal(size=s)) for s in shapes]
    got = chgnet_pack_weights(wb, n_seg, 2, c)
    f32 = chgnet_pack_weights([w.float() for w in wb], n_seg, 2, c)
    c16, h16, c8, cp, hp = _up(c, 16), _up(h, 16), _up(c, 8), _up(c, 4), _up(h, 4)
    want = torch.zeros((2 * h16, c16))
    want[:h, :c] = f32.w1e[:c, :h].t()
    want[h16:h16 + h, :c] = f32.w1e[:c, hp:hp + h].t()
    assert got.w1e.dtype == torch.bfloat16 and got.w1e.is_contiguous()
    assert torch.equal(got.w1e.float(), want)
    want = torch.zeros((2 * c8, h16))
    want[:c, :h] = f32.w2[:h, :c].t()
    want[c8:c8 + c, :h] = f32.w2[:h, cp:cp + c].t()
    assert got.w2.dtype == torch.bfloat16 and got.w2.is_contiguous()
    assert torch.equal(got.w2.float(), want)
    # the edge segment's block is the third: the first two are gathered
    assert torch.equal(got.w1e[:h, :c].float().t(), wb[0][2 * c:3 * c].float())


# ---- the bar: an emulation of the kernel's arithmetic -------------------------

def _f32(x):
    return np.asarray(x, np.float32)


def _tanh(x, bias):
    """tanh.approx.f32 at its worst: tanh off by ``bias`` (+-TANH_ERR) in
    one direction everywhere, so the errors of a row's terms add up."""
    return _f32(np.tanh(_f32(x).astype(np.float64)) + bias)


def _silu(z, bias):
    h = np.float32(0.5) * _f32(z)
    return _f32(h.astype(np.float64) * _tanh(h, bias) + h)  # one fma


def _sigmoid(z, bias):
    return _f32(0.5 * _tanh(np.float32(0.5) * _f32(z), bias).astype(np.float64) + 0.5)


def emulate_tensor_cores(which, t, tw, ti, n, tm, bias=TANH_ERR):
    """The bf16 per-edge kernel's arithmetic on bf16 inputs ``t`` (in the
    plain version's order) and bf16 weights ``tw``, from the plain row
    projection's float32 tables, its tanh.approx off by ``bias``; returns
    (n, C) bf16."""
    c, h = t[4].shape[1], tw[0].shape[1]
    c16, h16, c8, cp, hp = _up(c, 16), _up(h, 16), _up(c, 8), _up(c, 4), _up(h, 4)
    gathered = ([(t[0], t[1]), (t[2], t[3])] if which == "atom"
                else [(t[0], t[1]), (t[2], t[3]), (t[5], t[6])])
    packed = chgnet_pack_weights(tw, len(gathered) + 1, 2, c)
    tables = chgnet_row_tables([node for node, _ in gathered], packed,
                               chgnet_row_projection_reference)
    valid = torch.nonzero(tm).flatten()
    # 1. the partial rows summed in fp32: dst (+ center), read a tile ahead,
    #    then src
    acc = None
    for (table, off), (_, idx) in list(zip(tables, gathered))[1:] + [(tables[0], gathered[0])]:
        rows = _f32(table[idx.long()[valid], off:off + 2 * hp].numpy())
        acc = rows if acc is None else acc + rows
    acc1 = np.zeros((len(valid), 2 * h16))
    acc1[:, :hp], acc1[:, h16:h16 + hp] = acc[:, :hp], acc[:, hp:]
    # 2. + e W1e on the tensor cores
    x = np.zeros((len(valid), c16))
    x[:, :c] = t[4][valid].double().numpy()
    z1 = truncating_k16_product(x, packed.w1e.double().numpy().T, acc1)
    # 3. silu in fp32, one rounding to bf16
    hid = torch.from_numpy(_silu(z1, bias)).bfloat16().double().numpy()
    # 4. layer 2 from b2, core and gate
    w2t = packed.w2.double().numpy()
    b2 = packed.b2.double().numpy()
    o = []
    for half in (0, 1):
        start = np.zeros((len(valid), c8))
        start[:, :c] = b2[half * cp:half * cp + c]
        o.append(truncating_k16_product(hid[:, half * h16:(half + 1) * h16],
                                        w2t[half * c8:(half + 1) * c8].T, start)[:, :c])
    m = _silu(o[0], bias) * _sigmoid(o[1], bias)
    if which == "atom" and t[5] is not None:
        m = m * _f32(t[5][valid].float().numpy())
    # 5. fp32 row sums in edge order, one rounding of each output
    y = np.zeros((n, c), np.float32)
    for r, row in zip(ti[valid].tolist(), m):
        y[r] = y[r] + row
    return torch.from_numpy(y).bfloat16()


def _tc_case(name, which, kind):
    """``tests/test_torch_cuda.py``'s CHGNet case ``name`` at bf16 (one node
    or bond tensor at both gathered ends), NaN in the masked edges' per-edge
    rows, and ``kind``: "random"; "cancelling", hidden units in pairs of
    nearly equal values (W1's columns nudged by a few bf16 ulps) that W2c
    takes with opposite signs and no b2c, so the core outputs are small
    remainders of large terms; "saturated", b2g of +-12 so the gates sit at
    about 1 and 6e-6."""
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    rng = np.random.default_rng(700 + seed)
    if kind == "cancelling" and h > 1:
        w1c, b1c, w2c, b2c = weights[:4]
        pairs = h // 2
        nudge = 1.0 + 2.0 ** -7 * rng.integers(1, 4, size=pairs)
        w1c[:, 1:2 * pairs:2] = w1c[:, 0:2 * pairs:2] * nudge
        b1c[1:2 * pairs:2] = b1c[0:2 * pairs:2]
        w2c[1:2 * pairs:2] = -w2c[0:2 * pairs:2]
        b2c[:] = 0.0
        if h % 2:
            w2c[h - 1] = 0.0
    if kind == "saturated":
        weights[7][:] = 12.0 * np.where(np.arange(c) % 2, 1.0, -1.0)
    t = [_bf16(x) if x.dtype == np.float32 else torch.from_numpy(x) for x in arrays]
    t[2] = t[0]
    tm = torch.from_numpy(mask)
    for k in ((4, 5) if which == "atom" else (4,)):
        t[k][~tm] = float("nan")
    return t, [_bf16(w) for w in weights], torch.from_numpy(ids), tm, n


@pytest.mark.parametrize("kind", ["random", "cancelling", "saturated"])
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_CASES))
def test_tensor_core_arithmetic_within_both_bars(name, which, kind):
    """The emulated kernel (tanh.approx off by +TANH_ERR everywhere; -TANH_ERR
    for the cancelling cases) within ``chgnet_tensor_core_error_bound`` of
    the float32 route on the upcast inputs, within the bf16
    ``chgnet_aggregate_error_bound`` of the plain bf16 route, and the first
    bar no looser than the second; with and without abw."""
    t, tw, ti, tm, n = _tc_case(name, which, kind)
    ref = (chgnet_atom_conv_aggregate_reference if which == "atom"
           else chgnet_line_aggregate_reference)
    bias = -TANH_ERR if kind == "cancelling" else TANH_ERR
    for tv in [t] + ([t[:5] + [None]] if which == "atom" else []):
        got = emulate_tensor_cores(which, tv, tw, ti, n, tm, bias)
        assert bool(torch.isfinite(got.float()).all())
        x, abw = chgnet_rows(which, tv)
        f32 = ref(*[v.float() if v is not None and v.is_floating_point() else v for v in tv],
                  [w.float() for w in tw], ti, n, tm)
        bar = chgnet_tensor_core_error_bound(x, abw, tw, ti, n, tm)
        err = (got.float() - f32).abs()
        assert bool((err <= bar).all()), float((err / bar).max())
        bf16_bound = chgnet_aggregate_error_bound(x, abw, tw, ti, n, tm)
        err = (got.float() - ref(*tv, tw, ti, n, tm).float()).abs()
        assert bool((err <= bf16_bound).all()), float((err / bf16_bound).max())
        assert bool((bar <= bf16_bound).all())
        if kind == "cancelling" and which == "atom" and abw is None:
            # what exercises the bar: the core outputs are small against their terms
            msg = chgnet_message_terms(x.float(), None, [w.float() for w in tw])
            ok = tm & torch.isfinite(x).all(1)
            core = torch.nn.functional.silu(
                torch.nn.functional.silu(x.float() @ tw[0].float() + tw[1].float())
                @ tw[2].float() + tw[3].float())
            assert float((core[ok].abs() / msg[ok]).median()) < 0.5


def test_tensor_core_bar_of_an_all_masked_input_is_zero():
    t, tw, ti, tm, n = _tc_case("matgl_widths", "atom", "random")
    none = torch.zeros_like(tm)
    x, abw = chgnet_rows("atom", t)
    assert not chgnet_tensor_core_error_bound(x, abw, tw, ti, n, none).any()
    assert not emulate_tensor_cores("atom", t, tw, ti, n, none).any()


# ---- the dispatcher's plain route screens masked rows as the plain versions do ---

@pytest.mark.parametrize("ids_sorted", [True, False])
@pytest.mark.parametrize("which", ["atom", "line"])
@pytest.mark.parametrize("name", sorted(CHGNET_CASES))
def test_plain_route_screens_masked_rows(name, which, ids_sorted):
    """``fused_edge_aggregate`` with ``kernels=False`` (the model's plain
    route and the CPU's), through the autograd Function or, with unsorted
    ids, the direct path, zeroes the masked edges' rows before the message
    as ``chgnet_*_reference`` do: on bf16 inputs with NaN in the masked
    edges' rows it is finite and equal to the plain version bit for bit."""
    from distmlip_tpu_torch.kernels import (CHGNET_ATOM_CONV, CHGNET_LINE_CONV, Gather,
                                            fused_edge_aggregate)

    t, tw, ti, tm, n = _tc_case(name, which, "random")
    if which == "atom":
        message, ref = CHGNET_ATOM_CONV, chgnet_atom_conv_aggregate_reference
        inputs = [Gather(t[0], t[1]), Gather(t[2], t[3]), t[4], t[5]]
    else:
        message, ref = CHGNET_LINE_CONV, chgnet_line_aggregate_reference
        inputs = [Gather(t[0], t[1]), Gather(t[2], t[3]), t[4], Gather(t[5], t[6])]
    got = fused_edge_aggregate(message, inputs, ti, n, mask=tm, indices_are_sorted=ids_sorted,
                               kernels=False, weights=tw)
    want = ref(*t, tw, ti, n, tm)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)


# ---- the wrappers hand each kernel its dtype's operands --------------------------

@pytest.mark.parametrize("which", ["atom", "line"])
def test_bf16_wrappers_pass_the_transposed_operands(monkeypatch, which):
    """Each call launches its dtype's kernel once and nothing else, and
    passes ``w1e``, ``w2`` and ``b2`` of ``chgnet_pack_weights`` at the
    call's dtype: the transposed bf16 operands for a bf16 call (the float32
    ``b2`` beside them), the float32 blocks for a float32 call. The C
    functions stood in by a recorder that reads the host pointers."""
    from distmlip_tpu_torch.kernels import edge_aggregate

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(edge_aggregate, "chgnet_row_projection_cuda",
                        lambda x, w, b: torch.zeros((x.shape[0], w.shape[1])))
    calls, expect, seen = [], [], []

    def read(ptr, t):
        """t.numel() elements of t's dtype at host address ptr"""
        ct = ctypes.c_uint16 if t.dtype == torch.bfloat16 else ctypes.c_float
        out = torch.from_numpy(np.ctypeslib.as_array((ct * t.numel()).from_address(ptr)).copy())
        return out.view(torch.bfloat16) if t.dtype == torch.bfloat16 else out

    first_weight = 6 + (2 if which == "atom" else 4)  # after the tables, edge (abw, center)

    def fake(symbol, n_ptr=None):
        def call(*args):
            calls.append((symbol, args))
            if symbol.startswith(f"distmlip_chgnet_{which}_conv"):  # read while they live
                seen[:] = [read(p, w) for p, w in
                           zip(args[first_weight:first_weight + 3], expect)]
            return 0
        return call

    monkeypatch.setattr(edge_aggregate, "_chgnet_fn", fake)
    seed, e, n, pad, im, hi, c, h = CHGNET_CASES["hidden_64_channels_24"]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    arrays, weights = chgnet_inputs(seed, which, len(ids), c, h)
    cuda = chgnet_atom_conv_aggregate_cuda if which == "atom" else chgnet_line_aggregate_cuda
    for dtype in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(x).to(dtype) if x.dtype == np.float32 else torch.from_numpy(x)
             for x in arrays]
        t[2] = t[0]
        tw = [torch.from_numpy(w).to(dtype) for w in weights]
        packed = chgnet_pack_weights(tw, 3 if which == "atom" else 4, 2, c)
        assert packed.w1e.dtype == packed.w2.dtype == dtype
        expect[:] = (packed.w1e, packed.w2, packed.b2)
        calls.clear()
        cuda(*t, tw, torch.from_numpy(ids), n, torch.from_numpy(mask))
        ((k_sym, _),) = calls
        suffix = "_bf16" if dtype == torch.bfloat16 else "_f32"
        assert k_sym == f"distmlip_chgnet_{which}_conv{suffix}"
        assert len(seen) == 3
        for got, w in zip(seen, expect):
            assert torch.equal(got, w.flatten())
