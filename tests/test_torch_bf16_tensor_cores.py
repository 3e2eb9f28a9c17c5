"""The two bf16 kernels that run their products on the tensor cores, on the
CPU: what of them runs here.

- CHGNet's bf16 row projection (``csrc/chgnet_aggregate.cu``
  ``chgnet_row_projection_bf16_kernel``, mma.sync m16n8k16): the bf16
  model's packed layer-1 blocks stay bf16 (``chgnet_pack_weights``) and
  hold the same values as the float32 packing of the same weights; the
  bar ``chgnet_projection_error_bound`` takes for bf16 rows, (36 ceil(K /
  16) + K + 2) u T, covers a numpy emulation of the worst arithmetic the
  bar allows the tensor cores (each 16-entry instruction's 17 addends
  aligned to the largest and truncated, its sum truncated) against the
  plain version, on random and on cancelling rows; the conv wrappers take
  their tables from the module's projection, looked up at call time.
- B3's bf16 kernel (``csrc/so2_conv.cu`` ``so2_conv_bf16_kernel``): the
  count of bytes a plan brings from L2 into shared memory
  (``so2_bf16_l2_bytes``) against a walk over the plan's tiles.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from distmlip_tpu_torch import kernels as K
from distmlip_tpu_torch.kernels import (chgnet_pack_weights, chgnet_projection_error_bound,
                                        chgnet_row_projection_reference, so2_bf16_l2_bytes)
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).bfloat16()


# ---- the packing: bf16 blocks, the same values ---------------------------------

@pytest.mark.parametrize("n_seg", [3, 4])
@pytest.mark.parametrize("c,h", [(16, 12), (7, 5), (64, 64)])
def test_pack_weights_keeps_bf16_blocks(n_seg, c, h):
    """bf16 weights pack into bf16 row-projection blocks equal to the
    float32 packing of the same (upcast) weights; the biases (b1, b2) stay
    float32 and equal too; the per-edge kernels' w1e and w2 are their bf16
    transposes (the values: ``tests/test_torch_bf16_chgnet_tensor_cores.py``)."""
    rng = np.random.default_rng(n_seg * 100 + c)
    shapes = ((n_seg * c, h), (h,), (h, c), (c,)) * 2
    wb = [_bf16(rng, s) for s in shapes]
    got = chgnet_pack_weights(wb, n_seg, 2, c)
    want = chgnet_pack_weights([w.float() for w in wb], n_seg, 2, c)
    assert len(got.blocks) == len(want.blocks) == n_seg - 1
    for g, w in zip(got.blocks, want.blocks):
        assert g.dtype == torch.bfloat16 and w.dtype == torch.float32
        assert g.is_contiguous() and torch.equal(g.float(), w)
    for name in ("b1", "b2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.float32 and torch.equal(g, w), name
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    assert got.w1e.dtype == got.w2.dtype == torch.bfloat16
    assert got.w1e.shape == (2 * up(h, 16), up(c, 16)) and got.w2.shape == (2 * up(c, 8), up(h, 16))
    assert torch.equal(got.w1e[:h, :c].float().t(), want.w1e[:c, :h])
    assert torch.equal(got.w2[:c, :h].float().t(), want.w2[:h, :c])


# ---- the bar of the tensor-core products ---------------------------------------

def _fp32_truncate(v):
    """``v`` (float64) truncated toward zero to 24 significant bits."""
    mag = np.abs(v)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 23), 1.0)
    return np.trunc(v / ulp) * ulp


def truncating_k16_product(x, w, acc=None):
    """x (R, K) @ w (K, M) as the bar lets an mma instruction take it: per
    16 entries, the 16 exact products and the fp32 accumulator aligned to
    the largest of the 17 and truncated to its ulp, summed exactly, the sum
    truncated to fp32. The accumulator starts from ``acc`` (R, M) fp32
    values, zeros when None. float64 numpy in, float32-valued float64 out."""
    acc = np.zeros((x.shape[0], w.shape[1])) if acc is None else np.array(acc, np.float64)
    for k0 in range(0, x.shape[1], 16):
        prods = x[:, k0:k0 + 16, None] * w[None, k0:k0 + 16, :]  # exact: 8 x 8 bits
        addends = np.concatenate([acc[:, None, :], prods], axis=1)
        mag = np.abs(addends).max(axis=1, keepdims=True)
        ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 23),
                       1.0)
        acc = _fp32_truncate((np.trunc(addends / ulp) * ulp).sum(axis=1))
    return acc


def _rows_and_weights(kind, k, m, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (200, k))
    w = _bf16(rng, (k, m), 1.0 / np.sqrt(k))
    if kind == "cancelling" and k > 1:
        # each odd column is the even one negated and nudged by a few bf16
        # ulps, against the same weight row: the sum is a small remainder of
        # large terms
        half = k // 2
        nudge = 1.0 + 2.0 ** -7 * torch.from_numpy(rng.integers(-3, 4, size=(200, half)))
        x[:, 1:2 * half:2] = (-x[:, 0:2 * half:2].float() * nudge.float()).bfloat16()
        w[1:2 * half:2] = w[0:2 * half:2]
    return x, w


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kind", ["random", "cancelling"])
@pytest.mark.parametrize("k", [1, 6, 7, 16, 17, 63, 64])
def test_projection_bf16_bar_covers_truncating_k16_accumulation(k, kind, bias):
    """|emulated tensor cores - plain| <= (36 ceil(K / 16) + K + 2) u T,
    with the plain version's float32 product of the same bf16 values; the
    bar is the bf16 form of ``chgnet_projection_error_bound``."""
    m = 36
    x, w = _rows_and_weights(kind, k, m, seed=1000 * k + m)
    b = (torch.from_numpy(np.random.default_rng(k).normal(size=m).astype(np.float32))
         if bias else None)
    emulated = truncating_k16_product(x.double().numpy(), w.double().numpy())
    got = torch.from_numpy(emulated.astype(np.float32))
    if b is not None:
        got = got + b  # the kernel's fp32 bias add, rounded to nearest
    want = chgnet_row_projection_reference(x, w, b)
    bound = chgnet_projection_error_bound(x, w, b)
    t = x.float().abs() @ w.float().abs() + (0.0 if b is None else b.abs())
    u = 2.0 ** -24
    torch.testing.assert_close(bound, (36 * -(-k // 16) + k + 2) * u * t, rtol=1e-6, atol=0)
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err / bound.clamp_min(1e-30)).max())
    if kind == "cancelling" and k > 1 and not bias:  # what exercises the bar: |y| << T
        assert float((want.abs() / t).median()) < 0.5


def test_projection_bf16_bar_is_wider_than_the_float32_one():
    """bf16 rows take the tensor cores' bar, float32 rows keep 2 (K + 2) u T."""
    rng = np.random.default_rng(3)
    x, w = _bf16(rng, (50, 64)), _bf16(rng, (64, 128), 0.125)
    b = torch.ones(128)
    t = x.float().abs() @ w.float().abs() + 1.0
    torch.testing.assert_close(chgnet_projection_error_bound(x.float(), w.float(), b),
                               2 * 66 * 2.0 ** -24 * t, rtol=1e-6, atol=0)
    torch.testing.assert_close(chgnet_projection_error_bound(x, w, b),
                               (36 * 4 + 66) * 2.0 ** -24 * t, rtol=1e-6, atol=0)


# ---- the conv wrappers take their tables from the module's projection ----------

def test_chgnet_wrappers_project_with_the_given_function(monkeypatch):
    """The atom and line conv wrappers run ``edge_aggregate``'s
    ``chgnet_row_projection_cuda``, looked up at call time, for their row
    projections (once per distinct gathered tensor, with the packed blocks
    in the rows' dtype and the float32 b1 on the first), so a check can put
    the bf16 projection in its place and give a float32 call the bf16
    call's tables. The C functions are stood in by a recorder (the wrappers
    run as on the card, up to the launch)."""
    from distmlip_tpu_torch.kernels import edge_aggregate

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    launched = []

    def fake(symbol, n_ptr=None):
        if symbol == "distmlip_chgnet_aggregate_smem_bytes":
            return lambda *args: 1024
        return lambda *args: launched.append(symbol) or 0

    monkeypatch.setattr(edge_aggregate, "_chgnet_fn", fake)
    seen = []

    def project(x, w, bias):
        seen.append((x.dtype, w.dtype, None if bias is None else bias.dtype, tuple(w.shape)))
        return torch.zeros((x.shape[0], w.shape[1]))

    monkeypatch.setattr(edge_aggregate, "chgnet_row_projection_cuda", project)

    e, c, h = 8, 4, 4
    ids = torch.zeros(e, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        z = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
        weights = tuple(z(*s) for s in ((3 * c, h), (h,), (h, c), (c,)) * 2)
        v = z(3, c)
        K.chgnet_atom_conv_aggregate_cuda(v, ids, v, ids, z(e, c), z(e, c), weights, ids, 2)
        line_w = tuple(z(4 * c, h) if i % 4 == 0 else w for i, w in enumerate(weights))
        b = z(5, c)
        K.chgnet_line_aggregate_cuda(b, ids, b, ids, z(e, c), z(3, c), ids, line_w, ids, 2)
        assert seen == [(dtype, dtype, torch.float32, (c, 4 * h)),
                        (dtype, dtype, torch.float32, (c, 4 * h)),
                        (dtype, dtype, None, (c, 2 * h))], dtype
        seen.clear()
    assert launched == [f"distmlip_chgnet_{k}_conv{s}" for s in ("_f32", "_bf16")
                        for k in ("atom", "line")]


# ---- B3 bf16: the L2 -> shared-memory count of a plan --------------------------

def _walked_bytes(e, widths, tile_rows, tile_cols):
    """The same count by walking the plan's tiles: each tile's A rows below
    E (width entries of the segment, ``tile_cols`` of them a tile, clipped at
    the width) and its B box rows below the packed block's 128-padded height
    (k padded to 64 entries)."""
    row_tiles = -(-e // tile_rows)
    a = b = 0
    for w in widths:
        npad, kpad = -(-w // 128) * 128, -(-w // 64) * 64
        for ct in range(-(-w // tile_cols)):
            for rt in range(row_tiles):
                a += 2 * min(tile_rows, e - rt * tile_rows) * w
            b += 2 * row_tiles * kpad * min(tile_cols, npad - ct * tile_cols)
    return a, b


@pytest.mark.parametrize("e,l_max,c", [(1, 1, 8), (37, 2, 16), (300, 4, 128), (1003, 6, 7),
                                       (32768, 4, 128)])
def test_so2_bf16_l2_bytes_walks_the_tiles(e, l_max, c):
    widths = [(l_max + 1 - m) * c * (1 if m == 0 else 2) for m in range(l_max + 1)]
    for plan in ((128, 256), (192, 128)):
        got = so2_bf16_l2_bytes(e, widths, *plan)
        # A: the E rows of a tile are read once per column tile whatever the
        # tile height, so the walk's sum over row tiles is E rows
        assert got == _walked_bytes(e, widths, *plan), plan
    if (e, l_max, c) == (32768, 4, 128):  # the eSCN chunk: the first design and this one
        assert sum(so2_bf16_l2_bytes(e, widths, 192, 128)) == 2_028_830_720
        assert sum(so2_bf16_l2_bytes(e, widths)) == 1_845_493_760
