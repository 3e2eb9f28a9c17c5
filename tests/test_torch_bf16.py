"""bfloat16 compute for MACE, eSCN, TensorNet and CHGNet: the port against
the JAX package's ``compute_dtype="bfloat16"`` path, on the CPU.

Numerical contract (the JAX package's): features, messages and GEMMs in
bf16; geometry, site energies and the energy sum in float32; every scatter
and kernel accumulating in fp32 and rounding to bf16 once; forces and
stress by autograd w.r.t. float32 positions and strain.

- (a) B1's plain bf16 version (``segment_sum_reference``) against the JAX
  ``pallas_segment_sum`` in interpret mode, bf16 in: both sum the same bf16
  rows in fp32 and round once, so they agree within one bf16 rounding,
  ``|d| <= 2^-8 |ref| + 1e-6``.
- (b) B3's plain bf16 version (``so2_conv_reference``) against the JAX
  ``so2_conv_pallas`` in interpret mode, bf16 in: the same products in fp32
  summed in other orders, each rounded once: ``|d| <= 2^-7 |ref| + 1e-5``
  (one bf16 ulp plus fp32 summation noise).
- (c) ``DistPotential(compute_dtype="bfloat16")``, port against JAX, MACE at
  ``tests/test_calculators.py``'s bf16 widths and eSCN at
  ``tests/test_torch_escn.py``'s ``CFG`` (charge, spin and dataset set), at
  P = 1 and P = 2, on a ``tests.utils.make_crystal`` structure (64 atoms, a
  4 x 4 x 16 Å cell: P = 2 slabs are wider than twice the 3.2 Å cutoff).
  The two frameworks round bf16 at other places (XLA on the CPU may also
  keep excess precision), so the bar is bf16 noise: |dE| / atom <= 1e-3
  eV, max |dF| <= 0.05 max |F|, max |dS| <= 0.05 max |S|; where the JAX
  package's own bf16 P = 1 against P = 2 difference is larger, the bar is
  twice that measured floor (the test says so when it is).
- (d) The port's bf16 against its own float32 within the JAX package's
  bar (``tests/test_calculators.py``: 5e-3 eV/atom, dF_rel < 0.1; for
  TensorNet its matgl-family bar, 1e-2 eV/atom and dF_rel < 0.15).
- (e) Routing: the global switch leaves models without a compute-dtype
  switch (the pair potential) in float32 and reaches MACE, eSCN, TensorNet
  and CHGNet; TensorNet's and CHGNet's bf16 tensors take their kernels'
  bf16 launch route (CHGNet's row projections reading bf16 rows into
  float32 tables), and float16 or a call mixing float32 and bf16 raises.

Both packages get the same seeded float32 parameters as numpy arrays
(``params_from_numpy``); each model casts them inside its energy function.
One JAX evaluation per model and P, shared by the module. (c) and (d) run
in ``tests/test_torch_bf16_mace.py`` and ``tests/test_torch_bf16_escn.py``
through the helpers here, TensorNet's in
``tests/test_torch_bf16_tensornet.py`` and CHGNet's (with magmoms) in
``tests/test_torch_bf16_chgnet.py``, one file per family so that the
families' JAX compiles (~30 s each) run on separate test workers.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distmlip_tpu
import distmlip_tpu_torch
from distmlip_tpu import models as jmodels
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu.calculators import DistPotential as JDistPotential
from distmlip_tpu.kernels import pallas_segment_sum
from distmlip_tpu.kernels.so3 import so2_conv_pallas
from distmlip_tpu.ops.nn import cast_params_subtrees as jax_cast_params_subtrees
from distmlip_tpu.ops.nn import gather_rows as jax_gather_rows
from distmlip_tpu_torch import models
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.calculators.calculator import with_compute_dtype
from distmlip_tpu_torch import kernels as K
from distmlip_tpu_torch.kernels import (packed_m_layout, segment_sum_reference,
                                        so2_conv_reference)
from distmlip_tpu_torch.kernels import dispatch
from distmlip_tpu_torch.ops.nn import cast_params_subtrees, gather_rows
from distmlip_tpu_torch.tools.workload import (ESCN_BF16_KW, ESCN_KW, MACE_BF16_KW,
                                               MACE_KW)
from tests.test_torch_cuda import CASES, SO2_CASES, case_data, so2_inputs, sorted_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.utils import make_crystal

# family -> (model class name, config, atoms.info)
FAMILIES = {
    "mace": ("MACE", dict(num_species=8, channels=16, l_max=2, a_lmax=2, hidden_lmax=1,
                          correlation=3, num_interactions=2, num_bessel=6, radial_mlp=16,
                          cutoff=3.2, avg_num_neighbors=12.0), {}),
    "escn": ("ESCN", dict(num_species=4, channels=16, l_max=2, num_layers=2, num_bessel=6,
                          num_experts=4, cutoff=3.2, avg_num_neighbors=12.0),
             {"charge": 2, "spin": 3, "dataset": 1}),
    # tests/test_calculators.py:563-565's bf16 widths
    "tensornet": ("TensorNet", dict(num_species=8, units=16, num_rbf=6, num_layers=2,
                                    cutoff=3.4), {}),
    # tests/test_calculators.py:567-569's bf16 widths
    "chgnet": ("CHGNet", dict(num_species=8, units=16, num_rbf=6, num_angle=4, num_blocks=2,
                              cutoff=3.4, bond_cutoff=2.8), {}),
}
SPECIES_MAP = np.arange(0, 10, dtype=np.int32) - 1  # Z - 1


def _bf16_rows(x):
    """float32 numpy values rounded to bf16 once, as both sides' inputs."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def _as_jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


# ---- (a) B1 ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_sum_bf16_plain_matches_jax_pallas(name):
    seed, e, n, pad, im, hi, trailing = CASES[name]
    ids, mask, n = sorted_case(seed, e, n, pad, im, hi)
    data = _bf16_rows(case_data(seed, len(ids), trailing))
    ref = np.asarray(pallas_segment_sum(_as_jax(data), jnp.asarray(ids), n,
                                        jnp.asarray(mask), interpret=True))
    assert ref.dtype == jnp.bfloat16
    got = segment_sum_reference(data, torch.from_numpy(ids), n, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (n,) + trailing
    ref = ref.astype(np.float32)
    d = np.abs(got.float().numpy() - ref)
    assert (d <= 2.0 ** -8 * np.abs(ref) + 1e-6).all(), float(d.max())


# ---- (b) B3 ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["e1_lmax1_c8", "e37_lmax2_c16", "e37_lmax6_c16",
                                  "e1003_lmax1_c7", "e300_lmax4_c128"])
def test_so2_conv_bf16_plain_matches_jax_pallas(name):
    seed, e, l_max, c = SO2_CASES[name]
    h, weights, m_idx = so2_inputs(seed, e, l_max, c)
    perm, _, segments = packed_m_layout(m_idx)
    hp = _bf16_rows(h[:, perm])
    ws = [_bf16_rows(w) for w in weights]
    ref = np.asarray(so2_conv_pallas(_as_jax(hp), [_as_jax(w) for w in ws], segments, c,
                                     interpret=True))
    assert ref.dtype == jnp.bfloat16
    got = so2_conv_reference(hp, ws, segments, c)
    assert got.dtype == torch.bfloat16 and got.shape == hp.shape
    ref = ref.astype(np.float32)
    d = np.abs(got.float().numpy() - ref)
    assert (d <= 2.0 ** -7 * np.abs(ref) + 1e-5).all(), float(d.max())


def test_bf16_packing_and_the_kernel_route(monkeypatch):
    """The bf16 packing is one bf16 buffer of the K-major blocks (B^T
    forward, B for the backward), rows padded to 64 entries; the dispatcher's
    kernel route (the kernel stood in by a check of what it is handed and
    the plain version) gives the plain route's values and h cotangent, the
    cotangent through the kernel on the transposed bf16 set."""
    h, weights, m_idx = so2_inputs(21, 40, 2, 8)
    _, _, segments = packed_m_layout(m_idx)
    ws = [_bf16_rows(w) for w in weights]
    packed = K.pack_so2_weights(ws, segments, 8)
    assert packed.fwd.dtype == torch.bfloat16 and packed.fwd.shape[0] == 1
    for (off, w, npad, kpad), b in zip(packed.layout, K.so2_block_matrices(ws, segments)):
        assert npad % 128 == 0 and kpad % 64 == 0 and npad >= w and kpad >= w
        for buf, want in ((packed.fwd, b.t()), (packed.bwd, b)):
            blk = buf[0, off:off + npad * kpad].view(npad, kpad)
            assert torch.equal(blk[:w, :w], want) and not blk[w:].any() and not blk[:, w:].any()
    calls = []

    def stand_in(h_, weights_, segments_, channels, rows, packed=None):
        assert h_.dtype == packed.fwd.dtype == torch.bfloat16
        assert all(w.dtype == torch.bfloat16 for w in weights_)
        for (off, w, npad, kpad), b in zip(packed.layout,
                                           K.so2_block_matrices(weights_, segments_)):
            assert torch.equal(packed.fwd[0, off:off + npad * kpad].view(npad, kpad)[:w, :w],
                               b.detach().t())
        calls.append(1)
        r = torch.as_tensor(rows, dtype=torch.long)
        return so2_conv_reference(h_[:, r], weights_, segments_, channels)[:, torch.argsort(r)]

    monkeypatch.setattr(dispatch, "so2_conv_cuda", stand_in)
    perm_np, inv_np, _ = packed_m_layout(m_idx)
    perm, inv = torch.as_tensor(perm_np).long(), torch.as_tensor(inv_np).long()
    ht = _bf16_rows(h).requires_grad_(True)
    got = dispatch._SO2Conv.apply(True, perm_np, perm, inv, segments, 8, packed, ht, *ws)
    g = _bf16_rows(np.random.default_rng(2).normal(size=h.shape).astype(np.float32))
    (gh,) = torch.autograd.grad(got, ht, g)
    assert len(calls) == 2 and got.dtype == gh.dtype == torch.bfloat16
    want = K.fused_so2_conv(ht, ws, m_idx, 8, kernels=False)
    (gh_plain,) = torch.autograd.grad(want, ht, g)
    assert torch.equal(got, want)
    d = (gh.float() - gh_plain.float()).abs()
    assert bool((d <= 2.0 ** -7 * gh_plain.float().abs() + 1e-5).all())


def test_b2_kernels_refuse_bf16(monkeypatch):
    """bf16 tensors on a B2 kernel's route take its bf16 launch route,
    TensorNet's and CHGNet's alike (the bf16 C symbol, a bf16 output, the
    ``*_bf16`` launch count; CHGNet's row projections the bf16 symbol too,
    once per distinct gathered tensor) and are never rounded up to float32
    silently; float16, a call that mixes float32 and bf16, and a bf16
    projection given float32 blocks or a bf16 bias, still raise.
    The C functions are stood in by a recorder (the wrappers run as on the
    card, up to the launch)."""
    from distmlip_tpu_torch.kernels import edge_aggregate

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(edge_aggregate, "current_stream_ptr", lambda dev: 0)
    symbols = []

    def fake(symbol, n_ptr=None):
        if symbol == "distmlip_chgnet_aggregate_smem_bytes":
            return lambda *args: 1024
        return lambda *args: symbols.append(symbol) or 0

    monkeypatch.setattr(edge_aggregate, "_fn", fake)
    monkeypatch.setattr(edge_aggregate, "_chgnet_fn", fake)
    monkeypatch.setattr(edge_aggregate, "_interaction_bwd_fn",
                        lambda suffix: fake("distmlip_tensornet_interaction_bwd" + suffix))
    e, c = 8, 4
    ids = torch.zeros(e, dtype=torch.int32)
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)  # noqa: E731
    weights = tuple(bf(*s) for s in ((3 * c, c), (c,), (c, c), (c,)) * 2)
    line_weights = tuple(w if w.ndim == 1 or w.shape[0] != 3 * c else bf(4 * c, c)
                         for w in weights)
    before = dict(K.launch_counts)
    v = bf(3, c).requires_grad_(True)
    atom = K.fused_edge_aggregate(K.CHGNET_ATOM_CONV, [K.Gather(v, ids), K.Gather(v, ids),
                                                       bf(e, c), bf(e, c)], ids, 2,
                                  weights=weights)
    (gv,) = torch.autograd.grad(atom.float().sum(), (v,))  # the plain chunked recompute
    b = bf(5, c)  # one bond tensor at both ends, as the model passes it
    line = K.fused_edge_aggregate(K.CHGNET_LINE_CONV, [K.Gather(b, ids), K.Gather(b, ids),
                                                       bf(e, c), K.Gather(bf(3, c), ids)],
                                  ids, 2, weights=line_weights)
    assert atom.dtype == line.dtype == gv.dtype == torch.bfloat16
    assert symbols == ["distmlip_chgnet_row_projection_bf16", "distmlip_chgnet_atom_conv_bf16",
                       "distmlip_chgnet_row_projection_bf16",
                       "distmlip_chgnet_row_projection_bf16", "distmlip_chgnet_line_conv_bf16"]
    symbols.clear()
    embed = [bf(e, c) for _ in range(4)] + [bf(e, 3, 3, 1) for _ in range(2)]
    out = K.fused_edge_aggregate(K.TENSORNET_EMBED, embed, ids, 2)
    f, node_i, node_a, node_s = (bf(e, c, 3).requires_grad_(True), bf(3, c).requires_grad_(True),
                                 bf(3, 3, c), bf(3, 6, c))
    msg = K.fused_edge_aggregate(K.TENSORNET_INTERACTION, [f, K.Gather(node_i, ids), K.Gather(
        node_a, ids), K.Gather(node_s, ids)], ids, 2)
    grads = torch.autograd.grad(msg.float().sum(), (f, node_i))
    assert out.dtype == msg.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in grads)
    assert symbols == ["distmlip_tensornet_embed_bf16", "distmlip_tensornet_interaction_bf16",
                       "distmlip_tensornet_interaction_bwd_bf16"]
    got = {k: K.launch_counts[k] - before[k] for k in before}
    assert got == dict({k: 0 for k in got}, tensornet_embed_aggregate_bf16=1,
                       tensornet_interaction_aggregate_bf16=1,
                       tensornet_interaction_backward_bf16=1,
                       chgnet_atom_conv_aggregate_bf16=1, chgnet_line_aggregate_bf16=1,
                       chgnet_row_projection_bf16=3)
    symbols.clear()
    with pytest.raises(TypeError, match="one dtype"):
        K.fused_edge_aggregate(K.TENSORNET_EMBED, embed[:5] + [embed[5].float()], ids, 2)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        K.fused_edge_aggregate(K.TENSORNET_EMBED, [x.half() for x in embed], ids, 2)
    with pytest.raises(TypeError, match="one dtype"):  # float32 abw beside bf16 rows
        K.fused_edge_aggregate(K.CHGNET_ATOM_CONV, [K.Gather(v, ids), K.Gather(v, ids),
                                                    bf(e, c), bf(e, c).float()], ids, 2,
                               weights=weights)
    with pytest.raises(TypeError, match="one dtype"):  # float32 weights beside bf16 rows
        K.fused_edge_aggregate(K.CHGNET_ATOM_CONV, [K.Gather(v, ids), K.Gather(v, ids),
                                                    bf(e, c), bf(e, c)], ids, 2,
                               weights=tuple(w.float() for w in weights))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        K.fused_edge_aggregate(K.CHGNET_LINE_CONV, [K.Gather(bf(5, c).half(), ids), K.Gather(
            bf(5, c).half(), ids), bf(e, c).half(), K.Gather(bf(3, c).half(), ids)], ids, 2,
            weights=tuple(w.half() for w in line_weights))
    with pytest.raises(TypeError, match="x's dtype"):  # float32 blocks beside bf16 rows
        K.chgnet_row_projection_cuda(bf(3, c), bf(c, 8).float())
    with pytest.raises(TypeError, match="float32 b1"):
        K.chgnet_row_projection_cuda(bf(3, c), bf(c, 8), bf(8))
    assert symbols == []


# ---- the ops the models cast and gather with --------------------------------

def test_cast_params_subtrees_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32), "n": np.arange(3)},
            "keep": {"w": rng.normal(size=(2,)).astype(np.float32)},
            "layers": [{"w": rng.normal(size=(2, 2)).astype(np.float32)}]}
    want = jax_cast_params_subtrees(jax.tree.map(jnp.asarray, tree), jnp.bfloat16,
                                    keep_fp32=("keep",))
    got = cast_params_subtrees(jax.tree.map(torch.from_numpy, tree), torch.bfloat16,
                               keep_fp32=("keep",))
    assert got["a"]["w"].dtype == torch.bfloat16 and got["keep"]["w"].dtype == torch.float32
    assert got["a"]["n"].dtype == torch.int64 and got["layers"][0]["w"].dtype == torch.bfloat16
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), got)),
                    jax.tree.leaves(jax.tree.map(lambda t: np.asarray(t, np.float32), want))):
        np.testing.assert_array_equal(g, w)


def test_gather_rows_accumulates_its_gradient_in_fp32():
    """500 cotangent rows onto 3 table rows: the bf16 table's gradient is the
    fp32 sum rounded once (the JAX package's gather through an fp32 view),
    where a bf16 scatter-add would drift; a float32 table is untouched."""
    rng = np.random.default_rng(1)
    table = _bf16_rows(rng.normal(size=(3, 4)).astype(np.float32)).requires_grad_(True)
    idx = rng.integers(0, 3, 500)
    g = _bf16_rows(rng.normal(size=(500, 4)).astype(np.float32))
    rows = gather_rows(table, torch.from_numpy(idx))
    assert rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(rows.detach().float().numpy(),
                                  table.detach().float().numpy()[idx])
    (got,) = torch.autograd.grad(rows, table, g)
    exact = np.zeros((3, 4), np.float64)
    np.add.at(exact, idx, g.double().numpy())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(exact).float().bfloat16().float().numpy())
    _, vjp = jax.vjp(lambda t: jax_gather_rows(t, jnp.asarray(idx)), _as_jax(table.detach()))
    (want,) = vjp(_as_jax(g))
    d = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (d <= 2.0 ** -7 * np.abs(exact) + 1e-6).all()
    t32 = torch.zeros(3, 4)
    assert torch.equal(gather_rows(t32, torch.from_numpy(idx)), t32[idx])


# ---- (c), (d): the models ---------------------------------------------------

def _jax_params(family):
    name, cfg, _ = FAMILIES[family]
    model = getattr(jmodels, name)(getattr(jmodels, name + "Config")(**cfg))
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(0)))
    # reference energies off their defaults and negative, as trained ones are
    rng = np.random.default_rng(7)
    ref = params["species_ref"]["w"]
    params["species_ref"]["w"] = (-1.0 - rng.random(ref.shape)).astype(ref.dtype)
    if family in ("tensornet", "chgnet"):
        # the random readout gives forces of a few meV/Å; a data_std off its
        # default of 1 lifts them past the comparison's 1e-2 floor
        params["data_std"] = np.array(10.0, np.float32)
    return params


def _models(family):
    name, cfg, _ = FAMILIES[family]
    return (getattr(jmodels, name)(getattr(jmodels, name + "Config")(**cfg)),
            getattr(models, name)(getattr(models, name + "Config")(**cfg)))


@pytest.fixture(scope="module")
def results():
    """Per (family, side, dtype, P): energy, forces, stress (and CHGNet's
    magmoms, from the same forward), made once."""
    out = {}

    def get(family, side, dtype, P):
        key = (family, side, dtype, P)
        if key not in out:
            if family not in out:
                out[family] = (_jax_params(family), _crystal(family))
            params, (cart, lat, numbers) = out[family]
            info = dict(FAMILIES[family][2])
            jmodel, model = _models(family)
            kw = {"compute_magmom": True} if family == "chgnet" else {}
            if side == "jax":
                pot = JDistPotential(jmodel, params, num_partitions=P, species_map=SPECIES_MAP,
                                     kernels=False, compute_dtype=dtype, **kw)
                res = pot.calculate(JAtoms(numbers=numbers, positions=cart, cell=lat,
                                           info=info))
            else:
                pot = DistPotential(model, params, num_partitions=P, species_map=SPECIES_MAP,
                                    device="cpu", compute_dtype=dtype, **kw)
                assert pot.model.cfg.dtype == dtype
                res = pot.calculate(Atoms(numbers=numbers, positions=cart.copy(), cell=lat,
                                          info=info))
                assert pot.last_stats["num_partitions"] == P
            out[key] = {k: np.asarray(res[k]) if k == "magmoms" else res[k]
                        for k in ("energy", "forces", "stress", "magmoms") if k in res}
        return out[key]

    return get


def _crystal(family):
    """64 atoms of make_crystal, 1 x 1 x 4 cells of a = 4.0 Å doubled along
    x and y: a 8 x 8 x 16 Å cell whose 16 Å axis takes the P = 2 slabs."""
    n_species = FAMILIES[family][1]["num_species"]
    cart, lat, spec = make_crystal(np.random.default_rng(3), reps=(2, 2, 4), a=4.0,
                                   noise=0.05, n_species=n_species)
    return cart, lat, spec + 1


def _deltas(a, b, n):
    return (abs(a["energy"] - b["energy"]) / n,
            float(np.abs(a["forces"] - b["forces"]).max() / np.abs(b["forces"]).max()),
            float(np.abs(a["stress"] - b["stress"]).max() / np.abs(b["stress"]).max()))


def check_matches_jax(results, family, P):
    """(c) for one family at one P."""
    n = len(_crystal(family)[0])
    port = results(family, "port", "bfloat16", P)
    ref = results(family, "jax", "bfloat16", P)
    for r in (port, ref):
        assert np.isfinite(r["energy"]) and np.isfinite(r["forces"]).all()
        assert r["forces"].dtype == np.float32 and r["stress"].shape == (3, 3)
    assert np.abs(ref["forces"]).max() > 1e-2 and np.abs(ref["stress"]).max() > 1e-4
    # the JAX package's own bf16 noise: its P = 1 against its P = 2
    floor = _deltas(results(family, "jax", "bfloat16", 1),
                    results(family, "jax", "bfloat16", 2), n)
    bars = [max(b, 2 * f) for b, f in zip((1e-3, 0.05, 0.05), floor)]
    for what, b, f in zip(("dE/atom", "dF_rel", "dS_rel"), (1e-3, 0.05, 0.05), floor):
        if 2 * f > b:
            print(f"{family} P={P}: the JAX package's own bf16 P=1 vs P=2 {what} is {f:.3g}; "
                  f"bar {2 * f:.3g} (twice it) in place of {b}")
    got = _deltas(port, ref, n)
    assert all(g <= b for g, b in zip(got, bars)), (got, bars, floor)
    if "magmoms" in ref:  # CHGNet: max |dm| <= 0.05 max |m|, or twice JAX's own gap
        def dm(a, b):
            return float(np.abs(a["magmoms"] - b["magmoms"]).max() / np.abs(b["magmoms"]).max())

        assert np.isfinite(port["magmoms"]).all() and np.abs(ref["magmoms"]).max() > 1e-3
        m_floor = dm(results(family, "jax", "bfloat16", 1), results(family, "jax", "bfloat16", 2))
        assert dm(port, ref) <= max(0.05, 2 * m_floor), (dm(port, ref), m_floor)


def check_against_float32(results, family, de_bar=5e-3, df_bar=0.1):
    """(d) for one family, at the JAX package's bar for it."""
    n = len(_crystal(family)[0])
    bf16 = results(family, "port", "bfloat16", 1)
    f32 = results(family, "port", "float32", 1)
    de, df, _ = _deltas(bf16, f32, n)
    assert de < de_bar and df < df_bar, (de, df)
    assert de > 0.0  # the switch changed the arithmetic



# ---- the bf16 path through the batched engine and MD --------------------------

def _small_structures(family, seed=5):
    """Two crystals of 32 and 16 atoms (the second sheared), conditioning
    set for eSCN; make_crystal's species as the models' indices + 1."""
    from distmlip_tpu_torch import geometry

    n_species = FAMILIES[family][1]["num_species"]
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    out = []
    for reps, shear in (((2, 2, 2), 0.0), ((2, 2, 1), 0.15)):
        frac, lat = geometry.make_supercell(unit, np.eye(3) * 4.0, reps)
        m = np.eye(3)
        m[1, 0] = shear
        cart = (geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.05, (len(frac), 3))) @ m
        out.append(Atoms(numbers=rng.integers(1, n_species + 1, len(cart)), positions=cart,
                         cell=lat @ m, info=dict(FAMILIES[family][2])))
    return out


@pytest.mark.parametrize("family", ["mace", "escn", "tensornet", "chgnet"])
def test_bf16_batched_matches_dist_potential(family):
    """``BatchedPotential`` over a bf16 model (it runs the model's own
    dtype, as the JAX engine inherits it) against ``DistPotential`` at bf16
    on each structure alone: the same bf16 program in another chunk
    layout, within the bf16 bar; the bytes model is keyed by the dtype."""
    from distmlip_tpu_torch.calculators import BatchedPotential

    name, cfg, _ = FAMILIES[family]
    model = getattr(models, name)(getattr(models, name + "Config")(**cfg, dtype="bfloat16"))
    params = model.init(0)
    structs = _small_structures(family)
    pot = BatchedPotential(model, params, device="cpu", species_map=SPECIES_MAP)
    assert pot.compute_dtype == "bfloat16"
    got = pot.calculate(structs)
    for g, a in zip(got, structs):
        want = DistPotential(model, params, device="cpu",
                             species_map=SPECIES_MAP).calculate(a)
        assert g["forces"].dtype == np.float32
        assert abs(g["energy"] - want["energy"]) <= 1e-3 * len(a)
        assert np.abs(g["forces"] - want["forces"]).max() <= 0.05 * np.abs(want["forces"]).max()
    pot.caps.calibrate_bytes(128, 10 ** 6, pot.compute_dtype)
    assert pot.estimate_batch_bytes(32) is not None
    assert pot.caps.estimate_batch_bytes(32) is None  # no float32 calibration


def test_bf16_molecular_dynamics_follows_float32():
    """5 ``nvt_langevin`` steps of a bf16 MACE from the float32 run's start
    and seed: finite, and its energies within the bf16 bar of the float32
    trajectory's."""
    from distmlip_tpu_torch.calculators import MolecularDynamics

    model = models.MACE(models.MACEConfig(**FAMILIES["mace"][1]))
    params = model.init(0)
    energies = {}
    for dtype in ("float32", "bfloat16"):
        atoms = _small_structures("mace")[0]
        atoms.set_maxwell_boltzmann_velocities(300.0, rng=np.random.default_rng(4))
        pot = DistPotential(model, params, device="cpu", species_map=SPECIES_MAP,
                            skin=0.5, compute_dtype=dtype)
        out = []

        class Record:
            def record(self, results):
                out.append(results["energy"])

        MolecularDynamics(atoms, pot, trajectory=Record(), ensemble="nvt_langevin",
                          timestep=1.0, temperature=300.0, seed=0).run(5)
        assert np.isfinite(atoms.positions).all() and len(out) >= 5
        energies[dtype] = np.array(out)
    assert (np.abs(energies["bfloat16"] - energies["float32"]) <= 5e-3 * 32).all()


# ---- (e) routing --------------------------------------------------------------

def test_compute_dtype_routing():
    pair = models.PairPotential(models.PairConfig(cutoff=3.0))
    mace = models.MACE(models.MACEConfig(**FAMILIES["mace"][1]))
    tn = models.TensorNet(models.TensorNetConfig(num_species=4, units=8, num_rbf=4))
    chg = models.CHGNet(models.CHGNetConfig(num_species=4, units=8, num_rbf=4,
                                            num_blocks=2))
    with pytest.raises(ValueError, match="compute"):
        DistPotential(pair, pair.init(), device="cpu", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        with_compute_dtype(chg, "float16")
    for model in (mace, tn, chg):
        assert with_compute_dtype(model, "bfloat16").cfg.dtype == "bfloat16"
        assert with_compute_dtype(model, "float32") is model
    # the global switch, as the JAX package's DistPotential reads it
    jpair = jmodels.PairPotential(jmodels.PairConfig(cutoff=3.0))
    distmlip_tpu_torch.set_compute_dtype("bfloat16")
    distmlip_tpu.set_compute_dtype("bfloat16")
    try:
        pot = DistPotential(pair, pair.init(), device="cpu")
        assert pot.model is pair and pot.compute_dtype == "float32"
        assert JDistPotential(jpair, jpair.init(), num_partitions=1).model is jpair
        for model in (mace, tn, chg):
            pot = DistPotential(model, model.init(0), device="cpu")
            assert pot.model.cfg.dtype == pot.compute_dtype == "bfloat16"
    finally:
        distmlip_tpu_torch.set_compute_dtype("float32")
        distmlip_tpu.set_compute_dtype("float32")
    assert DistPotential(mace, mace.init(0), device="cpu").model is mace


def test_workload_bf16_configurations():
    """bench.py's MACE and example 05's eSCN at their own precision."""
    assert MACE_BF16_KW == dict(MACE_KW, dtype="bfloat16")
    assert ESCN_BF16_KW == dict(ESCN_KW, dtype="bfloat16")
    assert models.MACE(models.MACEConfig(**MACE_BF16_KW)).cfg.dtype == "bfloat16"
    assert models.ESCN(models.ESCNConfig(**ESCN_BF16_KW)).cfg.dtype == "bfloat16"
