"""Hygiene of the PyTorch port: what it imports, where it runs, what it refuses.

- No file under ``distmlip_tpu_torch/`` (nor ``chip_smoke.py``) imports
  ``jax`` or ``distmlip_tpu`` (AST scan), and importing the package in a
  fresh interpreter leaves ``jax`` out of ``sys.modules``.
- Entry points run on CUDA by default and raise without a card; they never
  fall back to the CPU. The CUDA wrapper refuses CPU tensors.
- What this slice does not port raises ``NotImplementedError``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import distmlip_tpu_torch
from distmlip_tpu_torch import set_compute_dtype, set_default_dtype
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.device import resolve_device
from distmlip_tpu_torch.kernels import build
from distmlip_tpu_torch.models import MACE, MACEConfig
from distmlip_tpu_torch.ops.chunk import remat_wrap
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(distmlip_tpu_torch.__file__)
TINY = dict(num_species=3, channels=4, l_max=1, a_lmax=1, hidden_lmax=0,
            correlation=2, num_interactions=1, num_bessel=3, radial_mlp=4,
            cutoff=3.0)


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    seen = 0
    for path in _port_sources():
        seen += 1
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "distmlip_tpu"), (path, mod)
    assert seen > 20


def test_import_in_fresh_interpreter_leaves_jax_out():
    code = ("import sys, distmlip_tpu_torch, distmlip_tpu_torch.calculators, "
            "distmlip_tpu_torch.models, distmlip_tpu_torch.kernels, "
            "distmlip_tpu_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'distmlip_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MACE(MACEConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        DistPotential(model, model.init(0))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_build_needs_nvcc_and_never_runs_at_import(monkeypatch):
    """Importing the kernels builds nothing; the build names every source
    and fails clearly when nvcc is missing."""
    assert build.kernel_names() == ["chgnet_aggregate", "edge_aggregate", "segment_sum",
                                    "so2_conv"]
    for name in build.kernel_names():
        assert build.library_path(name).startswith(build.BUILD_DIR)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_unported_options_raise():
    # zbl=True is ported (tests/test_torch_mace_zbl.py): it builds, with its
    # two ZBL parameters
    assert set(MACE(MACEConfig(**TINY, zbl=True)).init(0)["zbl"]) == {"a_exp", "a_prefactor"}
    # bfloat16 is ported (tests/test_torch_bf16*.py): MACE builds at it
    assert MACE(MACEConfig(**TINY, dtype="bfloat16")).cfg.dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MACE(MACEConfig(**TINY, dtype="float16"))
    model = MACE(MACEConfig(**TINY))
    # P>1 runs (tests/test_torch_parallel*.py); what it does not take raises
    with pytest.raises(ValueError, match="device_rebuild=True"):
        DistPotential(model, model.init(0), num_partitions=2, device="cpu",
                      device_rebuild=True)
    with pytest.raises(ValueError, match="num_partitions"):
        DistPotential(model, model.init(0), num_partitions=0, device="cpu")
    # compute_dtype="bfloat16" rebuilds the model at it and runs
    bf16 = DistPotential(model, model.init(0), compute_dtype="bfloat16", device="cpu")
    assert bf16.model.cfg.dtype == "bfloat16" and model.cfg.dtype == "float32"
    with pytest.raises(NotImplementedError, match="checkpoint"):
        remat_wrap(lambda x: x, "dots")
    with pytest.raises(ValueError):
        set_compute_dtype("float16")
    with pytest.raises(ValueError):
        set_default_dtype("float", 16)
    # the process-global compute dtype is read when a potential is built:
    # MACE runs at bfloat16 under it
    set_compute_dtype("bfloat16")
    try:
        pot = DistPotential(model, model.init(0), device="cpu")
        assert pot.model.cfg.dtype == "bfloat16" and pot.compute_dtype == "bfloat16"
    finally:
        set_compute_dtype("float32")
    assert DistPotential(model, model.init(0), device="cpu").kernels is True


def test_edgeless_structure_and_species_map():
    """One atom in a big box has no edges (e_cap = 0, one empty chunk):
    finite energy, zero force and stress; the species map picks row 1."""
    model = MACE(MACEConfig(**TINY))
    params = model.init(3)
    params["species_ref"]["w"][0] = torch.tensor([0.25, -1.5, 0.75])
    smap = np.array([0] * 14 + [1] + [0] * 80)
    atoms = Atoms(numbers=[14], positions=[[1.0, 2.0, 3.0]], cell=np.eye(3) * 20.0)
    res = DistPotential(model, params, device="cpu", species_map=smap).calculate(atoms)
    assert np.isfinite(res["energy"])
    np.testing.assert_array_equal(res["forces"], np.zeros((1, 3), np.float32))
    np.testing.assert_array_equal(res["stress"], np.zeros((3, 3), np.float32))
    params["species_ref"]["w"][0, 1] += 1.0
    res2 = DistPotential(model, params, device="cpu", species_map=smap).calculate(atoms)
    assert res2["energy"] - res["energy"] == pytest.approx(1.0, abs=1e-5)


def test_compute_stress_false_keeps_forces():
    from distmlip_tpu_torch import geometry

    model = MACE(MACEConfig(**TINY))
    params = model.init(2)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.2, (2, 2, 2))
    cart = frac @ lat + np.random.default_rng(4).normal(0, 0.05, (32, 3))
    atoms = Atoms(numbers=np.arange(32) % 3, positions=cart, cell=lat)
    full = DistPotential(model, params, device="cpu").calculate(atoms)
    bare = DistPotential(model, params, device="cpu", compute_stress=False).calculate(atoms)
    assert bare["energy"] == full["energy"]
    np.testing.assert_allclose(bare["forces"], full["forces"], atol=1e-6)
    assert np.abs(full["stress"]).max() > 0 and not bare["stress"].any()


@pytest.mark.parametrize("remat", [True, False])
def test_segment_sum_calls_per_calculate(monkeypatch, remat):
    """The count chip_smoke.py checks against the kernel's launch counter:
    per calculate, each interaction runs its K edge chunks forward, and with
    remat the backward re-runs each checkpointed chunk body once (the
    segment sum saves its ids/mask, so the recompute reaches it): 2K."""
    from distmlip_tpu_torch import geometry
    from distmlip_tpu_torch.kernels import dispatch
    from distmlip_tpu_torch.ops.chunk import chunk_layout

    calls = []
    plain = dispatch.segment_sum_reference
    monkeypatch.setattr(dispatch, "segment_sum_reference",
                        lambda *a: calls.append(1) or plain(*a))
    cfg = MACEConfig(**dict(TINY, num_interactions=2, edge_chunk=50, remat=remat))
    model = MACE(cfg)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    atoms = Atoms(numbers=np.zeros(32, int), positions=frac @ lat, cell=lat)
    pot = DistPotential(model, model.init(1), device="cpu", skin=0.3)
    pot.calculate(atoms)
    K = chunk_layout(pot.last_stats["e_cap"], cfg.edge_chunk)[2]
    assert K > 1
    assert len(calls) == cfg.num_interactions * K * (2 if remat else 1)
