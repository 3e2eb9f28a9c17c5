"""The port's native (C++/OpenMP) neighbor search and slab partitioner.

- Against brute force and the numpy search as sorted edge sets, on the
  cases of ``tests/test_neighbors.py`` (random cells, a cell smaller than
  the cutoff whose atoms see their own images, free axes, an atom outside
  the cell along a free axis, unwrapped inputs, the empty system);
- against the JAX package's native search bit for bit, every field in
  order, with both libraries loaded in the one process;
- native slab plans against numpy plans, every ``PartitionPlan`` field, at
  P = 2 and 4 with and without bonds, and the multi-peer refusal;
- the build: several threads building one library at once, and a failed
  build raising with the compiler's output; a call's thread count leaves
  PyTorch's (which shares the OpenMP runtime) as it was.

Searches pass ``num_threads=1`` where the structure is large enough to
start threads (the test run has several processes on the same cores).
"""

import dataclasses
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from distmlip_tpu.neighbors import native as jax_native
from distmlip_tpu_torch.calculators import Atoms, DistPotential
from distmlip_tpu_torch.models import PairConfig, PairPotential
from distmlip_tpu_torch.neighbors import (native, neighbor_list, neighbor_list_brute,
                                          neighbor_list_numpy)
from distmlip_tpu_torch.partition import PartitionError, build_plan
from tests.conftest import random_cell

NL_FIELDS = ("src", "dst", "offsets", "distances", "bond_mask", "wrapped_cart", "shift")


def _cases():
    rng = np.random.default_rng(42)
    out = {}
    for n, box, r in ((20, 6.0, 2.5), (60, 9.0, 3.5), (12, 3.0, 2.9)):
        cart, lat, _, pbc = random_cell(rng, n_atoms=n, box=box, jitter=1.0)
        out[f"random_{n}"] = (cart, lat, pbc, r, 0.6 * r)
    out["own_images"] = (np.array([[0.5, 0.5, 0.5]]), np.eye(3) * 2.0, [1, 1, 1], 2.5, 1.5)
    cart, lat, _, _ = random_cell(rng, n_atoms=25, box=6.0)
    out["free_axis"] = (cart, lat, np.array([1, 1, 0]), 3.0, 2.0)
    out["outside_free_axis"] = (np.array([[3.0, 3.0, 9.5], [3.0, 3.0, 7.5]]), np.eye(3) * 6.0,
                                [1, 1, 0], 3.0, 0.0)
    cart, lat, _, pbc = random_cell(rng, n_atoms=30, box=7.0)
    out["unwrapped"] = (cart + rng.integers(-3, 4, (30, 3)) @ lat, lat, pbc, 3.0, 2.0)
    return out


CASES = _cases()


def _assert_same_set(a, b):
    a, b = a.sorted_copy(), b.sorted_copy()
    assert a.num_edges == b.num_edges
    for name in ("src", "dst", "offsets", "bond_mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    np.testing.assert_allclose(a.distances, b.distances, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_brute_force_and_numpy(name):
    cart, lat, pbc, r, bond_r = CASES[name]
    got = neighbor_list(cart, lat, pbc, r, bond_r=bond_r)
    _assert_same_set(got, neighbor_list_brute(cart, lat, pbc, r, bond_r=bond_r))
    ref = neighbor_list_numpy(cart, lat, pbc, r, bond_r=bond_r)
    _assert_same_set(got, ref)
    np.testing.assert_array_equal(got.shift, ref.shift)
    np.testing.assert_allclose(got.wrapped_cart, ref.wrapped_cart, rtol=0, atol=1e-12)
    # edges grouped by src; the distances are those of the input positions
    assert np.all(np.diff(got.src) >= 0)
    vec = np.asarray(cart)[got.dst] + got.offsets @ lat - np.asarray(cart)[got.src]
    np.testing.assert_allclose(np.linalg.norm(vec, axis=1), got.distances, atol=1e-9)
    if name == "own_images":
        assert got.num_edges > 0 and np.all(got.src == 0) and np.all(got.dst == 0)
    if name.endswith("free_axis"):
        assert np.all(got.offsets[:, 2] == 0)
    if name == "outside_free_axis":
        assert got.num_edges == 2


def test_empty_system():
    nl = neighbor_list(np.zeros((0, 3)), np.eye(3) * 5.0, [1, 1, 1], 3.0)
    assert nl.num_edges == 0 and nl.wrapped_cart.shape == (0, 3)


@pytest.mark.parametrize("name", sorted(CASES) + ["crystal_864"])
def test_native_equals_jax_native_bit_for_bit(name):
    """The same source and flags: every array equal, in order, dtypes too.
    The JAX package's library and the port's stay loaded side by side
    (ctypes' RTLD_LOCAL keeps their equal symbol names apart)."""
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library did not build here")
    if name == "crystal_864":
        from distmlip_tpu_torch.tools.workload import bench_atoms

        atoms = bench_atoms(6)[0]
        cart, lat, pbc, r, bond_r = atoms.positions, atoms.cell, atoms.pbc, 6.5, 3.5
    else:
        cart, lat, pbc, r, bond_r = CASES[name]
    got = neighbor_list(cart, lat, pbc, r, bond_r=bond_r, num_threads=1)
    threads = torch.get_num_threads()
    try:  # the JAX package's library leaves its thread count set
        want = jax_native.neighbor_list(cart, lat, pbc, r, bond_r=bond_r, num_threads=1)
    finally:
        torch.set_num_threads(threads)
    for field in NL_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # two different libraries, both loaded in this process
    assert native.load()._name == native.library_path() != jax_native._lib._name
    assert native.load()._handle != jax_native._lib._handle


def _assert_plans_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype, f.name
                np.testing.assert_array_equal(u, v, err_msg=f.name)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("bond", [False, True], ids=["plain", "bonds"])
def test_native_plan_equals_numpy_plan(P, bond):
    rng = np.random.default_rng(P)
    box = max(16.0, P * 8.0)
    cart, lat, _, pbc = random_cell(rng, n_atoms=int(0.02 * box ** 3), box=box)
    nl = neighbor_list(cart, lat, pbc, 3.0, bond_r=2.0, num_threads=1)
    want = build_plan(nl, lat, pbc, P, 3.0, 2.0, bond, impl="numpy")
    assert min(len(g) for g in want.global_ids) > 0
    assert np.any(want.nodes_to_partition >= 0)
    if bond:
        assert min(len(s) for s in want.line_src) > 0
    for impl in ("native", "auto"):
        _assert_plans_equal(build_plan(nl, lat, pbc, P, 3.0, 2.0, bond, impl=impl), want)


def test_multi_peer_node_raises_partition_error():
    """Slabs of 4 Å at a 3 Å cutoff: border nodes reach both neighbours."""
    cart, lat, _, pbc = random_cell(np.random.default_rng(42), n_atoms=200, box=16.0)
    nl = neighbor_list(cart, lat, pbc, 3.0, num_threads=1)
    for impl in ("native", "numpy"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the slab-width warning
            with pytest.raises(PartitionError, match="exactly one peer"):
                build_plan(nl, lat, pbc, 4, 3.0, impl=impl)


def test_thread_knob_resolution(monkeypatch):
    monkeypatch.delenv("DISTMLIP_TPU_NUM_THREADS", raising=False)
    monkeypatch.delenv("DISTMLIP_NUM_THREADS", raising=False)
    assert native.resolve_num_threads() == 0
    monkeypatch.setenv("DISTMLIP_NUM_THREADS", "3")
    assert native.resolve_num_threads() == 3
    monkeypatch.setenv("DISTMLIP_TPU_NUM_THREADS", "2")
    assert native.resolve_num_threads() == 2
    assert native.resolve_num_threads(1) == 1


def test_thread_count_is_set_for_the_call_only():
    """PyTorch's intra-op pool shares the process's OpenMP runtime: a
    search or plan on one thread leaves torch's thread count as it was."""
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(3)
        cart, lat, _, pbc = random_cell(np.random.default_rng(9), n_atoms=200, box=16.0)
        nl = neighbor_list(cart, lat, pbc, 3.0, bond_r=2.0, num_threads=1)
        assert torch.get_num_threads() == 3
        native.native_partition(nl.src, nl.dst, cart[:, 2] / 16.0, np.array([0.5]), 2,
                                nl.bond_mask, True, num_threads=2)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)


def test_results_do_not_depend_on_the_thread_count():
    """864 atoms (past the size below which a call stays on one thread):
    the search and the plan on 1 and on 3 threads, array for array."""
    from distmlip_tpu_torch.tools.workload import bench_atoms

    atoms = bench_atoms(6)[0]
    args = (atoms.positions, atoms.cell, atoms.pbc, 6.5)
    one, three = (neighbor_list(*args, bond_r=3.5, num_threads=t) for t in (1, 3))
    for field in NL_FIELDS:
        np.testing.assert_array_equal(getattr(one, field), getattr(three, field), err_msg=field)
    frac = atoms.positions @ np.linalg.inv(atoms.cell)
    plans = [native.native_partition(one.src, one.dst, frac[:, 2] % 1.0, np.array([0.5]), 2,
                                     one.bond_mask, True, num_threads=t) for t in (1, 3)]
    for a, b in zip(*plans):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_first_build_by_several_threads_at_once(tmp_path, monkeypatch):
    """Eight threads ask for a library that is not built: one g++ run, one
    library, no temp file left, every thread gets it. (Built at -O0: the
    race is in the locking, not in the optimiser.)"""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O0",) + native.CXX_FLAGS[1:])
    start, seconds, errors = threading.Barrier(8), [], []

    def worker():
        try:
            start.wait(timeout=60)
            seconds.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(f for f in os.listdir(tmp_path) if not f.endswith(".lock")) == [
        os.path.basename(native.library_path())]
    assert len(seconds) == 8
    import ctypes

    lib = native._declare(ctypes.CDLL(native.library_path()))
    assert lib.dm_neighbor_num_edges(None) == -1


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_path", None)
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not os.path.exists(native.library_path())


def test_partition_report():
    """``DistPotential.partition_report``: the slab plan of the structure
    at the model's cutoff, summarised."""
    cart, lat, _, _ = random_cell(np.random.default_rng(3), n_atoms=80, box=16.0)
    atoms = Atoms(numbers=np.full(len(cart), 14), positions=cart, cell=lat)
    pot = DistPotential(PairPotential(PairConfig(cutoff=3.0)), PairPotential().init(),
                        num_partitions=2, device="cpu", skin=0.5)
    report = pot.partition_report(atoms)
    plan = build_plan(neighbor_list_numpy(cart, lat, atoms.pbc, 3.0), lat, atoms.pbc, 2, 3.0,
                      impl="numpy")
    assert report == plan.summary()
    assert "partition 1: owned=" in report
