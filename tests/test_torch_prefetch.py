"""The background prefetch rebuild of ``DistPotential`` (``async_rebuild``).

Where the device refresh cannot serve a skin-cache invalidation (P > 1, a
bond graph), a worker thread builds the next graph once ``prefetch_frac``
of the skin budget is spent; the invalidation adopts it when the structure
and conditioning scalars are unchanged and the atoms are within the
snapshot's own skin budget, and abandons it otherwise.

- Adoption and abandonment by construction: one atom moved 0.15 Å (0.6 of
  the 0.25 Å budget of a 0.5 Å skin) starts the build, 0.15 Å more
  invalidates the cache and is adopted; a changed cell, species or
  ``atoms.info`` charge, or a jump past the snapshot's budget, abandons
  it, and the abandoned build's Future (with its graph) is freed when the
  build ends. Every result equals a fresh (``skin=0``) potential's within
  the repo's float32 bar (rel dE < 1e-5, max |dF|, |dS| < 1e-4).
- MD past ``prefetch_frac``: a small TensorNet at P = 2 and a small CHGNet
  with its bond graph (P = 1), H/He/Li at 1000 K, 12 ``nvt_langevin``
  steps of 2 fs with ``async_rebuild`` on and off from one seed: at least
  one hit, per-step energies and forces within the float32 bar, positions
  within 1e-4 Å.
- The memory guard vetoes a prefetch (counted), and ``close()`` ends the
  worker thread.
"""

import gc
import time
import weakref

import numpy as np
import pytest
import torch

from distmlip_tpu_torch import geometry
from distmlip_tpu_torch.calculators import Atoms, DistPotential, MolecularDynamics
from distmlip_tpu_torch.models import CHGNet, CHGNetConfig, TensorNet, TensorNetConfig

SKIN = 0.5
TN_CFG = dict(num_species=4, units=16, num_rbf=8, num_layers=2, cutoff=3.0)
CHG_CFG = dict(num_species=4, units=16, num_rbf=6, num_angle=4, num_blocks=3, cutoff=3.0,
               bond_cutoff=2.6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab_cell(seed=1):
    """fcc a = 3.5 Å, 1 x 2 x 8 cells (28 Å long: P = 2 slabs of 14 Å),
    H/He/Li rattled by 0.08 Å."""
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (1, 2, 8))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.08, (len(frac), 3))
    return Atoms(numbers=rng.integers(1, 4, len(cart)), positions=cart, cell=lat)


def _bond_cell(seed=2):
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac, lat = geometry.make_supercell(unit, np.eye(3) * 3.5, (2, 2, 2))
    cart = geometry.frac_to_cart(frac, lat) + rng.normal(0, 0.1, (len(frac), 3))
    return Atoms(numbers=rng.integers(1, 4, len(cart)), positions=cart, cell=lat)


@pytest.fixture(scope="module")
def tensornet():
    model = TensorNet(TensorNetConfig(**TN_CFG))
    return model, model.init(0)


@pytest.fixture(scope="module")
def chgnet():
    model = CHGNet(CHGNetConfig(**CHG_CFG))
    return model, model.init(0)


def _assert_close(res, ref):
    assert abs(res["energy"] - ref["energy"]) < 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["stress"], ref["stress"], rtol=0, atol=1e-4)


def _start_prefetch(pot, atoms):
    """Build at ``atoms``, then move atom 0 by 0.15 Å: a cache hit that
    starts the background build. Returns the moved atoms."""
    pot.calculate(atoms)
    moved = atoms.copy()
    moved.positions[0, 0] += 0.15
    pot.calculate(moved)
    assert pot._prefetch is not None and pot.rebuild_count == 1
    return moved


def test_adopts_the_background_build(tensornet):
    model, params = tensornet
    atoms = _slab_cell()
    pot = DistPotential(model, params, device="cpu", skin=SKIN, num_partitions=2)
    fresh = DistPotential(model, params, device="cpu", num_partitions=2)
    moved = _start_prefetch(pot, atoms)
    moved.positions[0, 0] += 0.15  # 0.30 Å from the build, 0.15 from the snapshot
    res = pot.calculate(moved)
    assert pot.prefetch_hits == 1 and pot.rebuild_count == 2 and not pot.last_build_fresh
    assert pot.last_timings["prefetch_wait_s"] >= 0.0
    np.testing.assert_array_equal(pot._cache[2][0], atoms.positions[0] + [0.15, 0, 0])
    _assert_close(res, fresh.calculate(moved))
    pot.close()


@pytest.mark.parametrize("change", ["cell", "species", "charge", "jump"])
def test_abandons_a_build_that_cannot_serve(tensornet, change):
    model, params = tensornet
    pot = DistPotential(model, params, device="cpu", skin=SKIN, num_partitions=2)
    fresh = DistPotential(model, params, device="cpu", num_partitions=2)
    moved = _start_prefetch(pot, _slab_cell())
    future = weakref.ref(pot._prefetch[0])
    if change == "cell":
        moved.cell = moved.cell * 1.001
    elif change == "species":
        moved.numbers[3] = 1 + moved.numbers[3] % 3
    elif change == "charge":
        moved.info["charge"] = 1
    else:  # 0.3 Å from the snapshot: past its own budget
        moved.positions[5, 1] += 0.3
    res = pot.calculate(moved)
    assert pot.prefetch_hits == 0 and pot.rebuild_count == 2 and pot.last_build_fresh
    _assert_close(res, fresh.calculate(moved))
    # the abandoned build's Future, and the graph it holds, go when it ends
    deadline = time.monotonic() + 60
    while future() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
        gc.collect()
    assert future() is None
    pot.close()


@pytest.mark.parametrize("family", ["tensornet_p2", "chgnet_bonds"])
def test_md_with_prefetch_matches_synchronous_rebuilds(family, tensornet, chgnet):
    model, params = tensornet if family == "tensornet_p2" else chgnet
    kw = dict(num_partitions=2) if family == "tensornet_p2" else dict(compute_magmom=True)
    runs = {}
    for async_rebuild in (True, False):
        atoms = _slab_cell() if family == "tensornet_p2" else _bond_cell()
        atoms.set_maxwell_boltzmann_velocities(1000.0, rng=np.random.default_rng(3))
        pot = DistPotential(model, params, device="cpu", skin=SKIN,
                            async_rebuild=async_rebuild, **kw)
        frames = []

        class Record:
            def record(self, results):
                frames.append((results["energy"], results["forces"].copy()))

        MolecularDynamics(atoms, pot, trajectory=Record(), ensemble="nvt_langevin",
                          timestep=2.0, temperature=1000.0, seed=0).run(12)
        runs[async_rebuild] = (frames, atoms.positions.copy(), pot.prefetch_hits,
                               pot.rebuild_count)
        pot.close()
    (frames, pos, hits, builds), (ref_frames, ref_pos, ref_hits, ref_builds) = \
        runs[True], runs[False]
    assert hits >= 1 and ref_hits == 0 and ref_builds >= 3
    assert len(frames) == len(ref_frames) == 12
    for (e, f), (e_ref, f_ref) in zip(frames, ref_frames):
        assert abs(e - e_ref) < 1e-5 * abs(e_ref)
        np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pos, ref_pos, rtol=0, atol=1e-4)


def test_no_prefetch_where_the_device_refresh_serves(tensornet):
    model, params = tensornet
    pot = DistPotential(model, params, device="cpu", skin=SKIN)  # P = 1, no bond graph
    pot.calculate(_slab_cell())
    moved = _slab_cell()
    moved.positions[0, 0] += 0.15
    pot.calculate(moved)
    assert pot._prefetch is None and pot._executor is None
    assert not DistPotential(model, params, device="cpu").async_rebuild  # skin 0


def test_memory_guard_vetoes_the_prefetch(tensornet, monkeypatch):
    model, params = tensornet
    pot = DistPotential(model, params, device="cpu", skin=SKIN, num_partitions=2)
    monkeypatch.setattr(pot, "_hbm_usage_frac", lambda: 0.6)
    monkeypatch.setattr(pot, "_estimate_prefetch_frac", lambda: 0.1)  # 0.7 > 2/3
    pot.calculate(_slab_cell())
    moved = _slab_cell()
    moved.positions[0, 0] += 0.15
    pot.calculate(moved)
    assert pot._prefetch is None and pot.prefetch_skipped_hbm == 1
    monkeypatch.setattr(pot, "_hbm_usage_frac", lambda: 0.5)  # 0.6 <= 2/3
    pot.calculate(moved)
    assert pot._prefetch is not None and pot.prefetch_skipped_hbm == 1
    pot.close()


def test_close_ends_the_worker(tensornet):
    model, params = tensornet
    pot = DistPotential(model, params, device="cpu", skin=SKIN, num_partitions=2)
    _start_prefetch(pot, _slab_cell())
    threads = list(pot._executor._threads)
    assert threads and all(t.name.startswith("distmlip-rebuild") for t in threads)
    pot.close()
    assert pot._executor is None and pot._prefetch is None
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_sticky_caps_never_shrink_under_concurrent_builds():
    """The prefetch worker and a synchronous rebuild share the potential's
    ``CapacityPolicy``: 16 threads asking for random sizes with a tiny
    switch interval never get a cap below their need, and the cap ends
    between the largest need and its bucket (a lost update could leave it
    lower)."""
    import sys
    import threading

    from distmlip_tpu_torch.partition import CapacityPolicy
    from distmlip_tpu_torch.partition.capacity import round_capacity

    caps, needs, bad = CapacityPolicy(), [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(seed):
            rng = np.random.default_rng(seed)
            for n in rng.integers(1, 10 ** 6, 300):
                needs.append(int(n))
                if caps.get("edges", int(n)) < n:
                    bad.append(int(n))

        threads = [threading.Thread(target=worker, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    final = caps.get("edges", 1)
    assert max(needs) <= final <= round_capacity(max(needs), caps.slack, caps.multiple)
