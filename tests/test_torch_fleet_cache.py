"""The port's result cache (``distmlip_tpu_torch.fleet.result_cache``)
against the JAX package's.

- ``structure_key`` / ``cache_key`` give the JAX package's strings bit for
  bit on the same structure: reordered atoms, positions wrapped by lattice
  vectors, the tolerance-bucket boundaries, open boundaries, and the
  ``atoms.info`` conditioning scalars (charge, spin, dataset).
- ``ResultCache``: LRU at the byte bound, oversized entries skipped,
  copy-on-return, the hit/miss counters and the property-set miss, as
  ``tests/test_fleet_cache.py`` holds the JAX cache; it refuses a torch
  tensor value (results live on the host).

Host-only: no device work, no JAX evaluation.
"""

import numpy as np
import pytest
import torch

from distmlip_tpu import fleet as jfleet
from distmlip_tpu.calculators import Atoms as JAtoms
from distmlip_tpu_torch.calculators import Atoms
from distmlip_tpu_torch.fleet import ResultCache, cache_key, structure_key
from distmlip_tpu_torch.fleet.result_cache import _result_bytes, canonical_properties

TOL = 1e-4


def make_atoms(rng, n=16, box=7.0, numbers=None, pbc=True):
    lattice = np.eye(3) * box
    frac = (rng.integers(1, 1000, (n, 3)) + 0.0) / 1000.0
    cart = np.round(frac @ lattice / TOL) * TOL   # exact bucket centers
    numbers = numbers if numbers is not None else rng.integers(1, 30, n).astype(np.int32)
    return Atoms(numbers=numbers, positions=cart, cell=lattice,
                 pbc=np.array([pbc] * 3) if isinstance(pbc, bool) else pbc)


def as_jax(a):
    return JAtoms(numbers=a.numbers, positions=a.positions, cell=a.cell, pbc=a.pbc,
                  info=dict(a.info))


def both_keys(a, **kw):
    return structure_key(a, **kw), jfleet.structure_key(as_jax(a), **kw)


def variants(rng):
    """(name, Atoms) pairs spanning what the key must see and ignore."""
    a = make_atoms(rng)
    perm = rng.permutation(len(a))
    reordered = Atoms(numbers=a.numbers[perm], positions=a.positions[perm], cell=a.cell,
                      pbc=a.pbc)
    wrapped = a.copy()
    shifts = rng.integers(-2, 3, (len(a), 3)).astype(np.float64)
    shifts[: len(a) // 2] = 0.0
    wrapped.positions = wrapped.positions + shifts @ wrapped.cell
    inside = a.copy()
    inside.positions = inside.positions + 0.2 * TOL
    across = a.copy()
    across.positions = across.positions.copy()
    across.positions[0, 0] += 2.0 * TOL
    half = a.copy()  # a coordinate on an exact bucket boundary
    half.positions = half.positions.copy()
    half.positions[1, 2] += 0.5 * TOL
    species = a.copy()
    species.numbers = species.numbers.copy()
    species.numbers[0] += 1
    cell = a.copy()
    cell.cell = cell.cell * 1.01
    charged = a.copy()
    charged.info["charge"] = 1
    spin = a.copy()
    spin.info.update(charge=1, spin=2, dataset=3, tag="omat", flag=True, w=0.5)
    skipped = a.copy()
    skipped.info["array"] = np.ones(3)   # non-scalars do not fold in
    molecule = make_atoms(rng, pbc=False)
    slab = make_atoms(rng, pbc=np.array([True, True, False]))
    return [("base", a), ("reordered", reordered), ("wrapped", wrapped),
            ("inside", inside), ("across", across), ("half", half), ("species", species),
            ("cell", cell), ("charged", charged), ("spin", spin), ("skipped", skipped),
            ("molecule", molecule), ("slab", slab)]


@pytest.mark.parametrize("tol", [TOL, 1e-5, 0.05])
def test_structure_key_equals_jax_bit_for_bit(rng, tol):
    for name, a in variants(rng):
        port, jax_key = both_keys(a, tol=tol)
        assert port == jax_key, name


def test_structure_key_invariances_and_sensitivities(rng):
    keys = {name: structure_key(a, tol=TOL) for name, a in variants(rng)}
    for same in ("reordered", "wrapped", "inside", "skipped"):
        assert keys[same] == keys["base"], same
    for other in ("across", "species", "cell", "charged", "spin"):
        assert keys[other] != keys["base"], other
    assert keys["charged"] != keys["spin"]


@pytest.mark.parametrize("properties", [None, ("energy",), ("forces",),
                                        ("forces", "energy", "forces"), ("stress", "forces")])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cache_key_equals_jax(rng, properties, precision):
    a = make_atoms(rng)
    a.info["spin"] = 1
    assert cache_key(a, "mace#ab12", properties, precision, tol=TOL) == jfleet.cache_key(
        as_jax(a), "mace#ab12", properties, precision, tol=TOL)
    assert canonical_properties(properties) == jfleet.result_cache.canonical_properties(
        properties)


def test_cache_key_property_sets_never_alias(rng):
    a = make_atoms(rng)
    k_energy = cache_key(a, "m", properties=("energy",))
    k_forces = cache_key(a, "m", properties=("energy", "forces"))
    k_full = cache_key(a, "m", properties=None)
    assert len({k_energy, k_forces, k_full}) == 3
    assert cache_key(a, "m", properties=("forces", "energy")) == k_forces
    assert cache_key(a, "m", properties=("forces",)) == k_forces
    assert cache_key(a, "m2") != k_full
    assert cache_key(a, "m", precision="bfloat16") != k_full


def test_energy_only_entry_does_not_serve_forces_request(rng):
    cache = ResultCache()
    a = make_atoms(rng)
    cache.put(cache_key(a, "m", properties=("energy",)), {"energy": -1.0})
    assert cache.get(cache_key(a, "m", properties=("energy", "forces"))) is None
    assert cache.get(cache_key(a, "m", properties=("energy",))) == {"energy": -1.0}


def _result(nbytes_arr: int) -> dict:
    return {"energy": -1.0, "forces": np.zeros(nbytes_arr // 8, dtype=np.float64)}


def test_result_bytes_equal_jax():
    for n in (0, 64, 1024, 4096):
        r = _result(n)
        assert _result_bytes(r) == jfleet.result_cache._result_bytes(r)


def test_lru_eviction_at_byte_bound():
    per = _result_bytes(_result(1024))
    cache = ResultCache(max_bytes=3 * per)
    for k in ("a", "b", "c"):
        assert cache.put(k, _result(1024))
    assert cache.get("a") is not None       # touch: "a" becomes MRU
    assert cache.put("d", _result(1024))    # evicts LRU = "b"
    assert cache.get("b") is None
    assert cache.get("a") is not None
    assert cache.get("c") is not None and cache.get("d") is not None
    assert cache.total_bytes <= cache.max_bytes
    assert cache.evictions == 1


def test_lru_sequence_equals_jax_cache():
    """The same op sequence leaves both caches with the same entries and
    counters."""
    per = _result_bytes(_result(512))
    ops = [("put", "a"), ("put", "b"), ("get", "a"), ("put", "c"), ("put", "d"),
           ("get", "b"), ("put", "a"), ("get", "c"), ("put", "e"), ("get", "a"),
           ("get", "d"), ("put", "big")]
    caches = [ResultCache(max_bytes=3 * per), jfleet.ResultCache(max_bytes=3 * per)]
    seen = [[], []]
    for op, k in ops:
        for c, log in zip(caches, seen):
            if op == "put":
                log.append(c.put(k, _result(8192 if k == "big" else 512)))
            else:
                log.append(c.get(k) is not None)
    assert seen[0] == seen[1]
    assert caches[0].stats() == caches[1].stats()
    assert list(caches[0]._entries) == list(caches[1]._entries)


def test_oversized_entry_is_not_cached():
    cache = ResultCache(max_bytes=256)
    assert not cache.put("big", _result(4096))
    assert cache.get("big") is None
    assert cache.skipped_oversize == 1
    assert cache.total_bytes == 0


def test_copy_on_return_mutation_safety():
    cache = ResultCache()
    original = _result(256)
    cache.put("k", original)
    original["forces"][:] = 7.0
    got1 = cache.get("k")
    assert np.all(got1["forces"] == 0.0)
    got1["forces"][:] = 9.0
    got2 = cache.get("k")
    assert np.all(got2["forces"] == 0.0)
    assert got1["forces"] is not got2["forces"]


def test_hit_miss_counters(rng):
    cache = ResultCache()
    key = cache_key(make_atoms(rng), "m")
    assert cache.get(key) is None
    cache.put(key, {"energy": -2.0})
    assert cache.get(key)["energy"] == -2.0
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    assert st["hit_rate"] == 0.5


def test_result_cache_refuses_tensors():
    cache = ResultCache()
    with pytest.raises(TypeError, match="host results"):
        cache.put("k", {"energy": -1.0, "forces": torch.zeros(3, 3)})
    assert len(cache) == 0
