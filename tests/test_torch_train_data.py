"""The port's training data path (``distmlip_tpu_torch/train/data.py``,
``train/packing.py``, ``utils/flops.py``, ``utils/memory.py``) against the
JAX package's, on the CPU. Everything here is host numpy on both sides, so
every comparison is exact (``assert_array_equal``, ``==``):

- ``epoch_permutation``, ``structure_needs``, ``pack_targets`` and the
  loader's packed graphs, frozen capacities, cursor replay and prefetch;
- the cost-model pipeline: ``CostCensus``, ``assign_tiers``,
  ``tier_caps``, ``plan_epoch`` / ``plan_epoch_naive`` and
  ``predicted_plan_waste`` on a 200-structure lognormal dataset and on a
  two-tier set of real structures, and the tiered loader's plans, caps,
  tier cursor and its validation;
- ``model_cost_fn`` (the analytic FLOP model) for the four families.

Both packages' loaders use their native neighbor searches, which give the
same edges in the same order (``tests/test_torch_native.py``), so the
packed graphs are compared array for array.
"""

import numpy as np
import pytest
import torch

from distmlip_tpu import train as jtrain
from distmlip_tpu.partition import fixed_caps_for_batches as j_fixed_caps
from distmlip_tpu.utils import flops as jflops
from distmlip_tpu_torch import train
from distmlip_tpu_torch.calculators import Atoms
from distmlip_tpu_torch.partition import fixed_caps_for_batches
from distmlip_tpu_torch.utils import flops, memory
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.torch_train_common import (CUTOFF, FAMILIES, both_samples, jax_model,
                                      make_samples, port_model, species_fn)

pytestmark = pytest.mark.train

GRAPH_FIELDS = ("positions", "species", "node_mask", "owned_mask", "edge_src", "edge_dst",
                "edge_offset", "edge_mask", "struct_id", "line_src", "line_dst", "line_mask",
                "line_center", "bond_map_edge", "bond_map_bond", "bond_map_mask")


@pytest.fixture(scope="module")
def samples():
    return both_samples(n=8)


@pytest.fixture(scope="module")
def longtail():
    """8 structures of 4 atoms and 4 of 32 (``tests/test_packing.py``'s
    two-tier set), in both packages."""
    from distmlip_tpu.calculators import Atoms as JAtoms

    out = []
    for S, A in ((train.Sample, Atoms), (jtrain.Sample, JAtoms)):
        rng = np.random.default_rng(7)
        out.append(make_samples(S, A, rng, 8, (1, 1, 1)) + make_samples(S, A, rng, 4, (2, 2, 2)))
    return out


def _same_batch(b, jb):
    """A port TrainBatch against the JAX one: every micro-batch's graph
    and target arrays equal."""
    assert len(b.graphs) == len(b.targets) == np.asarray(jb.targets["energy"]).shape[0]
    for a, (g, t) in enumerate(zip(b.graphs, b.targets)):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(jb.graphs, f))[a], err_msg=f)
        assert g.batch_size == jb.graphs.batch_size
        assert t.keys() == jb.targets.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], np.asarray(jb.targets[k])[a], err_msg=k)


def test_epoch_permutation_matches_jax():
    for seed, epoch, n in ((0, 0, 10), (3, 5, 100), (11, 2, 7)):
        np.testing.assert_array_equal(train.epoch_permutation(n, seed, epoch),
                                      jtrain.epoch_permutation(n, seed, epoch))
    a = train.epoch_permutation(100, seed=3, epoch=5)
    assert not np.array_equal(a, train.epoch_permutation(100, seed=3, epoch=6))
    assert sorted(a) == list(range(100))


@pytest.mark.parametrize("bonds", [False, True])
def test_structure_needs_and_caps_match_jax(samples, bonds):
    kw = dict(bond_cutoff=2.6, use_bond_graph=True) if bonds else {}
    atoms = [s.atoms for s in samples[0]]
    jatoms = [s.atoms for s in samples[1]]
    needs = train.structure_needs(atoms, CUTOFF, **kw)
    assert needs == jtrain.structure_needs(jatoms, CUTOFF, **kw)
    assert needs[0]["edges"] > 0 and (not bonds or needs[0]["lines"] > 0)
    assert (fixed_caps_for_batches(needs, 3).as_dict()
            == j_fixed_caps(needs, 3).as_dict())


@pytest.mark.parametrize("family", ["tensornet", "chgnet"])
def test_loader_batches_and_pack_targets_match_jax(family, samples):
    extra = FAMILIES[family][2]
    kw = dict(micro_batch_size=2, accum_steps=2, species_fn=species_fn, seed=11, prefetch=0,
              **extra)
    ld = train.PackedBatchLoader(samples[0], CUTOFF, **kw)
    jld = jtrain.PackedBatchLoader(samples[1], CUTOFF, **kw)
    assert ld.caps.as_dict() == jld.caps.as_dict()
    assert ld.steps_per_epoch == jld.steps_per_epoch == 2
    for _ in range(3):  # crosses the epoch boundary
        b, jb = ld.next_batch(), jld.next_batch()
        _same_batch(b, jb)
        assert b.meta == jb.meta
        assert ld.state() == jld.state()
    ev, jev = ld.eval_batch(samples[0][:2]), jld.eval_batch(samples[1][:2])
    _same_batch(ev, jev)
    ld.close()
    jld.close()


def test_pack_targets_layout_and_stress(samples):
    from distmlip_tpu.partition import pack_structures as j_pack
    from distmlip_tpu_torch.partition import pack_structures

    port, jx = both_samples(n=3, seed=3, stress=True)
    g, host = pack_structures([s.atoms for s in port], CUTOFF, species_fn=species_fn)
    jg, jhost = j_pack([s.atoms for s in jx], CUTOFF, species_fn=species_fn)
    t = train.pack_targets(g, host, port)
    jt = jtrain.pack_targets(jg, jhost, jx)
    assert t.keys() == jt.keys() and "stress" in t and "inv_volume" in t
    for k in t:
        np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
    back = host.gather_per_structure(t["forces"])
    for i, s in enumerate(port):
        np.testing.assert_array_equal(back[i], s.forces)
    n_real = sum(len(s.forces) for s in port)
    assert (t["atom_slot"] < g.batch_size).sum() == n_real
    assert (t["atom_slot"][0, n_real:] == g.batch_size).all()


def test_loader_frozen_shapes_cursor_replay_and_prefetch(samples):
    kw = dict(micro_batch_size=2, accum_steps=2, species_fn=species_fn, seed=11)
    ld = train.PackedBatchLoader(samples[0], CUTOFF, prefetch=0, **kw)
    b0, b1 = ld.next_batch(), ld.next_batch()
    assert b0.meta["bucket_key"] == b1.meta["bucket_key"]
    assert ([g.positions.shape for g in b0.graphs] == [g.positions.shape for g in b1.graphs])
    ld.set_state({"seed": 11, "epoch": 0, "step": 1})
    b1r = ld.next_batch()
    for g, gr in zip(b1.graphs, b1r.graphs):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(gr, f)))
    ld.close()
    sync = train.PackedBatchLoader(samples[0], CUTOFF, prefetch=0, **kw)
    pre = train.PackedBatchLoader(samples[0], CUTOFF, prefetch=2, **kw)
    for _ in range(5):  # crosses epoch boundaries
        bs, bp = sync.next_batch(), pre.next_batch()
        for ts, tp in zip(bs.targets, bp.targets):
            for k in ts:
                np.testing.assert_array_equal(ts[k], tp[k])
        assert sync.state() == pre.state()
    sync.close()
    pre.close()
    with pytest.raises(NotImplementedError, match="A4"):
        train.PackedBatchLoader(samples[0], CUTOFF, batch_parts=2, **kw)


def test_train_batch_upload_is_explicit(samples):
    ld = train.PackedBatchLoader(samples[0], CUTOFF, micro_batch_size=2, species_fn=species_fn,
                                 prefetch=0)
    b = ld.next_batch()
    ld.close()
    assert isinstance(b.targets[0]["forces"], np.ndarray)
    assert isinstance(b.graphs[0].positions, np.ndarray)
    d = b.to("cpu")
    assert isinstance(d.targets[0]["forces"], torch.Tensor)
    assert isinstance(d.graphs[0].positions, torch.Tensor)
    assert d.meta == b.meta


def test_cost_model_plans_match_jax_on_a_lognormal_dataset():
    """200 structures with lognormal sizes: census, 3 tiers, caps, epoch
    plans (cost-model and naive) and predicted waste bit for bit."""
    rng = np.random.default_rng(5)
    n = 200
    sizes = np.clip(rng.lognormal(3.0, 1.0, n).round().astype(int), 4, 600)
    needs = [{"nodes": int(s), "edges": int(s) * int(rng.integers(20, 40)),
              "lines": int(s) * int(rng.integers(0, 90))} for s in sizes]
    census, jcensus = (train.CostCensus.from_needs(needs),
                       jtrain.CostCensus.from_needs(needs))
    np.testing.assert_array_equal(census.costs, jcensus.costs)
    assert census.render() == jcensus.render()
    for B, A, T in ((8, 1, 3), (4, 2, 2), (2, 3, 3)):
        tier_of, thr = train.assign_tiers(census.costs, T, min_members=B * A)
        jtier_of, jthr = jtrain.assign_tiers(census.costs, T, min_members=B * A)
        np.testing.assert_array_equal(tier_of, jtier_of)
        assert thr == jthr
        caps = train.tier_caps(needs, tier_of, B, accum_steps=A, costs=census.costs)
        jcaps = jtrain.tier_caps(needs, tier_of, B, accum_steps=A, costs=census.costs)
        assert {t: c.as_dict() for t, c in caps.items()} == {
            t: c.as_dict() for t, c in jcaps.items()}
        for epoch in (0, 1):
            plan = train.plan_epoch(census.costs, tier_of, seed=5, epoch=epoch,
                                    micro_batch_size=B, accum_steps=A)
            jplan = jtrain.plan_epoch(census.costs, tier_of, seed=5, epoch=epoch,
                                      micro_batch_size=B, accum_steps=A)
            assert [(s.tier, s.micro) for s in plan] == [(s.tier, s.micro) for s in jplan]
            naive = train.plan_epoch_naive(n, seed=5, epoch=epoch, micro_batch_size=B,
                                           accum_steps=A)
            jnaive = jtrain.plan_epoch_naive(n, seed=5, epoch=epoch, micro_batch_size=B,
                                             accum_steps=A)
            assert [(s.tier, s.micro) for s in naive] == [(s.tier, s.micro) for s in jnaive]
            assert (train.predicted_plan_waste(needs, plan, caps)
                    == jtrain.predicted_plan_waste(needs, jplan, jcaps))
    costs = np.array([10.0] * 15 + [1000.0])
    assert (train.assign_tiers(costs, 3, min_members=4)[0].tolist()
            == jtrain.assign_tiers(costs, 3, min_members=4)[0].tolist())


def test_tiered_loader_matches_jax(longtail):
    kw = dict(micro_batch_size=2, species_fn=species_fn, seed=11, prefetch=0,
              packing="cost_model", num_tiers=2)
    ld = train.PackedBatchLoader(longtail[0], CUTOFF, **kw)
    jld = jtrain.PackedBatchLoader(longtail[1], CUTOFF, **kw)
    assert ld.num_tiers == jld.num_tiers == 2
    np.testing.assert_array_equal(ld.tier_of, jld.tier_of)
    assert {t: c.as_dict() for t, c in ld.tier_caps.items()} == {
        t: c.as_dict() for t, c in jld.tier_caps.items()}
    assert ld.tier_first_steps() == jld.tier_first_steps()
    assert ld.steps_per_epoch == jld.steps_per_epoch
    for _ in range(ld.steps_per_epoch + 2):  # crosses the epoch edge
        assert ld.state() == jld.state()
        b, jb = ld.next_batch(), jld.next_batch()
        _same_batch(b, jb)
        assert b.meta == jb.meta
    st = ld.state()
    with pytest.raises(ValueError, match="tier mismatch"):
        ld.set_state({**st, "tier": 1 - st["tier"]})
    ld.close()
    jld.close()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_cost_fn_matches_jax(family):
    need = {"nodes": 32, "edges": 1200, "lines": 900}
    got = train.model_cost_fn(port_model(family))(need)
    want = jtrain.model_cost_fn(jax_model(family))(need)
    assert got == want and got > train.default_cost(need)
    assert flops.model_flop_estimate(port_model(family), 32, 1200, 900) == \
        jflops.model_flop_estimate(jax_model(family), 32, 1200, 900) > 0


def test_memory_stats_without_a_card():
    assert memory.device_memory_stats() == {}
    assert memory.device_bytes_limit() is None
    assert memory.measured_peak_bytes() is None
    stats = {"dev0_bytes_in_use": 10, "dev0_peak_bytes_in_use": 30, "dev0_bytes_limit": 100,
             "dev1_bytes_in_use": 50, "dev1_peak_bytes_in_use": 60, "dev1_bytes_limit": 80}
    assert memory.device_bytes_limit(stats) == 80
    assert memory.measured_peak_bytes(stats) == 60


def test_memory_stats_raise_on_a_card_that_fails(monkeypatch):
    # a failed query on a present card must not read as "no limit", which
    # would switch the trainer's memory gate off
    def broken(i):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        memory.device_bytes_limit()
