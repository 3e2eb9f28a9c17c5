"""The port's ``Trainer``, checkpoints and single-structure surface
(``distmlip_tpu_torch/train/loop.py``, ``train/checkpoint.py``,
``train/legacy.py``, ``utils/checkpoint.py``) against the JAX package's,
on the CPU.

- **Trainer against the JAX Trainer**: TensorNet (``tests/
  torch_train_common.py``), Adam 3e-3 against ``optax.adam(3e-3)``, EMA
  0.99, micro-batch 2, accumulation 2, 4 steps with eval every 2: each
  step's loss and gradient norm within rel 1e-5 of JAX's and the eval
  losses (on the EMA weights) within rel 1e-5 (float32 programs in
  another order, agreeing to ~1e-7 after one step; four Adam steps carry
  that); the final master weights within rel L2 1e-5.
- **Eval, best and history**: ``best.npz`` written on the improving evals,
  ``history`` per step, ``val_loss`` on the eval steps.
- **Resume**: a checkpoint mid-epoch restored into a FRESH Trainer gives
  the unbroken run's next losses and final weights bit for bit (naive
  packing), and across a tier boundary (cost-model packing, two tiers).
- **npz both ways**: the port's ``save_params`` read by the JAX
  ``load_params`` and the JAX ``save_params`` read by the port's, leaves
  equal; a port training checkpoint's ``params`` / ``ema_params`` read by
  the JAX ``load_params``.
- **Legacy**: ``make_loss_fn``'s loss and parameter gradient at P = 2
  against P = 1 (rel 1e-5 / rel L2 1e-4: the flattened halo exchange sums
  in another order) and at P = 1 against the JAX ``make_loss_fn`` (same
  bars); ``make_train_step`` and ``save_train_state`` /
  ``load_train_state`` round trip.
- **Memory gate**: with the measurement stood in (there is no card here)
  the auto-sizing halves to the largest micro-batch under the budget and
  an impossible budget raises before training.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from distmlip_tpu import train as jtrain
from distmlip_tpu.utils import checkpoint as jckpt
from distmlip_tpu_torch import train
from distmlip_tpu_torch.train import loop as train_loop
from distmlip_tpu_torch.train.step import param_leaves
from distmlip_tpu_torch.utils import load_params, save_params
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.torch_train_common import (CUTOFF, both_samples, jax_model, make_samples,
                                      numpy_tree, paths, port_model, rel_l2, species_fn)

pytestmark = pytest.mark.train


@pytest.fixture(scope="module")
def samples():
    return both_samples(n=8)


def _trainer(samples, tmp_path=None, **kw):
    kw.setdefault("micro_batch_size", 2)
    kw.setdefault("config", train.TrainConfig(ema_decay=0.99))
    kw.setdefault("loader_kwargs", {"species_fn": species_fn, "seed": 13})
    if tmp_path is not None:
        kw.setdefault("checkpoint_dir", str(tmp_path / "ckpts"))
    model = port_model("tensornet")
    return train.Trainer(model.energy_fn, model.init(0),
                         functools.partial(torch.optim.Adam, lr=3e-3), samples, CUTOFF,
                         device="cpu", **kw)


def _flat(state):
    return torch.cat([p.detach().reshape(-1) for p in param_leaves(state.params)]).numpy()


def test_trainer_matches_the_jax_trainer(samples):
    cfg = dict(ema_decay=0.99, accum_steps=2)
    t = _trainer(samples[0], config=train.TrainConfig(**cfg), val_samples=samples[0][:2],
                 eval_every=2)
    hist = t.fit(steps=4)
    jt = jtrain.Trainer(jax_model("tensornet").energy_fn,
                        jax.tree.map(jax.numpy.asarray, numpy_tree(port_model(
                            "tensornet").init(0))),
                        optax.adam(3e-3), samples[1], CUTOFF, micro_batch_size=2,
                        config=jtrain.TrainConfig(**cfg), val_samples=samples[1][:2],
                        eval_every=2, kernels=False,
                        loader_kwargs={"species_fn": species_fn, "seed": 13})
    jhist = jt.fit(steps=4)
    assert len(hist) == len(jhist) == 4
    for h, jh in zip(hist, jhist):
        for k in ("loss", "energy", "force", "grad_norm"):
            np.testing.assert_allclose(h[k], jh[k], rtol=1e-5, err_msg=k)
        assert ("val_loss" in h) == ("val_loss" in jh)
        if "val_loss" in h:
            np.testing.assert_allclose(h["val_loss"], jh["val_loss"], rtol=1e-5)
        assert h["epoch"] == jh["epoch"] and h["skipped"] == jh["skipped"] == 0
    assert rel_l2(paths(t.state.params), paths(jt.state.params)) < 1e-5
    assert t.compile_count == 1 and t.state.step == 4
    t.close()
    jt.close()


def test_eval_best_and_history(samples, tmp_path):
    t = _trainer(samples[0], tmp_path, val_samples=samples[0][:2], eval_every=2)
    hist = t.fit(steps=4)
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    evals = [h for h in hist if "val_loss" in h]
    assert len(evals) == 2
    assert t.checkpointer.best_metric == min(h["val_loss"] for h in evals)
    t.checkpointer.wait()
    assert (tmp_path / "ckpts" / "best.npz").exists()
    assert set(t.evaluate()) == {"loss", "energy", "force", "stress"}
    assert t.est_peak_bytes == 0 and t.tier_peak_bytes == {}  # nothing measured on the CPU
    t.close()


def test_resume_mid_epoch_is_bitwise(samples, tmp_path):
    t1 = _trainer(samples[0], tmp_path)
    assert t1.steps_per_epoch == 4
    for _ in range(3):  # stop mid-epoch
        t1.train_step()
    path = t1.save_checkpoint()
    cursor = dict(t1.loader.state())
    rng = t1.state.rng.get_state().clone()
    cont = [t1.train_step()["loss"] for _ in range(3)]
    end1 = _flat(t1.state)
    ema1 = torch.cat([p.reshape(-1) for p in param_leaves(t1.state.ema_params)]).numpy()
    t1.close()

    t2 = _trainer(samples[0], tmp_path)
    assert t2.restore(path) == 3
    assert t2.loader.state() == cursor
    assert torch.equal(t2.state.rng.get_state(), rng)
    cont2 = [t2.train_step()["loss"] for _ in range(3)]
    assert cont == cont2
    np.testing.assert_array_equal(end1, _flat(t2.state))
    np.testing.assert_array_equal(
        ema1, torch.cat([p.reshape(-1) for p in param_leaves(t2.state.ema_params)]).numpy())
    t2.close()


def test_resume_across_a_tier_boundary_is_bitwise(tmp_path):
    from distmlip_tpu_torch.calculators import Atoms

    rng = np.random.default_rng(7)
    data = (make_samples(train.Sample, Atoms, rng, 8, (1, 1, 1))
            + make_samples(train.Sample, Atoms, rng, 4, (2, 2, 2)))
    lk = {"species_fn": species_fn, "seed": 11, "packing": "cost_model", "num_tiers": 2}
    t1 = _trainer(data, tmp_path, loader_kwargs=lk, scheduler=functools.partial(
        torch.optim.lr_scheduler.StepLR, step_size=2, gamma=0.5))
    plan = t1.loader.epoch_plan(0)
    # stop right before a step whose tier differs from the previous one
    cut = next(i for i in range(1, len(plan)) if plan[i].tier != plan[i - 1].tier)
    for _ in range(cut):
        t1.train_step()
    path = t1.save_checkpoint()
    cont = [t1.train_step() for _ in range(3)]
    end1 = _flat(t1.state)
    t1.close()
    t2 = _trainer(data, tmp_path, loader_kwargs=lk, scheduler=functools.partial(
        torch.optim.lr_scheduler.StepLR, step_size=2, gamma=0.5))
    t2.restore(path)
    cont2 = [t2.train_step() for _ in range(3)]
    assert [m["loss"] for m in cont] == [m["loss"] for m in cont2]
    assert t1.history[cut - 1]["tier"] != cont[0]["tier"] == cont2[0]["tier"]
    np.testing.assert_array_equal(end1, _flat(t2.state))
    assert t2.state.scheduler.get_last_lr() == t1.state.scheduler.get_last_lr()
    assert t2.compile_count == len({m["tier"] for m in cont2})
    assert t1.compile_count == 2  # both tiers stepped, one shape each
    t2.close()


def test_params_npz_round_trip_both_ways(tmp_path):
    init = port_model("mace").init(0)
    save_params(str(tmp_path / "port.npz"), init)
    like = numpy_tree(init)
    got = jckpt.load_params(str(tmp_path / "port.npz"), like=like)
    want = paths(init)
    assert paths(got).keys() == want.keys()
    for k, v in paths(got).items():
        np.testing.assert_array_equal(v, want[k])
    jckpt.save_params(str(tmp_path / "jax.npz"), like)
    back = load_params(str(tmp_path / "jax.npz"), like=init)
    assert isinstance(back["interactions"], list)
    for k, v in paths(back).items():
        np.testing.assert_array_equal(v, want[k])
    # a training checkpoint's weights, read by the JAX package
    state = train.init_train_state(functools.partial(torch.optim.Adam, lr=1e-3), init)
    ck = train.TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(state, {"seed": 0, "epoch": 0, "step": 0}, step=1)
    ck.wait()
    tree = jckpt.load_params(train.latest_checkpoint(str(tmp_path / "ck")),
                             like={"params": like, "ema_params": like})
    for k, v in paths(tree["params"]).items():
        np.testing.assert_array_equal(v, want[k])


def test_checkpointer_best_prune_and_saver(samples, tmp_path):
    state = train.init_train_state(functools.partial(torch.optim.Adam, lr=1e-3),
                                   port_model("tensornet").init(0))
    ck = train.TrainCheckpointer(str(tmp_path), keep=2)
    assert ck.save_best(state, 0.1)
    for step in range(1, 5):
        ck.save(state, {"seed": 1, "epoch": 0, "step": 0}, step=step)
    ck.wait()
    names = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("ckpt-"))
    assert names == ["ckpt-00000003.npz", "ckpt-00000004.npz"]
    ck2 = train.TrainCheckpointer(str(tmp_path), keep=2)
    ck2.restore(state)
    assert ck2.best_metric == 0.1
    assert not ck2.save_best(state, 0.5)
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]


def _legacy_graph(P, jax_side=False):
    """A 64-atom fcc cell (a = 3.5 Å, 1 x 2 x 8 cells: 28 Å along the slab
    axis, so P = 2 slabs are wider than twice the cutoff), both packages'
    numpy neighbor search."""
    from tests.utils import make_crystal

    cart, lat, species = make_crystal(np.random.default_rng(1), reps=(1, 2, 8), a=3.5,
                                      noise=0.1, n_species=3)
    if jax_side:
        from distmlip_tpu.neighbors import neighbor_list_numpy
        from distmlip_tpu.partition import build_partitioned_graph, build_plan
    else:
        from distmlip_tpu_torch.neighbors import neighbor_list_numpy
        from distmlip_tpu_torch.partition import build_partitioned_graph, build_plan
    nl = neighbor_list_numpy(cart, lat, [1, 1, 1], CUTOFF)
    plan = build_plan(nl, lat, [1, 1, 1], P, CUTOFF)
    graph, _ = build_partitioned_graph(plan, nl, species, lat)
    return graph


def _legacy_port(P, params):
    graph = _legacy_graph(P).to("cpu")
    targets = {"energy": torch.tensor(-3.0), "forces": torch.zeros(graph.positions.shape),
               "stress": torch.zeros((3, 3))}
    loss = train.make_loss_fn(port_model("tensornet").energy_fn, 1.0, 1.0, 10.0)(
        params, graph, graph.positions, targets)
    grads = torch.autograd.grad(loss, param_leaves(params))
    return float(loss.detach()), {k: g.double().numpy() for k, g in zip(paths(params), grads)}


def test_legacy_loss_p2_p1_and_jax():
    init = port_model("tensornet").init(0)
    init["data_std"] = torch.tensor(3.0)
    params = train.init_train_state(functools.partial(torch.optim.SGD, lr=0.1), init).params
    l1, g1 = _legacy_port(1, params)
    l2, g2 = _legacy_port(2, params)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    assert rel_l2(g2, g1) < 1e-4

    jgraph = _legacy_graph(1, jax_side=True)
    jloss = jtrain.make_loss_fn(jax_model("tensornet").energy_fn, None, 1.0, 1.0, 10.0)
    jtargets = {"energy": np.float32(-3.0),
                "forces": np.zeros(np.shape(jgraph.positions), np.float32),
                "stress": np.zeros((3, 3), np.float32)}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jax.numpy.asarray, numpy_tree(init)), jgraph, jgraph.positions, jtargets)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-5)
    assert rel_l2(g1, paths(jg)) < 1e-4


def test_legacy_train_step_and_state_round_trip(tmp_path):
    init = port_model("tensornet").init(0)
    params = train.init_train_state(functools.partial(torch.optim.SGD, lr=0.1), init).params
    opt = torch.optim.Adam(param_leaves(params), lr=1e-3)
    graph = _legacy_graph(1).to("cpu")
    targets = {"energy": torch.tensor(-3.0), "forces": torch.zeros(graph.positions.shape)}
    step = train.make_train_step(port_model("tensornet").energy_fn, opt)
    losses = [float(step(params, graph, graph.positions, targets)) for _ in range(3)]
    assert losses[-1] < losses[0]
    graphs = train.stack_graphs([graph, graph])
    tg = train.stack_targets([targets, targets])
    pos = torch.stack([graph.positions, graph.positions])
    ev = train.make_eval_fn(port_model("tensornet").energy_fn)(params, graphs, pos, tg)
    np.testing.assert_allclose(float(ev), float(train.make_loss_fn(
        port_model("tensornet").energy_fn)(params, graph, graph.positions, targets).detach()),
        rtol=1e-6)
    bstep = train.make_batched_train_step(port_model("tensornet").energy_fn, opt)
    assert np.isfinite(float(bstep(params, graphs, pos, tg)))
    path = str(tmp_path / "legacy.npz")
    train.save_train_state(path, params, opt, 4)
    fresh = train.init_train_state(functools.partial(torch.optim.SGD, lr=0.1), init).params
    opt2 = torch.optim.Adam(param_leaves(fresh), lr=1e-3)
    p2, o2, s = train.load_train_state(path, fresh, opt2)
    assert s == 4 and o2 is opt2 and p2 is fresh
    for a, b in zip(param_leaves(p2), param_leaves(params)):
        assert a.requires_grad and torch.equal(a.detach(), b.detach())
    st = opt.state_dict()["state"]
    for i, entry in opt2.state_dict()["state"].items():
        for name, v in entry.items():
            assert torch.equal(v, st[i][name]), name
    # the restored run's next step is the unbroken run's next step, bit for bit
    l_run = step(params, graph, graph.positions, targets)
    l_res = train.make_train_step(port_model("tensornet").energy_fn, opt2)(
        p2, graph, graph.positions, targets)
    assert torch.equal(l_run, l_res)
    for a, b in zip(param_leaves(p2), param_leaves(params)):
        assert torch.equal(a.detach(), b.detach())
    with pytest.raises(ValueError, match="mixed array shapes"):
        train.stack_graphs([graph, _legacy_graph(2).to("cpu")])
    # the packed energy takes a packed single-partition graph only
    from distmlip_tpu_torch.parallel import make_packed_energy_fn

    for g in (graph, _legacy_graph(2).to("cpu")):
        with pytest.raises(ValueError, match="single-partition packed graph"):
            make_packed_energy_fn(port_model("tensornet").energy_fn)(
                params, g, g.positions, torch.zeros((1, 3, 3)))


def test_memory_gate_sizing_and_refusal(samples, monkeypatch):
    seen = []

    def fake_peak(step_fn, state, batch, device):
        b = len(batch.targets[0]["n_atoms"])  # the micro-batch's slots
        seen.append(b)
        return 1000 * b

    monkeypatch.setattr(train_loop, "estimate_step_peak_bytes", fake_peak)
    t = _trainer(samples[0], micro_batch_size="auto", hbm_budget_bytes=2600)
    # 8 -> 4 -> 2: 2000 <= 0.8 * 2600 < 4000
    assert t.loader.micro_batch_size == 2 and seen == [8, 4, 2]
    assert t.est_peak_bytes == 2000 and t.tier_peak_bytes == {0: 2000}
    t.close()
    with pytest.raises(ValueError, match="fits the memory budget"):
        _trainer(samples[0], micro_batch_size=2, hbm_budget_bytes=1000)
    assert train.estimate_step_peak_bytes(None, None, None, "cpu") is None


def test_trainer_refusals(samples):
    # telemetry= (A12) is ported: one TrainRecord a step
    from distmlip_tpu_torch.telemetry import AggregatingSink, Telemetry

    hub = Telemetry([AggregatingSink()])
    t = _trainer(samples[0], telemetry=hub)
    t.fit(steps=1)
    assert t.telemetry is hub and hub.sinks[0].n_records == 1
    t.close()
    with pytest.raises(NotImplementedError, match="A4"):
        _trainer(samples[0], mesh=object())
    with pytest.raises(ValueError, match="zero1=True"):
        _trainer(samples[0], config=train.TrainConfig(zero1=True))
    with pytest.raises(ValueError, match="structures per optimizer step"):
        _trainer(samples[0], micro_batch_size=16)
