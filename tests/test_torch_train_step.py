"""The port's train step (``distmlip_tpu_torch/train/step.py``) against the
JAX package's (``distmlip_tpu/train/step.py``), on the CPU.

Set-up in ``tests/torch_train_common.py``: the samples of
``tests/test_train_subsystem.py`` and the four families at small widths,
both packages starting from the port's ``init`` as numpy.

- **Packed loss, per family**: the loss terms and the parameter gradient
  of ``make_packed_loss_fn`` (forces through ``create_graph=True``, then
  the parameter gradient through them) against ``jax.value_and_grad`` of
  the JAX ``make_packed_loss_fn`` (``kernels=False``), with stress on
  (``w_stress = 10``) so the strain path trains too. Bars: each loss term
  within rel 1e-5 and the whole gradient vector within rel L2 1e-4. Both
  are float32 programs summing in other orders; the gradient is a second
  derivative through every layer, where float32 roundoff compounds to
  ~1e-6 relative, so 1e-4 leaves two decades.
- **Optimizer trajectories**: 3 steps of SGD (0.1, momentum 0.9, loss
  scale 2^15) and of Adam (1e-3, with ``clip_norm`` 0.05, which clips every
  step here, and EMA 0.9) against ``optax.sgd`` / ``optax.adam`` through
  the JAX accumulated step (one JAX program per configuration, shared):
  parameters and EMA within rel L2 1e-5 and each step's loss within rel
  1e-5 (one step's gradient agrees to ~1e-6; three updates carry it).
- **Loss scale**: a forced non-finite gradient (infinite energy targets)
  on both sides, SGD with momentum (a buffer to keep): the skip, step and
  scale sequences equal JAX's exactly, and the skipped step leaves
  parameters, EMA, momentum buffer and scheduler bitwise as they were.
- **Accumulation**: 4 micro-batches of 1 against 1 of 4 (rel 1e-6 of the
  largest parameter, the JAX test's bar), port only.
- **bf16**: ``precision="bf16"`` on a bf16 TensorNet keeps master weights,
  EMA, gradients and optimizer state fp32.
- **remat**: MACE with ``remat=True`` (a non-reentrant checkpoint around
  each chunk body, recomputed under ``create_graph``) gives the
  parameter gradient of ``remat=False`` within rel L2 1e-6.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from distmlip_tpu.train import PackedBatchLoader as JLoader
from distmlip_tpu.train import TrainConfig as JTrainConfig
from distmlip_tpu.train import init_train_state as j_init_train_state
from distmlip_tpu.train import make_accum_train_step as j_make_accum_train_step
from distmlip_tpu.train import make_packed_loss_fn as j_make_packed_loss_fn
from distmlip_tpu_torch.train import (PackedBatchLoader, TrainConfig, init_train_state,
                                      make_accum_train_step, make_eval_step,
                                      make_packed_loss_fn, resolve_zero1)
from distmlip_tpu_torch.train.step import param_leaves
from distmlip_tpu_torch.utils import params_from_numpy
from tests.torch_threads import one_intra_op_thread  # noqa: F401
from tests.torch_train_common import (CUTOFF, FAMILIES, both_samples, jax_micro, jax_model,
                                      numpy_tree, paths, port_model, rel_l2, species_fn)

pytestmark = pytest.mark.train


@pytest.fixture(scope="module")
def samples():
    return both_samples(n=8, stress=True)


def _loaders(samples, family, B, A=1, **kw):
    extra = FAMILIES[family][2]
    port, jx = samples
    common = dict(micro_batch_size=B, accum_steps=A, species_fn=species_fn, shuffle=False,
                  prefetch=0, **extra, **kw)
    return PackedBatchLoader(port, CUTOFF, **common), JLoader(jx, CUTOFF, **common)


def _jax_params(tree):
    return jax.tree.map(jax.numpy.asarray, numpy_tree(tree))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_packed_loss_and_gradient_match_jax(samples, family):
    model = port_model(family)
    init = model.init(0)
    if family in ("tensornet", "chgnet"):
        # random readouts give meV/Å forces at these widths: a force scale
        init["data_std"] = torch.tensor(3.0)
    cfg = TrainConfig(w_stress=10.0)
    loader, jloader = _loaders(samples, family, B=4)
    batch, jbatch = loader.next_batch().to("cpu"), jloader.next_batch()
    loader.close()
    jloader.close()

    params = init_train_state(functools.partial(torch.optim.SGD, lr=0.1), init).params
    loss, comps = make_packed_loss_fn(model.energy_fn, config=cfg)(
        params, batch.graphs[0], batch.targets[0])
    leaves = param_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = {k: g for k, g in zip(paths(params), grads)}
    got = {k: (np.zeros_like(paths(params)[k]) if g is None else
               g.double().numpy()) for k, g in got.items()}

    jloss_fn = j_make_packed_loss_fn(jax_model(family).energy_fn, None,
                                     JTrainConfig(w_stress=10.0), kernels=False)
    (jl, jcomps), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        _jax_params(init), *jax_micro(jbatch))
    want = paths(jgrads)
    for k in ("loss", "energy", "force", "stress"):
        np.testing.assert_allclose(float(comps[k]), float(jcomps[k]), rtol=1e-5,
                                   err_msg=f"{family} {k}")
    assert float(comps["stress"]) > 0 and float(comps["force"]) > 0
    assert rel_l2(got, want) < 1e-4, rel_l2(got, want)


def _run_port(samples, cfg, opt, steps, bad_first=False):
    model = port_model("tensornet")
    loader, _ = _loaders(samples, "tensornet", B=2, A=cfg.accum_steps)
    state = init_train_state(opt, model.init(0), config=cfg)
    step = make_accum_train_step(model.energy_fn, config=cfg)
    out = []
    for i in range(steps):
        b = loader.next_batch().to("cpu")
        targets = b.targets
        if bad_first and i == 0:
            targets = [dict(t, energy=torch.where(t["struct_mask"] > 0, torch.inf, 0.0))
                       for t in targets]
        state, m = step(state, b.graphs, targets)
        out.append(m)
    loader.close()
    return state, out


# one JAX step program per (optimizer, config), shared by the tests here:
# each new jitted step costs a compile of the double backward
_JAX_STEPS = {}
SGD_KW = dict(loss_scale=2.0 ** 15, scale_growth_interval=2)  # SGD 0.1, momentum 0.9


def _jax_step(opt_name, cfg):
    key = (opt_name, cfg)
    if key not in _JAX_STEPS:
        opt = optax.sgd(0.1, momentum=0.9) if opt_name == "sgd" else optax.adam(1e-3)
        _JAX_STEPS[key] = opt, j_make_accum_train_step(
            jax_model("tensornet").energy_fn, opt, None, cfg, kernels=False, donate=False)
    return _JAX_STEPS[key]


def _run_jax(samples, cfg, opt_name, steps, bad_first=False):
    _, loader = _loaders(samples, "tensornet", B=2, A=cfg.accum_steps)
    opt, step = _jax_step(opt_name, cfg)
    state = j_init_train_state(opt, _jax_params(port_model("tensornet").init(0)), None, cfg)
    out = []
    for i in range(steps):
        b = loader.next_batch()
        targets = b.targets
        if bad_first and i == 0:
            targets = dict(targets, energy=np.where(np.asarray(targets["struct_mask"]) > 0,
                                                    np.inf, 0.0).astype(np.float32))
        state, m = step(state, b.graphs, targets)
        out.append(m)
    loader.close()
    return state, out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_three_steps_match_optax(samples, opt):
    """SGD: momentum 0.9, the default EMA, a 2^15 loss scale (unscaled
    exactly: a power of two). Adam: clip 0.05 (below every step's norm
    here) and EMA 0.9, so clip and EMA are both in the trajectory."""
    kw = SGD_KW if opt == "sgd" else dict(clip_norm=0.05, ema_decay=0.9)
    port_opt = (functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9) if opt == "sgd"
                else functools.partial(torch.optim.Adam, lr=1e-3))
    state, ms = _run_port(samples, TrainConfig(**kw), port_opt, 3)
    jstate, jms = _run_jax(samples, JTrainConfig(**kw), opt, 3)
    for m, jm in zip(ms, jms):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert m["step"] == int(jm["step"]) and m["skipped"] == int(jm["skipped"]) == 0
    if opt == "adam":
        assert all(float(m["grad_norm"]) > 0.05 for m in ms)  # clip acted every step
        assert rel_l2(paths(state.ema_params), paths(jstate.ema_params)) < 1e-5
    assert rel_l2(paths(state.params), paths(jstate.params)) < 1e-5
    moved = rel_l2(paths(state.params), paths(port_model("tensornet").init(0)))
    assert moved > 1e-4  # the steps did move the weights


def test_loss_scale_backoff_growth_and_skip_match_jax(samples):
    kw = SGD_KW
    port_opt = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    model = port_model("tensornet")
    loader, _ = _loaders(samples, "tensornet", B=2)
    state = init_train_state(port_opt, model.init(0), config=TrainConfig(**kw),
                             scheduler=functools.partial(torch.optim.lr_scheduler.StepLR,
                                                         step_size=1, gamma=0.5))
    assert state.loss_scale == 2.0 ** 15
    step = make_accum_train_step(model.energy_fn, config=TrainConfig(**kw))
    b = loader.next_batch().to("cpu")
    # one finite step first, so the optimizer has state to keep
    state, m0 = step(state, b.graphs, b.targets)
    before = ([p.detach().clone() for p in param_leaves(state.params)],
              [p.detach().clone() for p in param_leaves(state.ema_params)],
              {k: v.clone() for k, v in state.optimizer.state[param_leaves(state.params)[0]]
               .items()}, state.scheduler.state_dict(), state.optimizer.param_groups[0]["lr"])
    bad = [dict(t, energy=torch.where(t["struct_mask"] > 0, torch.inf, 0.0))
           for t in b.targets]
    state, m1 = step(state, b.graphs, bad)
    assert m1["skipped"] == 1 and m1["step"] == 1 and m1["loss_scale"] == 2.0 ** 14
    for p, q in zip(before[0], param_leaves(state.params)):
        assert torch.equal(p, q)
    for p, q in zip(before[1], param_leaves(state.ema_params)):
        assert torch.equal(p, q)
    for k, v in state.optimizer.state[param_leaves(state.params)[0]].items():
        assert torch.equal(v, before[2][k]), k
    assert state.scheduler.state_dict() == before[3]
    assert state.optimizer.param_groups[0]["lr"] == before[4]
    ms = [m0, m1]
    for _ in range(3):
        nb = loader.next_batch().to("cpu")
        state, m = step(state, nb.graphs, nb.targets)
        ms.append(m)
    loader.close()

    # the JAX step on the same sequence (finite, bad, 3 finite)
    _, jloader = _loaders(samples, "tensornet", B=2)
    jcfg = JTrainConfig(**kw)
    jopt, jstep = _jax_step("sgd", jcfg)
    jstate = j_init_train_state(jopt, _jax_params(model.init(0)), None, jcfg)
    jb = jloader.next_batch()
    jms = []
    jstate, m = jstep(jstate, jb.graphs, jb.targets)
    jms.append(m)
    jbad = dict(jb.targets, energy=np.where(np.asarray(jb.targets["struct_mask"]) > 0,
                                            np.inf, 0.0).astype(np.float32))
    jstate, m = jstep(jstate, jb.graphs, jbad)
    jms.append(m)
    for _ in range(3):
        nb = jloader.next_batch()
        jstate, m = jstep(jstate, nb.graphs, nb.targets)
        jms.append(m)
    jloader.close()
    assert [m["skipped"] for m in ms] == [int(m["skipped"]) for m in jms] == [0, 1, 0, 0, 0]
    assert [m["step"] for m in ms] == [int(m["step"]) for m in jms] == [1, 1, 2, 3, 4]
    assert ([m["loss_scale"] for m in ms] == [float(m["loss_scale"]) for m in jms]
            == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14, 2.0 ** 15, 2.0 ** 15])
    assert state.good_steps == int(jstate.good_steps) == 1


def test_accumulation_matches_big_batch(samples):
    outs = {}
    for name, (B, A) in (("accum", (1, 4)), ("big", (4, 1))):
        model = port_model("tensornet")
        loader, _ = _loaders(samples, "tensornet", B=B, A=A)
        cfg = TrainConfig(accum_steps=A)
        state = init_train_state(functools.partial(torch.optim.SGD, lr=0.1), model.init(0),
                                 config=cfg)
        b = loader.next_batch().to("cpu")
        loader.close()
        outs[name] = make_accum_train_step(model.energy_fn, config=cfg)(state, b.graphs,
                                                                          b.targets)
    fa = torch.cat([p.detach().reshape(-1) for p in param_leaves(outs["accum"][0].params)])
    fb = torch.cat([p.detach().reshape(-1) for p in param_leaves(outs["big"][0].params)])
    assert float((fa - fb).abs().max()) <= 1e-6 * max(float(fb.abs().max()), 1.0)
    np.testing.assert_allclose(float(outs["accum"][1]["loss"]),
                               float(outs["big"][1]["loss"]), rtol=1e-6)


def test_bf16_model_keeps_fp32_master_weights(samples):
    model = port_model("tensornet", dtype="bfloat16")
    cfg = TrainConfig(precision="bf16", accum_steps=2)
    loader, _ = _loaders(samples, "tensornet", B=2, A=2)
    state = init_train_state(functools.partial(torch.optim.Adam, lr=1e-3), model.init(0),
                             config=cfg)
    b = loader.next_batch().to("cpu")
    loader.close()
    seen = []
    orig = torch.optim.Adam.step

    def spy(self, *a, **k):  # the gradients the optimizer is handed
        seen.extend(p.grad.dtype for g in self.param_groups for p in g["params"])
        return orig(self, *a, **k)

    torch.optim.Adam.step = spy
    try:
        state, m = make_accum_train_step(model.energy_fn, config=cfg)(state, b.graphs,
                                                                      b.targets)
    finally:
        torch.optim.Adam.step = orig
    assert np.isfinite(float(m["loss"])) and m["skipped"] == 0
    assert seen and set(seen) == {torch.float32}
    for p in param_leaves(state.params) + param_leaves(state.ema_params):
        assert p.dtype == torch.float32
    for st in state.optimizer.state.values():
        for v in st.values():
            assert v.dtype == torch.float32


def test_remat_gradient_equals_no_remat(samples, monkeypatch):
    from distmlip_tpu_torch.ops import chunk

    calls = []
    real = chunk.checkpoint
    monkeypatch.setattr(chunk, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    loader, _ = _loaders(samples, "mace", B=2)
    b = loader.next_batch().to("cpu")
    loader.close()
    grads = {}
    for remat in (False, True):
        model = port_model("mace", remat=remat, edge_chunk=64)
        params = init_train_state(functools.partial(torch.optim.SGD, lr=0.1),
                                  model.init(0)).params
        loss, _ = make_packed_loss_fn(model.energy_fn)(params, b.graphs[0], b.targets[0])
        g = torch.autograd.grad(loss, param_leaves(params))
        grads[remat] = {k: x.double().numpy() for k, x in zip(paths(params), g)}
        assert bool(calls) == remat  # the chunk bodies ran under checkpoint
    assert rel_l2(grads[True], grads[False]) < 1e-6


def test_eval_step_and_refusals(samples):
    model = port_model("tensornet")
    loader, _ = _loaders(samples, "tensornet", B=2)
    b = loader.next_batch().to("cpu")
    loader.close()
    state = init_train_state(functools.partial(torch.optim.SGD, lr=0.1), model.init(0))
    comps = make_eval_step(model.energy_fn)(state.params, b.graphs, b.targets)
    loss, want = make_packed_loss_fn(model.energy_fn)(state.params, b.graphs[0],
                                                      b.targets[0])
    assert float(comps["loss"]) == float(want["loss"])
    assert not comps["loss"].requires_grad
    assert resolve_zero1(TrainConfig()) is False
    with pytest.raises(ValueError, match="zero1=True"):
        resolve_zero1(TrainConfig(zero1=True))
    with pytest.raises(NotImplementedError, match="A4"):
        make_packed_loss_fn(model.energy_fn, mesh=object())
    with pytest.raises(ValueError, match="no stress targets"):
        no_stress = [{k: v for k, v in t.items() if k not in ("stress", "inv_volume")}
                     for t in b.targets]
        make_eval_step(model.energy_fn, config=TrainConfig(w_stress=1.0))(
            state.params, b.graphs, no_stress)
