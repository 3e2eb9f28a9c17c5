"""Resumable training checkpoints: async, atomic, bitwise on the CPU
(``distmlip_tpu/train/checkpoint.py``).

A checkpoint is ONE npz in ``utils.checkpoint``'s layout holding the whole
resume story:

- ``params/...`` and ``ema_params/...``: the fp32 master and EMA weights,
  key path for key path the JAX package's parameter layout under those
  prefixes (the JAX ``load_params`` reads them with a template
  ``{"params": tree, "ema_params": tree}``);
- ``optimizer/...``: the optimizer's ``state_dict`` tensors under
  ``optimizer/state/<param index>/<name>``, and its other entries (param
  groups, non-tensor state) as JSON in ``optimizer/meta``;
- ``scheduler``: the scheduler's ``state_dict`` as JSON, when there is one;
- ``step``, ``loss_scale``, ``good_steps`` and ``rng`` (the generator's
  state bytes);
- ``loader/{seed,epoch,step,tier}``: the loader cursor, which with the
  deterministic epoch order replays the remaining stream, and
  ``best_metric``.

Writes go through ``utils.checkpoint.AsyncSaver`` (host copies taken
synchronously, compression and disk on a background thread, tmp + rename),
with ``keep`` newest retention that counts writes in flight, and a
separate best-model file. A restore copies every tensor into the trainer's
state on its device. On the CPU a resumed run equals an unbroken one bit
for bit; on a card, ``index_add_`` (plain recompute, gather backwards)
adds with atomics, so the two agree to roundoff.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..utils.checkpoint import AsyncSaver, load_params
from .step import param_leaves

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")
BEST_NAME = "best.npz"
_TENSOR = "__tensor__"


def _loader_state_tree(loader_state: dict | None) -> dict:
    s = loader_state or {}
    # "tier" is the cost-model loader's derived tier coordinate; naive
    # loaders save 0 and ignore it on restore, the tiered loader validates it
    return {"seed": np.int64(s.get("seed", 0)), "epoch": np.int64(s.get("epoch", 0)),
            "step": np.int64(s.get("step", 0)), "tier": np.int64(s.get("tier", 0))}


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.item()
    raise TypeError(f"checkpoint: cannot store {type(x).__name__} {x!r} of a state dict")


def optimizer_payload(optimizer) -> dict:
    """An optimizer's ``state_dict`` as ``{"state": {i: {name: array}},
    "meta": json}``: tensors as arrays, everything else in the JSON."""
    sd = optimizer.state_dict()
    tensors, meta_state = {}, {}
    for idx, entry in sd["state"].items():
        tensors[str(idx)] = {}
        meta_state[str(idx)] = {}
        for name, v in entry.items():
            if isinstance(v, torch.Tensor):
                tensors[str(idx)][name] = v
                meta_state[str(idx)][name] = _TENSOR
            else:
                meta_state[str(idx)][name] = v
    meta = json.dumps({"param_groups": sd["param_groups"], "state": meta_state},
                      default=_jsonable)
    return {"state": tensors, "meta": np.array(meta)}


def load_optimizer_payload(optimizer, data: dict, prefix: str = "optimizer/") -> None:
    """Load what :func:`optimizer_payload` wrote (``data``: the npz's
    arrays) into ``optimizer``; tensors go to its parameters' device."""
    meta = json.loads(str(data[prefix + "meta"]))
    state = {}
    for idx, entry in meta["state"].items():
        state[int(idx)] = {
            name: (torch.from_numpy(np.array(data[f"{prefix}state/{idx}/{name}"]))
                   if v == _TENSOR else v)
            for name, v in entry.items()}
    optimizer.load_state_dict({"state": state, "param_groups": meta["param_groups"]})


def latest_checkpoint(directory: str) -> str | None:
    """Path of the newest ``ckpt-NNNNNNNN.npz`` in ``directory`` (by step
    number, not mtime)."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    best = None
    for name in names:
        m = _CKPT_RE.match(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), name)
    return os.path.join(directory, best[1]) if best else None


class TrainCheckpointer:
    """Periodic and best-model checkpoint writer for one training run.

    ``save(state, loader_state, step)`` starts an async atomic write of
    ``ckpt-{step:08d}.npz`` and prunes to the ``keep`` newest; ``save_best``
    mirrors the state to ``best.npz`` on its own writer thread. ``wait()``
    joins both writers: call it before reading files back or exiting."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)
        self._saver = AsyncSaver()
        self._best_saver = AsyncSaver()
        self.best_metric: float | None = None

    # ---- writing ----

    def _payload(self, state, loader_state):
        # best_metric rides every checkpoint so a resumed run keeps the
        # true best (a worse first eval after a restore must not win)
        best = self.best_metric if self.best_metric is not None else np.inf
        payload = {
            "params": state.params, "ema_params": state.ema_params,
            "optimizer": optimizer_payload(state.optimizer),
            "step": np.int64(state.step), "loss_scale": np.float64(state.loss_scale),
            "good_steps": np.int64(state.good_steps),
            "rng": state.rng.get_state().numpy(),
            "loader": _loader_state_tree(loader_state), "best_metric": np.float64(best)}
        if state.scheduler is not None:
            payload["scheduler"] = np.array(json.dumps(state.scheduler.state_dict(),
                                                       default=_jsonable))
        return payload

    def save(self, state, loader_state: dict | None = None, step: int | None = None) -> str:
        step = int(state.step) if step is None else int(step)
        name = f"ckpt-{step:08d}.npz"
        path = os.path.join(self.directory, name)
        self._saver.save(path, self._payload(state, loader_state))
        self._prune(incoming=name)
        return path

    def save_best(self, state, metric: float, loader_state: dict | None = None) -> bool:
        """Write ``best.npz`` iff ``metric`` improves on the best seen
        (lower is better). Returns whether it did."""
        if self.best_metric is not None and metric >= self.best_metric:
            return False
        self.best_metric = float(metric)
        self._best_saver.save(os.path.join(self.directory, BEST_NAME),
                              self._payload(state, loader_state))
        return True

    def _prune(self, incoming: str | None = None) -> None:
        """Keep the ``keep`` newest checkpoints, counting a write in flight
        (its file may not exist yet) as present."""
        entries = set()
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                entries.add((int(m.group(1)), name))
        if incoming is not None:
            m = _CKPT_RE.match(incoming)
            if m:
                entries.add((int(m.group(1)), incoming))
        for _, name in sorted(entries)[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:  # pragma: no cover - concurrent cleanup
                pass

    def wait(self) -> None:
        self._saver.wait()
        self._best_saver.wait()

    # ---- reading ----

    def _load(self, state, path):
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
        trees = load_params(path, like={"params": state.params,
                                        "ema_params": state.ema_params}, device="cpu")
        with torch.no_grad():
            for name in ("params", "ema_params"):
                for dst, src in zip(param_leaves(getattr(state, name)),
                                    param_leaves(trees[name])):
                    dst.copy_(src)
        load_optimizer_payload(state.optimizer, data)
        if state.scheduler is not None:
            state.scheduler.load_state_dict(json.loads(str(data["scheduler"])))
        state.step = int(data["step"])
        state.loss_scale = float(data["loss_scale"])
        state.good_steps = int(data["good_steps"])
        state.rng.set_state(torch.from_numpy(np.array(data["rng"])))
        best = float(data.get("best_metric", np.inf))
        if np.isfinite(best) and (self.best_metric is None or best < self.best_metric):
            self.best_metric = best
        loader = {k: int(data[f"loader/{k}"]) for k in ("seed", "epoch", "step", "tier")}
        return state, loader

    def restore(self, state, path: str | None = None):
        """Load ``path`` (default: the newest periodic checkpoint) INTO
        ``state`` (a ``TrainState`` of the same model and optimizer, e.g. a
        fresh one): master and EMA weights copied into its tensors on their
        device, optimizer and scheduler state dicts loaded, the scalars and
        the generator set. Returns ``(state, loader_state)`` and restores
        ``best_metric``."""
        self.wait()
        if path is None:
            path = latest_checkpoint(self.directory)
            if path is None:
                raise FileNotFoundError(f"no ckpt-*.npz checkpoints in {self.directory!r}")
        return self._load(state, path)

    def restore_best(self, state):
        self.wait()
        return self._load(state, os.path.join(self.directory, BEST_NAME))
