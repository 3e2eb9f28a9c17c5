"""Parameters across the two packages: numpy trees and npz checkpoints.

The JAX package's parameters are nested dicts and lists of arrays
(``jax.tree.map(np.asarray, params)`` gives numpy leaves), saved by
``distmlip_tpu/utils/checkpoint.py:44`` ``save_params`` as an npz with
slash-joined tree paths plus a layout-era sentinel. This module turns
either into the port's tree of torch tensors with the same paths, so a
model reads ``params["interactions"][t]["lin_up"]["0"]["w"]`` in both.

``save_params`` and ``AsyncSaver`` (``distmlip_tpu/utils/checkpoint.py:
27-105``) write that npz layout key path for key path from a tree of
torch tensors, so a checkpoint crosses between the two packages in both
directions: the JAX ``load_params`` reads what the port writes, and the
port's ``load_params`` reads what the JAX package writes.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

# in-memory tensor-layout era the saved parameters assume (the JAX
# package's LAYOUT_VERSION, distmlip_tpu/utils/checkpoint.py:23-24):
# version 2 is the channels-last flip, which changed flatten order without
# changing parameter shapes, so a mismatched checkpoint must fail loudly
LAYOUT_VERSION = 2
_LAYOUT_KEY = "__distmlip_layout_version__"


def params_from_numpy(tree, device="cpu"):
    """A nested dict/list/tuple of arrays (numpy, torch or Python scalars)
    -> the same structure of torch tensors on ``device``. Float arrays keep
    their dtype; ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.array(tree), device=device)  # copies


def as_list(node):
    """A list/tuple subtree as a list. A checkpoint loaded without a
    template keeps list positions as dicts keyed "0", "1", ... (slash paths
    cannot tell the two apart); this reads either."""
    if isinstance(node, (list, tuple)):
        return list(node)
    return [node[str(i)] for i in range(len(node))]


def _host_array(x) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 (which numpy lacks) is
    widened to float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy().copy()
    return np.array(x)


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{"a/0/w": array}``: the tree's leaves as host arrays under their
    slash-joined paths (dict keys, list and tuple positions); ``None``
    subtrees are dropped, as the JAX package drops empty pytree nodes."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_with_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_with_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = _host_array(tree)
    return out


def _write_npz(path: str, flat: dict) -> None:
    flat = dict(flat)
    flat[_LAYOUT_KEY] = np.int64(LAYOUT_VERSION)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        np.savez_compressed(tmp, **flat)
        # np.savez appends .npz when the target lacks it
        written = tmp if os.path.exists(tmp) else tmp + ".npz"
        os.replace(written, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            if os.path.exists(cand):
                os.remove(cand)
        raise


def save_params(path: str, params) -> None:
    """Atomic save of a tree of tensors or arrays in the JAX package's npz
    layout (slash-joined paths plus the layout sentinel): written to a
    sibling temporary file, then renamed, so a crash mid-write leaves the
    previous checkpoint at ``path`` intact."""
    _write_npz(path, flatten_with_paths(params))


class AsyncSaver:
    """Background-thread checkpoint writer (``distmlip_tpu/utils/
    checkpoint.py:64-105``).

    ``save()`` copies the tree to host numpy arrays synchronously (the
    caller may update its tensors in place right after) and hands the
    compression and the write to a worker thread. One write in flight at a
    time: a new ``save()`` joins the previous one first; ``wait()`` joins
    the last and re-raises a writer error."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, params) -> None:
        self.wait()
        flat = flatten_with_paths(params)

        def _write():
            try:
                _write_npz(path, flat)
            except BaseException as e:  # noqa: BLE001 - surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, name="distmlip-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight (if any); re-raise a writer failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _rebuild(template, data: dict, device, prefix: str = ""):
    """``template``'s structure with each leaf read from ``data`` at its
    path, in the leaf's dtype, as a tensor on ``device`` (``None`` leaves
    stay ``None``)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, data, device, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_rebuild(v, data, device, f"{prefix}{i}/") for i, v in enumerate(template)]
        return tuple(seq) if isinstance(template, tuple) else seq
    if template is None:
        return None
    key = prefix[:-1]
    if key not in data:
        raise KeyError(f"checkpoint missing parameter {key!r}")
    arr = data[key]
    t = template if isinstance(template, torch.Tensor) else torch.as_tensor(np.asarray(template))
    if tuple(t.shape) != arr.shape:
        raise ValueError(f"shape mismatch for {key!r}: checkpoint {arr.shape} vs template "
                         f"{tuple(t.shape)}")
    return torch.as_tensor(np.array(arr), device=device).to(t.dtype)


def load_params(path: str, device="cpu", *, like=None, allow_legacy_layout: bool = False):
    """Read a ``save_params`` npz into nested dicts of torch tensors.

    List positions come back as dicts keyed "0", "1", ... (read them with
    ``as_list``). With ``like`` (a template tree) the result has the
    template's structure (lists and tuples as such) and each leaf its
    template leaf's dtype; a missing path or another shape raises. Refuses
    checkpoints from another tensor-layout era (missing or stale
    ``__distmlip_layout_version__``) unless ``allow_legacy_layout=True``.
    """
    with np.load(path, allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    ver = int(data.pop(_LAYOUT_KEY, 0))
    if ver != LAYOUT_VERSION and not allow_legacy_layout:
        raise ValueError(
            f"checkpoint {path!r} has layout version {ver}, this build "
            f"expects {LAYOUT_VERSION} (the channels-last flip changed the "
            f"in-memory flatten order without changing parameter shapes). "
            f"Re-export the checkpoint, or pass allow_legacy_layout=True if "
            f"you know it was saved by this layout era.")
    if like is not None:
        return _rebuild(like, data, device)
    root: dict = {}
    for key, val in data.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return params_from_numpy(root, device)
