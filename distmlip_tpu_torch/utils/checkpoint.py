"""Parameters across the two packages: numpy trees and npz checkpoints.

The JAX package's parameters are nested dicts and lists of arrays
(``jax.tree.map(np.asarray, params)`` gives numpy leaves), saved by
``distmlip_tpu/utils/checkpoint.py:44`` ``save_params`` as an npz with
slash-joined tree paths plus a layout-era sentinel. This module turns
either into the port's tree of torch tensors with the same paths, so a
model reads ``params["interactions"][t]["lin_up"]["0"]["w"]`` in both.
"""

from __future__ import annotations

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


def load_params(path: str, device="cpu", *, allow_legacy_layout: bool = False):
    """Read a ``save_params`` npz into nested dicts of torch tensors.

    List positions come back as dicts keyed "0", "1", ... (read them with
    ``as_list``). Refuses checkpoints from another tensor-layout era
    (missing or stale ``__distmlip_layout_version__``) unless
    ``allow_legacy_layout=True``.
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
    root: dict = {}
    for key, val in data.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return params_from_numpy(root, device)
