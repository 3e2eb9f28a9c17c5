"""Minimal neural-net building blocks on plain parameter trees.

Models are functions over nested-dict parameter trees of tensors (the JAX
package's pytree layout, so weights carry across by path): ``linear``,
``mlp``, ``gated_mlp``, ``layernorm``, ``embedding``, ``gather_rows`` and
``cast_params_subtrees`` match ``distmlip_tpu/ops/nn.py:36,48-61,100,
110-158``. The init helpers draw from a ``torch.Generator`` so a seed fixes
the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.checkpoint import as_list
from .segment import _HALF_DTYPES


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp(p, x, act=F.silu, final_act=None):
    """Layers ``p`` (a list, or a loaded checkpoint's dict keyed "0", "1",
    ...) with ``act`` between them and ``final_act`` after the last."""
    p = as_list(p)
    for i, layer in enumerate(p):
        x = linear(layer, x)
        if i < len(p) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def linear_init(gen, d_in: int, d_out: int, bias: bool = True):
    """Torch-style default init: W, b ~ U(-1/sqrt(d_in), 1/sqrt(d_in))."""
    lim = 1.0 / math.sqrt(d_in)
    p = {"w": (torch.rand((d_in, d_out), generator=gen) * 2 - 1) * lim}
    if bias:
        p["b"] = (torch.rand((d_out,), generator=gen) * 2 - 1) * lim
    return p


def linear_init_vp(gen, d_in: int, d_out: int):
    """Variance-preserving linear init (e3nn convention): W ~ N(0, 1/d_in)."""
    return {"w": torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)}


_SILU_GAIN = None


def silu_2mom_gain() -> float:
    """e3nn's normalize2mom(silu) constant: 1 / sqrt(E[silu(x)^2]), x~N(0,1),
    by Gauss-Hermite quadrature."""
    global _SILU_GAIN
    if _SILU_GAIN is None:
        x, w = np.polynomial.hermite_e.hermegauss(201)
        silu = x / (1.0 + np.exp(-x))
        _SILU_GAIN = float(1.0 / np.sqrt(np.sum(w * silu**2) / np.sum(w)))
    return _SILU_GAIN


def mlp_init_vp(gen, dims: list[int]):
    """Bias-free variance-preserving MLP init (e3nn FullyConnectedNet
    convention): W ~ N(0, g^2/d_in), g = silu_2mom_gain on layers fed by an
    activation."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        g = silu_2mom_gain() if i > 0 else 1.0
        out.append({"w": torch.randn((a, b), generator=gen) * (g / math.sqrt(a))})
    return out


def mlp_init(gen, dims: list[int], bias: bool = True):
    return [linear_init(gen, a, b, bias=bias) for a, b in zip(dims[:-1], dims[1:])]


def gated_mlp_init(gen, d_in: int, dims: list[int]):
    """CHGNet-style gated MLP: core MLP * sigmoid(gate MLP)."""
    return {"core": mlp_init(gen, [d_in] + dims), "gate": mlp_init(gen, [d_in] + dims)}


def gated_mlp(p, x, act=F.silu):
    """``silu``-activated core MLP (its last layer too) times the gate MLP
    (``sigmoid`` on its last layer)."""
    return gated_mlp_flat(x, gated_mlp_weights(p), act)


def gated_mlp_weights(p) -> tuple:
    """The gated MLP's tensors as one flat tuple: the core layers' ``(w,
    b)`` pairs in order, then the gate's. The form in which the fused edge
    aggregations take weights (``gated_mlp_flat``)."""
    return tuple(t for half in ("core", "gate") for layer in as_list(p[half])
                 for t in (layer["w"], layer["b"]))


def gated_mlp_flat(x, weights, act=F.silu):
    """The gated MLP on the flat tuple of ``gated_mlp_weights``."""
    half = len(weights) // 2

    def run(ws, final_act):
        h = x
        for i in range(0, len(ws), 2):
            h = h @ ws[i] + ws[i + 1]
            h = act(h) if i + 2 < len(ws) else final_act(h)
        return h

    return run(weights[:half], act) * run(weights[half:], torch.sigmoid)


def layernorm_init(dim: int):
    return {"g": torch.ones((dim,)), "b": torch.zeros((dim,))}


def layernorm(p, x, eps: float = 1e-5):
    """``distmlip_tpu/ops/nn.py:129``: the population variance, as
    ``jnp.var`` (``unbiased=False``, not ``torch.var``'s default)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def cast_params_subtrees(params: dict, dtype, keep_fp32: tuple = ()) -> dict:
    """The floating leaves of a parameter dict cast to ``dtype``, the named
    top-level subtrees left as they are (precision-critical pieces such as
    species reference energies and readout heads). The bfloat16 compute
    switch of the models; the tree's own leaves are not changed."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(dtype)
        return tree

    return {k: (v if k in keep_fp32 else cast(v)) for k, v in params.items()}


class _HalfGather(torch.autograd.Function):
    """Rows of a half-precision table whose gradient accumulates in fp32:
    the forward gather is exact in the table's dtype; the backward
    scatter-adds the cotangent rows in fp32 and rounds once to the table's
    dtype (a half-precision scatter-add would round at every contribution).
    The backward is differentiable torch ops, so a double backward works."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = g.new_zeros((ctx.n,) + tuple(g.shape[1:]), dtype=torch.float32)
        return acc.index_add(0, idx, g.float()).to(g.dtype), None


def gather_rows(table, idx):
    """Rows ``idx`` of ``table`` (``distmlip_tpu/ops/nn.py:140-154``). A
    half-precision table's gradient accumulates in fp32 and rounds once,
    as the JAX package's gather through an fp32 view does; the forward
    values are the same bits either way."""
    if table.dtype in _HALF_DTYPES:
        return _HalfGather.apply(table, idx)
    return table.index_select(0, idx)


def embedding(p, idx):
    return gather_rows(p["w"], idx)
