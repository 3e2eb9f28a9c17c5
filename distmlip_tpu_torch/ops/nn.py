"""Minimal neural-net building blocks on plain parameter trees.

Models are functions over nested-dict parameter trees of tensors (the JAX
package's pytree layout, so weights carry across by path): ``linear`` and
``mlp`` match ``distmlip_tpu/ops/nn.py:36,100``. The init helpers draw from
a ``torch.Generator`` so a seed fixes the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp(p, x, act=F.silu, final_act=None):
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
