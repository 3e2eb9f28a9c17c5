"""Radial basis functions and cutoff envelopes (torch, differentiable).

The MACE pair: ``spherical_bessel_basis`` and ``polynomial_cutoff``
(``distmlip_tpu/ops/radial.py:25,106``). Both are smooth at the cutoff so
forces stay continuous.
"""

from __future__ import annotations

import math

import torch


def spherical_bessel_basis(d, cutoff: float, num_basis: int):
    """Normalized j0 Bessel basis: sqrt(2/rc) * sin(n pi d / rc) / d.

    Safe at d=0 (returns the n*pi/rc limit).
    """
    n = torch.arange(1, num_basis + 1, dtype=d.dtype, device=d.device)
    rc = float(cutoff)
    x = d[..., None]
    arg = n * math.pi * x / rc
    small = x < 1e-8
    safe_x = torch.where(small, torch.ones_like(x), x)
    out = math.sqrt(2.0 / rc) * torch.sin(arg) / safe_x
    limit = math.sqrt(2.0 / rc) * n * math.pi / rc
    return torch.where(small, limit, out)


def polynomial_cutoff(d, cutoff: float, p: int = 6):
    """MACE-style polynomial envelope: 1 at 0, C^2-smooth 0 at cutoff."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    c1 = -(p + 1.0) * (p + 2.0) / 2.0
    c2 = p * (p + 2.0)
    c3 = -p * (p + 1.0) / 2.0
    return 1.0 + c1 * x**p + c2 * x ** (p + 1) + c3 * x ** (p + 2)
