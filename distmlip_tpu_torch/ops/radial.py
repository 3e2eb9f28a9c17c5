"""Radial basis functions and cutoff envelopes (torch, differentiable).

``spherical_bessel_basis``, ``polynomial_cutoff`` (MACE),
``cosine_cutoff`` (TensorNet) and matgl's CHGNet bases ``radial_bessel``,
``matgl_fourier_expansion`` and ``matgl_polynomial_cutoff``, as
``distmlip_tpu/ops/radial.py:25,52,70,88,106,116``.
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


def radial_bessel(d, frequencies, cutoff: float):
    """matgl ``RadialBesselFunction``: sqrt(2/rc) * sin(freq * d/rc) / d with
    learnable (R,) ``frequencies``. Safe at d=0 (returns the freq/rc limit)."""
    rc = float(cutoff)
    f = frequencies.to(d.dtype)
    x = d[..., None]
    small = x < 1e-8
    safe_x = torch.where(small, torch.ones_like(x), x)
    out = math.sqrt(2.0 / rc) * torch.sin(f * safe_x / rc) / safe_x
    limit = math.sqrt(2.0 / rc) * f / rc
    return torch.where(small, limit, out)


def matgl_fourier_expansion(x, frequencies, interval: float = math.pi):
    """matgl ``FourierExpansion``: interleaved [cos(0x), sin(1x), cos(1x),
    sin(2x), cos(2x), ...] / interval, with learnable frequencies 0..max_f.
    x: (...,) -> (..., 2*max_f + 1), the layout converted weights expect."""
    f = frequencies.to(x.dtype)
    arg = x[..., None] * f * (math.pi / interval)
    cos = torch.cos(arg)                  # (..., max_f + 1)
    sin = torch.sin(arg[..., 1:])         # (..., max_f)
    out = torch.stack([cos[..., :-1], sin], dim=-1).flatten(-2)
    return torch.cat([out, cos[..., -1:]], dim=-1) / interval


def matgl_polynomial_cutoff(r, cutoff: float, p: int = 5):
    """matgl ``polynomial_cutoff``: the envelope polynomial on the raw ratio
    (no lower clamp) and hard-zeroed above the cutoff. CHGNet applies it to
    the bessel expansion VALUES, which can be negative, so no clamp."""
    x = r / cutoff
    p = int(p)
    c1 = -(p + 1.0) * (p + 2.0) / 2.0
    c2 = p * (p + 2.0)
    c3 = -p * (p + 1.0) / 2.0
    poly = 1.0 + c1 * x**p + c2 * x ** (p + 1) + c3 * x ** (p + 2)
    return torch.where(r <= cutoff, poly, torch.zeros((), dtype=r.dtype, device=r.device))


def polynomial_cutoff(d, cutoff: float, p: int = 6):
    """MACE-style polynomial envelope: 1 at 0, C^2-smooth 0 at cutoff."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    c1 = -(p + 1.0) * (p + 2.0) / 2.0
    c2 = p * (p + 2.0)
    c3 = -p * (p + 1.0) / 2.0
    return 1.0 + c1 * x**p + c2 * x ** (p + 1) + c3 * x ** (p + 2)


def cosine_cutoff(d, cutoff: float):
    """0.5 (cos(pi d / rc) + 1), zero beyond the cutoff."""
    return torch.where(d < cutoff, 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0),
                       torch.zeros((), dtype=d.dtype, device=d.device))
