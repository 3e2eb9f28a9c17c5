"""Analytic pair potentials (Lennard-Jones, Morse) and the ZBL repulsion.

Port of ``distmlip_tpu/models/pair.py``: fast baselines, test oracles for
the drivers and the batched and serving engines, and the smallest example
of the model contract ``energy_fn(params, lg, positions) -> per-atom
energies``. Each pair appears as two directed edges, so the per-atom energy
is half the dst sum of the edge energies, through ``lg.aggregate_edges``
(the segment-sum kernel on the card). ``zbl_edge_energy`` is the screened
nuclear repulsion MACE adds under its learned potential with ``zbl=True``
(reference mace/models.py:121-128).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import radial

# Covalent radii in Å (Cordero et al. 2008), indexed by atomic number Z;
# index 0 unused. The per-pair ZBL cutoff is r_cov(Zu) + r_cov(Zv).
COVALENT_RADII = np.array([
    0.00,
    0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
    1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76,
    1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,
    1.22, 1.20, 1.19, 1.20, 1.20, 1.16, 2.20, 1.95, 1.90, 1.75,
    1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44, 1.42, 1.39,
    1.39, 1.38, 1.39, 1.40, 2.44, 2.15, 2.07, 2.04, 2.03, 2.01,
    1.99, 1.98, 1.98, 1.96, 1.94, 1.92, 1.92, 1.89, 1.90, 1.87,
    1.87, 1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32,
    1.45, 1.46, 1.48, 1.40, 1.50, 1.50, 2.60, 2.21, 2.15, 2.06,
    2.00, 1.96, 1.90, 1.87, 1.80, 1.69,
])

# ZBL universal screening function coefficients
_ZBL_C = (0.18175, 0.50986, 0.28022, 0.02817)
_ZBL_D = (3.19980, 0.94229, 0.40290, 0.20162)
_COULOMB_EV_ANG = 14.399645  # e^2 / (4 pi eps0) in eV*Å


def zbl_edge_energy(z_u, z_v, d, a_exp=0.300, a_prefactor=0.4543, p: int = 6):
    """ZBL screened nuclear repulsion per directed edge, in eV:
    V(r) = 14.3996 eV Å Zu Zv / r phi(r / a), a = a_prefactor a0 /
    (Zu^a_exp + Zv^a_exp), smoothly cut at r_cov(Zu) + r_cov(Zv) by the
    polynomial envelope."""
    zi_u, zi_v = z_u.long(), z_v.long()
    z_u, z_v = z_u.to(d.dtype), z_v.to(d.dtype)
    a = a_prefactor * 0.529177 / (z_u ** a_exp + z_v ** a_exp)
    x = d / a
    phi = sum(c * torch.exp(-dd * x) for c, dd in zip(_ZBL_C, _ZBL_D))
    v = _COULOMB_EV_ANG * z_u * z_v / torch.clamp(d, min=1e-6) * phi
    cov = torch.as_tensor(COVALENT_RADII, dtype=d.dtype, device=d.device)
    r_max = cov[zi_u] + cov[zi_v]
    env = radial.polynomial_cutoff(d, r_max, p=p) * (d < r_max)
    return v * env


@dataclass(frozen=True)
class PairConfig:
    cutoff: float = 5.0
    kind: str = "lj"  # "lj" | "morse"


class PairPotential:
    def __init__(self, config: PairConfig = PairConfig()):
        if config.kind not in ("lj", "morse"):
            raise ValueError(f"kind {config.kind!r} not in ('lj', 'morse')")
        self.cfg = config

    def init(self, seed=None) -> dict:
        """The JAX package's fixed parameters (``seed`` is ignored)."""
        f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        if self.cfg.kind == "lj":
            return {"eps": f(1.0), "sigma": f(2.2)}
        return {"D": f(1.0), "a": f(1.5), "r0": f(2.2)}

    def energy_fn(self, params, lg, positions):
        vec = lg.edge_vectors(positions)
        d = torch.linalg.norm(torch.where(lg.edge_mask[:, None], vec, torch.ones_like(vec)),
                              dim=-1)
        env = radial.cosine_cutoff(d, self.cfg.cutoff)
        if self.cfg.kind == "lj":
            x = (params["sigma"] / d) ** 6
            e_edge = 4.0 * params["eps"] * (x * x - x)
        else:
            ex = torch.exp(-params["a"] * (d - params["r0"]))
            e_edge = params["D"] * (ex * ex - 2.0 * ex)
        e_edge = torch.where(lg.edge_mask, e_edge * env, torch.zeros_like(e_edge))
        # half: every pair appears as two directed edges
        return 0.5 * lg.aggregate_edges(e_edge[:, None])[:, 0]
