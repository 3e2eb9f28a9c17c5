"""e3nn-convention real-SH rotations: the edge-frame Wigner pipeline of eSCN.

Torch port of ``distmlip_tpu/ops/so3_e3nn.py``. Per-edge Wigner matrices
are built as ``X(alpha) J X(beta) J`` from per-l ``Jd`` tables, in e3nn's
real-spherical-harmonic basis (y is the polar axis; within a degree-l block
the 2l+1 components are ordered m = -l..l with the m=0, y-aligned component
at the center).

The host tables are this package's own: ``jd_np`` is solved by numpy least
squares against the port's ``ops/so3._sh_general`` evaluated in the e3nn
axis convention, exactly as the JAX package derives its copy, so the two
agree to float64 roundoff (``tests/test_torch_so3_e3nn.py``).

Angle convention (e3nn YXY): a unit vector u has beta = acos(u_y),
alpha = atan2(u_x, u_z); R(alpha, beta, 0) maps the polar axis y-hat onto
u, and its Wigner matrix D satisfies Y(R r) = D Y(r). So D rotates
edge-frame coefficients to the lab frame and its transpose rotates lab
features into the edge-aligned frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .so3 import _NumpyOps, _sh_general


def sh_e3nn_np(l: int, r: np.ndarray) -> np.ndarray:
    """e3nn-convention real spherical harmonics (host, float64)."""
    r = np.asarray(r, dtype=np.float64)
    return _sh_general(l, r[..., [2, 0, 1]], _NumpyOps)


def _wigner_of_orthogonal_np(l: int, O: np.ndarray) -> np.ndarray:
    """D with Y(O r) = D Y(r) in the e3nn basis, by least squares."""
    rng = np.random.default_rng(12345)
    pts = rng.normal(size=(max(64, 4 * (2 * l + 1)), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    Y = sh_e3nn_np(l, pts)
    Yo = sh_e3nn_np(l, pts @ np.asarray(O, dtype=np.float64).T)
    D, *_ = np.linalg.lstsq(Y, Yo, rcond=None)
    return D.T


# the orthogonal map whose per-l representation is the "Jd" table:
# (x, y, z) -> (-y, -x, z), the reflection swapping the alpha/gamma
# z-rotation axis (y) with the beta axis, so J X_z(beta) J = X_x(beta)
_O_J = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


@functools.lru_cache(maxsize=None)
def jd_np(l: int) -> np.ndarray:
    """Derived per-l J table (an involution)."""
    return _wigner_of_orthogonal_np(l, _O_J)


@functools.lru_cache(maxsize=None)
def _jd_tensor(l: int, dtype, device):
    """``jd_np(l)`` on ``device``, made once: a host copy per call would
    synchronise the host with the card at every chunk."""
    return torch.as_tensor(jd_np(l), dtype=dtype, device=device)


def z_rot_np(l: int, angles: np.ndarray) -> np.ndarray:
    """Batched z-rotation (about e3nn's polar axis y) Wigner blocks, host.

    Frequencies run l..-l along the diagonal; sin terms sit on the
    antidiagonal. The diagonal is written last so the center element is
    cos(0) = 1, not sin(0).
    """
    angles = np.asarray(angles, dtype=np.float64)
    K = 2 * l + 1
    f = np.arange(l, -l - 1, -1.0)
    M = np.zeros(angles.shape + (K, K))
    i = np.arange(K)
    M[..., i, K - 1 - i] = np.sin(f * angles[..., None])
    M[..., i, i] = np.cos(f * angles[..., None])
    return M


def _z_rot(l: int, angles):
    """``z_rot_np`` in torch, differentiable in ``angles``: the antidiagonal
    sines plus the diagonal cosines, the center taking the cosine only."""
    K = 2 * l + 1
    f = torch.arange(l, -l - 1, -1, dtype=angles.dtype, device=angles.device)
    arg = f * angles[..., None]
    eye = torch.eye(K, dtype=angles.dtype, device=angles.device)
    anti = eye.flip(-1) * (1.0 - eye)  # the antidiagonal without the center
    return torch.cos(arg)[..., None] * eye + torch.sin(arg)[..., None] * anti


def edge_angles(rhat, eps: float = 1e-4):
    """e3nn (alpha, beta) of unit vectors, gradient-safe at the poles.

    At u = +-y-hat the azimuth is a pure gauge freedom, but atan2's gradient
    at (0, 0) is NaN and arccos's at +-1 is infinite. Within ~eps of the
    pole the angle arguments are replaced by constants (alpha := 0,
    |cos beta| clipped to just below 1): values are off by O(eps) only
    there, gradients flow zero through the substituted branch, and
    everywhere else the computation is exact.
    """
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    rho2 = x * x + z * z
    safe = rho2 > (eps * eps)
    alpha = torch.atan2(torch.where(safe, x, torch.zeros_like(x)),
                        torch.where(safe, z, torch.ones_like(z)))
    # the clip limit must be STRICTLY below 1 in the working dtype: in
    # float32, 1 - eps^2/2 rounds to exactly 1.0 and arccos'(1) = -inf would
    # still NaN pole-aligned edges; nextafter keeps it >= 1 ulp below
    npdt = np.dtype(str(rhat.dtype).replace("torch.", ""))
    y_lim = float(np.nextafter(npdt.type(1.0 - eps * eps / 2), npdt.type(0.0)))
    beta = torch.arccos(torch.clamp(y, -y_lim, y_lim))
    return alpha, beta


def wigner_blocks_from_edges(l_max: int, rhat, gamma=None):
    """Per-l lab-from-edge Wigner blocks for a batch of edge directions.

    Returns ``[D_0, ..., D_lmax]`` with ``D_l``: (E, 2l+1, 2l+1), built in
    at least float32 whatever ``rhat``'s dtype (the trig chains compound).
    ``D_l @ f_edge`` rotates edge-frame coefficients to the lab frame;
    ``D_l.T @ f_lab`` rotates into the edge frame.

    ``gamma`` (default None, meaning 0) is the per-edge gauge angle, the
    residual rotation about the edge axis: D(alpha, beta, gamma) = X(alpha)
    J X(beta) J X(gamma) (``distmlip_tpu/ops/so3_e3nn.py:125-157``). The
    models fix it at 0: the SO(2) convolutions are exactly gauge-covariant,
    so any gauge gives the same model output (``tests/test_torch_escn_md.py``
    holds that under random and fairchem-style per-edge angles).
    """
    wdt = torch.promote_types(rhat.dtype, torch.float32)
    alpha, beta = edge_angles(rhat.to(wdt))
    out = []
    for l in range(l_max + 1):
        J = _jd_tensor(l, wdt, rhat.device)
        Xa = _z_rot(l, alpha)
        Xb = _z_rot(l, beta)
        D = Xa @ J @ Xb @ J
        if gamma is not None:
            D = D @ _z_rot(l, torch.as_tensor(gamma, dtype=wdt, device=rhat.device))
        out.append(D)
    return out


# ---------------------------------------------------------------------------
# Coefficient layout (lmax, mmax narrowing): fairchem's CoefficientMapping
# ---------------------------------------------------------------------------


class CoeffLayout:
    """Index bookkeeping for (l <= lmax, |m| <= min(l, mmax)) coefficients.

    The narrowed coefficient stack is l-major: for each l, the CENTER
    2*min(l, mmax)+1 rows of the (2l+1) e3nn block, order m = -mm..mm.
    ``plus_idx[m] / minus_idx[m]`` give, for each |m|, the narrowed-stack
    positions of the (l, +m) and (l, -m) coefficients over l = m..lmax:
    the (cos, sin) pairs the SO(2) convolutions mix.
    """

    def __init__(self, l_max: int, m_max: int | None = None):
        self.l_max = l_max
        self.m_max = l_max if m_max is None else min(m_max, l_max)
        self.block_slices = []
        self.size = 0
        for l in range(l_max + 1):
            mm = min(l, self.m_max)
            self.block_slices.append(slice(self.size, self.size + 2 * mm + 1))
            self.size += 2 * mm + 1
        self.plus_idx, self.minus_idx = {}, {}
        for m in range(self.m_max + 1):
            plus, minus = [], []
            for l in range(m, l_max + 1):
                mm = min(l, self.m_max)
                base = self.block_slices[l].start
                plus.append(base + mm + m)    # center + m
                minus.append(base + mm - m)   # center - m
            self.plus_idx[m] = np.array(plus)
            self.minus_idx[m] = np.array(minus)

    def m_size(self, m: int) -> int:
        return self.l_max + 1 - m

    def block_rows(self, l: int) -> slice:
        """Rows of the full (2l+1) e3nn block kept after mmax narrowing."""
        mm = min(l, self.m_max)
        return slice(l - mm, l + mm + 1)
