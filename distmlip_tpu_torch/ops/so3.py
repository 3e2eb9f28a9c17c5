"""SO(3) machinery: real spherical harmonics and real coupling tensors.

Torch port of ``distmlip_tpu/ops/so3.py``. Real spherical harmonics with
component normalization (||Y_l||^2 = 2l+1) — hardcoded e3nn-convention
tables for l <= 3, a Cartesian-recurrence construction for any higher l —
evaluated in torch on the model's device, plus the host-side (numpy,
float64) real-basis Clebsch-Gordan tensors and MACE's symmetric coupling
(U) bases, copied verbatim from the JAX package so both build the same
tensors.

The U bases are null-space bases found by SVD; another LAPACK could return
a different but equally valid orthonormal basis, and then weights carried
over from the JAX package would no longer mean the same thing. So this
package ships its own copy of the JAX package's tracked ``_u_cache/*.npy``
files next to this module and reads only from there.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


class _NumpyOps:
    stack = staticmethod(lambda xs: np.stack(xs, axis=-1))
    ones_like = staticmethod(np.ones_like)
    zeros_like = staticmethod(np.zeros_like)


class _TorchOps:
    @staticmethod
    def stack(xs):
        import torch

        return torch.stack(xs, dim=-1)

    @staticmethod
    def ones_like(x):
        import torch

        return torch.ones_like(x)

    @staticmethod
    def zeros_like(x):
        import torch

        return torch.zeros_like(x)


# ---------------------------------------------------------------------------
# Real spherical harmonics (component normalization), l = 0..3.
# Input: unit vectors (..., 3) ordered (x, y, z). Output: (..., 2l+1), m from
# -l..l in e3nn order.
# ---------------------------------------------------------------------------

def _sh_impl(l: int, u, xp):
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    if l == 0:
        return xp.ones_like(u[..., :1])
    if l == 1:
        s3 = float(np.sqrt(3.0))
        return xp.stack([s3 * x, s3 * y, s3 * z])
    if l == 2:
        s15, s5 = float(np.sqrt(15.0)), float(np.sqrt(5.0))
        return xp.stack(
            [
                s15 * x * y,
                s15 * y * z,
                s5 / 2.0 * (3.0 * z * z - 1.0),
                s15 * x * z,
                s15 / 2.0 * (x * x - y * y),
            ]
        )
    if l == 3:
        s = lambda v: float(np.sqrt(v))
        return xp.stack(
            [
                s(35.0 / 8.0) * y * (3 * x * x - y * y),
                s(105.0) * x * y * z,
                s(21.0 / 8.0) * y * (5 * z * z - 1.0),
                s(7.0) / 2.0 * z * (5 * z * z - 3.0),
                s(21.0 / 8.0) * x * (5 * z * z - 1.0),
                s(105.0) / 2.0 * z * (x * x - y * y),
                s(35.0 / 8.0) * x * (x * x - 3 * y * y),
            ]
        )
    return _sh_general(l, u, xp)


def _sh_general(l: int, u, xp):
    """Real spherical harmonics for any l via Cartesian recurrences.

    Basis convention per l is independent (the coupling tensors are built
    from THESE functions, so the stack stays self-consistent); l <= 3 keeps
    the hardcoded e3nn-convention tables above.

    Construction (all polynomial in x, y, z — smooth at the poles):
      A_m + i B_m = (x + i y)^m;  Pi_l^m(z) = P_l^m with (1-z^2)^{m/2}
      removed; Y_{l, +-m} = N_{l,m} Pi_l^m(z) {A_m, B_m}; component
      normalization E[|Y_lm|^2] = 1 over the sphere.
    """
    from math import factorial

    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    A = [xp.ones_like(x)]
    B = [xp.zeros_like(x)]
    for m in range(1, l + 1):
        A.append(A[m - 1] * x - B[m - 1] * y)
        B.append(A[m - 1] * y + B[m - 1] * x)

    # Pi_l^m(z): stable upward recurrence
    Pi = {}
    for m in range(0, l + 1):
        dfact = 1.0
        for k in range(1, 2 * m, 2):
            dfact *= k
        Pi[(m, m)] = dfact * xp.ones_like(x)
        if l >= m + 1:
            Pi[(m + 1, m)] = z * (2 * m + 1) * Pi[(m, m)]
        for ll in range(m + 2, l + 1):
            Pi[(ll, m)] = (
                (2 * ll - 1) * z * Pi[(ll - 1, m)] - (ll + m - 1) * Pi[(ll - 2, m)]
            ) / (ll - m)

    comps = []
    for m in range(-l, l + 1):
        am = abs(m)
        norm = float(
            np.sqrt((2 * l + 1) * factorial(l - am) / factorial(l + am))
            * (np.sqrt(2.0) if am > 0 else 1.0)
        )
        if m < 0:
            comps.append(norm * Pi[(l, am)] * B[am])
        elif m == 0:
            comps.append(norm * Pi[(l, 0)])
        else:
            comps.append(norm * Pi[(l, am)] * A[am])
    return xp.stack(comps)


def spherical_harmonics(l: int, u):
    """Device (torch) real spherical harmonics of unit vectors."""
    return _sh_impl(l, u, _TorchOps)


def spherical_harmonics_np(l: int, u: np.ndarray) -> np.ndarray:
    """Host (numpy, float64) variant — used to build coupling tensors."""
    return _sh_impl(l, np.asarray(u, dtype=np.float64), _NumpyOps)


# ---------------------------------------------------------------------------
# Real Wigner matrices and coupling tensors (host-side, float64, cached).
# ---------------------------------------------------------------------------

def wigner_d_from_rotation(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner matrix with Y_l(R u) = D_l(R) Y_l(u), by least squares."""
    rng = np.random.default_rng(12345)
    pts = rng.normal(size=(max(64, 4 * (2 * l + 1)), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    Y = spherical_harmonics_np(l, pts)
    Yr = spherical_harmonics_np(l, pts @ np.asarray(R, dtype=np.float64).T)
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    return D.T


def _random_rotation(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@lru_cache(maxsize=None)
def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real-basis coupling tensor C (2l1+1, 2l2+1, 2l3+1), or None if the
    triangle inequality fails.

    Unique invariant of D_l1 x D_l2 x D_l3 (multiplicity one for SO(3)),
    found as the null space of stacked (D1xD2xD3 - I) constraints over
    random rotations. Normalized to sum(C^2) = 2*l3+1 so that coupling two
    component-normalized inputs stays component-normalized; sign fixed by
    making the first significant entry positive.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    d = d1 * d2 * d3
    rng = np.random.default_rng(2024)
    rows = []
    for _ in range(4):
        R = _random_rotation(rng)
        D = np.einsum(
            "xa,yb,zc->xyzabc",
            wigner_d_from_rotation(l1, R),
            wigner_d_from_rotation(l2, R),
            wigner_d_from_rotation(l3, R),
        )
        rows.append(D.reshape(d, d) - np.eye(d))
    A = np.vstack(rows)
    _, s, Vt = np.linalg.svd(A, full_matrices=False)
    # multiplicity-one: exactly one near-zero singular value
    if s[-1] > 1e-6 or (len(s) > 1 and s[-2] < 1e-4):
        raise RuntimeError(
            f"coupling ({l1},{l2},{l3}): unexpected invariant multiplicity "
            f"(smallest singular values {s[-3:]})"
        )
    C = Vt[-1].reshape(d1, d2, d3)
    # deterministic sign: first entry with |.| > 0.1*max is positive
    flat = C.ravel()
    idx = np.argmax(np.abs(flat) > 0.1 * np.abs(flat).max())
    if flat[idx] < 0:
        C = -C
    C = C * np.sqrt(d3) / np.sqrt((C**2).sum())
    return np.ascontiguousarray(C)


@lru_cache(maxsize=None)
def symmetric_coupling_basis(a_ls: tuple, l_out: int, nu: int):
    """Orthonormal basis of O(3)-equivariant, totally symmetric maps
    Sym^nu(V_A) -> V_{l_out}, with V_A = ⊕_{l in a_ls} R^{2l+1} (SH parity).

    This is the function space MACE's U-matrix symmetric contraction spans
    (reference wraps it via e3nn in ScaleShiftMACE, mace/models.py:45-220):
    the ACE product basis at correlation ``nu``. Returns U of shape
    (S_A,)*nu + (2*l_out+1, n_paths) with orthonormal path columns (full
    tensor-space inner product), or None when the space is empty. Any two
    complete orthonormal bases of this space differ only by an orthogonal
    path mixing, so upstream U-basis weights can be converted exactly with
    a change-of-basis solve against the upstream U tensors.

    Construction: parametrize symmetric tensors by monomial multi-indices,
    build the rotation action in that basis, and take the joint null space
    of (D_sym ⊗ D_out - I) over random rotations PLUS the inversion -I
    (imposing e3nn's parity selection: paths with odd total l vanish).
    """
    a_ls = tuple(a_ls)
    # disk cache next to this module (the analogue of the reference shipping
    # precomputed Wigner tables, uma/Jd.pt): the (0..3, nu=3) bases take ~1
    # min to build and are needed by every fresh process
    import os

    cache_dir = os.path.join(os.path.dirname(__file__), "_u_cache")
    # v1 tags the construction algorithm (rng seed, tolerances, parity and
    # ordering conventions); bump it on ANY change to this function so stale
    # caches can never be served for a different basis
    cache_key = os.path.join(
        cache_dir, f"U_v1_{'-'.join(map(str, a_ls))}_{l_out}_{nu}.npy"
    )
    if os.path.exists(cache_key):
        try:
            arr = np.load(cache_key)
            return None if arr.size == 0 else arr
        except Exception:  # truncated/corrupt cache: rebuild below
            pass

    def _store(arr):
        try:
            os.makedirs(cache_dir, exist_ok=True)
            # tmp must end in .npy or np.save appends the suffix itself
            tmp = cache_key + f".tmp{os.getpid()}.npy"
            np.save(tmp, arr if arr is not None else np.zeros(0))
            os.replace(tmp, cache_key)  # atomic: concurrent writers race safely
        except OSError:  # read-only installs: stay in-memory (lru_cache)
            pass
        return arr

    S_A = sum(2 * l + 1 for l in a_ls)
    d_out = 2 * l_out + 1
    if S_A**nu > 50_000:
        # the construction materializes dense (S_A^nu)^2 Kronecker rotation
        # matrices; beyond this the host-side cost explodes
        raise ValueError(
            f"symmetric_coupling_basis: S_A^nu = {S_A}^{nu} too large; "
            f"reduce a_lmax or correlation"
        )
    lvals = np.concatenate([[l] * (2 * l + 1) for l in a_ls]).astype(int)

    from itertools import combinations_with_replacement, permutations

    idxs = list(combinations_with_replacement(range(S_A), nu))
    dim_sym = len(idxs)
    full = S_A**nu

    # embedding S: sym basis -> full tensor space (orthonormal columns)
    S = np.zeros((full, dim_sym))
    strides = np.array([S_A ** (nu - 1 - i) for i in range(nu)])
    for a, alpha in enumerate(idxs):
        perms = set(permutations(alpha))
        w = 1.0 / np.sqrt(len(perms))
        for p in perms:
            S[int(np.dot(p, strides)), a] = w

    def d_full(R):
        D_blocks = [wigner_d_from_rotation(l, R) for l in a_ls]
        D = np.zeros((S_A, S_A))
        o = 0
        for l, Db in zip(a_ls, D_blocks):
            D[o : o + 2 * l + 1, o : o + 2 * l + 1] = Db
            o += 2 * l + 1
        out = D
        for _ in range(nu - 1):
            out = np.kron(out, D)
        return out

    rng = np.random.default_rng(7041)
    rows = []
    dim_c = dim_sym * d_out
    for k in range(3):
        R = _random_rotation(rng)
        D_sym = S.T @ d_full(R) @ S
        D_out = wigner_d_from_rotation(l_out, R)
        rows.append(np.kron(D_sym, D_out) - np.eye(dim_c))
    # inversion: D_l(-I) = (-1)^l per block -> parity selection
    par_sym = S.T @ np.diag(
        np.asarray(
            [(-1.0) ** lvals.take(np.unravel_index(i, (S_A,) * nu)).sum()
             for i in range(full)]
        )
    ) @ S
    rows.append(np.kron(par_sym, np.eye(d_out) * (-1.0) ** l_out) - np.eye(dim_c))
    A = np.vstack(rows)
    _, s, Vt = np.linalg.svd(A, full_matrices=True)
    n_paths = int(np.sum(s < 1e-8))
    if n_paths == 0:
        return _store(None)
    null = Vt[-n_paths:]  # rows of Vt for (near-)zero singular values
    # guard the spectral gap so the path count is unambiguous
    if n_paths < dim_c and s[dim_c - n_paths - 1] < 1e-5:
        raise RuntimeError(
            f"symmetric basis ({a_ls}, l_out={l_out}, nu={nu}): borderline "
            f"singular value {s[dim_c - n_paths - 1]:.2e}"
        )
    U = (S @ null.reshape(n_paths, dim_sym, d_out).transpose(1, 2, 0).reshape(
        dim_sym, -1)).reshape((S_A,) * nu + (d_out, n_paths))
    return _store(np.ascontiguousarray(U))
