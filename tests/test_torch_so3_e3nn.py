"""The port's e3nn-convention rotation core against the JAX package's.

``distmlip_tpu_torch/ops/so3_e3nn.py`` keeps its own copy of the host
tables (J tables solved by least squares on the port's own spherical
harmonics, the coefficient layout) and builds the per-edge Wigner blocks
in torch. Inputs are made with numpy from a seed and fed to both.

Tolerances: the J tables are float64 least-squares solutions of the same
system, equal to 1e-12. The Wigner blocks are built in float32 from the
same angles in a different order of products: 1e-6. Exactly pole-aligned
and near-pole edges take the gradient-safe branch on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distmlip_tpu.ops import so3_e3nn as J
from distmlip_tpu_torch.ops import so3_e3nn as T
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("l", range(7))
def test_jd_tables_equal_the_jax_package(l):
    np.testing.assert_allclose(T.jd_np(l), J.jd_np(l), rtol=0, atol=1e-12)
    # an involution, as the J of a reflection must be
    np.testing.assert_allclose(T.jd_np(l) @ T.jd_np(l), np.eye(2 * l + 1), atol=1e-10)


def test_host_harmonics_and_z_rotations_equal_the_jax_package():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 3))
    angles = rng.uniform(-np.pi, np.pi, 11)
    for l in range(7):
        np.testing.assert_allclose(T.sh_e3nn_np(l, pts), J.sh_e3nn_np(l, pts),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(T.z_rot_np(l, angles), J.z_rot_np(l, angles),
                                   rtol=0, atol=1e-15)
        got = T._z_rot(l, torch.from_numpy(angles)).numpy()
        np.testing.assert_allclose(got, np.asarray(J._z_rot_jnp(l, jnp.asarray(angles))),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("l_max,m_max", [(0, None), (2, None), (4, None), (6, None),
                                         (4, 2), (6, 1)])
def test_coeff_layout_equals_the_jax_package(l_max, m_max):
    a, b = T.CoeffLayout(l_max, m_max), J.CoeffLayout(l_max, m_max)
    assert (a.size, a.m_max, a.block_slices) == (b.size, b.m_max, b.block_slices)
    assert a.plus_idx.keys() == b.plus_idx.keys()
    for m in a.plus_idx:
        np.testing.assert_array_equal(a.plus_idx[m], b.plus_idx[m])
        np.testing.assert_array_equal(a.minus_idx[m], b.minus_idx[m])
        assert a.m_size(m) == b.m_size(m)
    for l in range(l_max + 1):
        assert a.block_rows(l) == b.block_rows(l)


def _directions():
    rng = np.random.default_rng(11)
    rand = rng.normal(size=(64, 3))
    rand /= np.linalg.norm(rand, axis=1, keepdims=True)
    poles = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    tilt = 3e-5  # inside the pole window (rho < eps = 1e-4)
    near = np.array([[tilt, 1.0, 0.0], [0.0, -1.0, tilt], [-tilt, 1.0, tilt],
                     [2e-4, 1.0, 0.0], [0.0, -1.0, 5e-4]])
    near /= np.linalg.norm(near, axis=1, keepdims=True)
    return {"random": rand, "poles": poles, "near_poles": near}


@pytest.mark.parametrize("which", ["random", "poles", "near_poles"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wigner_blocks_match_the_jax_package(which, dtype):
    """float32 at the slice's l_max 4 within 1e-6; float64 through l_max 6
    within 1e-12. (In float32 the two packages' arccos/atan2 already differ
    by an ulp, 2.4e-7, and at l = 5, 6 the chained 13 x 13 products of
    cos(l alpha) carry that to ~1.8e-6 on either side of the float64
    value; the float64 lane holds the same pipeline exactly there.)"""
    u = _directions()[which].astype(dtype)
    l_max = 4 if dtype == np.float32 else 6
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        want = [np.asarray(d) for d in J.wigner_blocks_from_edges(l_max, jnp.asarray(u))]
    finally:
        jax.config.update("jax_enable_x64", False)
    got = T.wigner_blocks_from_edges(l_max, torch.from_numpy(u))
    for l, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 if dtype == np.float32 else 1e-12)
        # orthogonal blocks: D D^T = 1
        eye = np.broadcast_to(np.eye(2 * l + 1), w.shape)
        np.testing.assert_allclose(g.numpy() @ np.swapaxes(g.numpy(), 1, 2), eye,
                                   atol=1e-5)


def test_wigner_blocks_rotate_harmonics():
    """D(u) maps the edge-frame harmonics of y-hat onto the lab frame's:
    Y(u) = D(u) Y(y-hat), off the poles."""
    u = _directions()["random"]
    D = T.wigner_blocks_from_edges(6, torch.from_numpy(u))
    for l in range(7):
        y_hat = T.sh_e3nn_np(l, np.array([0.0, 1.0, 0.0]))
        np.testing.assert_allclose(D[l].numpy() @ y_hat, T.sh_e3nn_np(l, u), atol=1e-9)


def test_bf16_directions_are_built_in_float32():
    u = torch.from_numpy(_directions()["random"]).to(torch.bfloat16)
    assert all(d.dtype == torch.float32 for d in T.wigner_blocks_from_edges(2, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_through_the_edge_angles_are_finite_at_the_poles(dtype):
    """The pole-safe angles: an exactly pole-aligned edge (any ideal cubic
    crystal has them) must not NaN the forces through the Wigner blocks."""
    dirs = _directions()
    u = torch.from_numpy(np.concatenate([dirs["poles"], dirs["near_poles"],
                                         dirs["random"][:4]])).to(dtype)
    vec = (2.5 * u).requires_grad_(True)
    rhat = vec / vec.norm(dim=-1, keepdim=True)
    D = T.wigner_blocks_from_edges(4, rhat)
    w = torch.linspace(-1, 1, 81, dtype=dtype).reshape(9, 9)
    energy = sum((d * w[:d.shape[1], :d.shape[2]]).sum() for d in D)
    (g,) = torch.autograd.grad(energy, vec)
    assert bool(torch.isfinite(g).all())
    alpha, beta = T.edge_angles(rhat)
    assert bool(torch.isfinite(alpha).all() and torch.isfinite(beta).all())
    assert float(alpha[0].detach()) == 0.0 and float(alpha[1].detach()) == 0.0
