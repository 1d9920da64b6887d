"""Port parity: geometry (basic, epipolar, rotations, correct, decompose).

The same numpy inputs go through `deepfepe_tpu.geometry` and
`deepfepe_tpu_torch.geometry` on the CPU in float64 (x64 is on in
tests/conftest.py). The functions are the same closed-form arithmetic, so
they agree to 1e-10 unless stated.
"""

import numpy as np
import pytest
import torch

import types

import jax.numpy as jnp

from deepfepe_tpu.geometry import basic as jb, correct as jc, decompose as jdec
from deepfepe_tpu.geometry import epipolar as je, rotations as jr
from deepfepe_tpu_torch.geometry import basic as tb, correct as tc, decompose as tdec
from deepfepe_tpu_torch.geometry import epipolar as te, rotations as tr

from conftest import synthetic_pair
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-10


def _ns(*mods):
    ns = {}
    for m in mods:
        ns.update({k: v for k, v in vars(m).items() if not k.startswith("__")})
    return types.SimpleNamespace(**ns)


jg = _ns(jb, je, jr, jc)
tg = _ns(tb, te, tr, tc)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=tol, atol=tol)


def _pts(rng, b=2, n=50):
    p = rng.rand(b, n, 2) * np.array([1241.0, 376.0])
    return p.astype(np.float64)


def test_basic_helpers(rng):
    v = rng.randn(4, 3)
    v[0] = 0.0
    _close(jg.safe_norm(_j(v)), tg.safe_norm(_t(v)))
    p = _pts(rng)
    _close(jg.homo(_j(p)), tg.homo(_t(p)))
    ph = rng.rand(2, 5, 3) + 0.5
    _close(jg.dehomo(_j(ph)), tg.dehomo(_t(ph)))
    _close(jg.skew(_j(v)), tg.skew(_t(v)))
    _close(jg.skew(_j(v[..., None])), tg.skew(_t(v[..., None])))
    Rt = rng.randn(3, 3, 4)
    _close(jg.rt_pad(_j(Rt)), tg.rt_pad(_t(Rt)))
    _close(jg.rt_inverse(_j(Rt)), tg.rt_inverse(_t(Rt)))


def test_safe_norm_zero_gradient():
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    tg.safe_norm(x).backward()
    assert torch.equal(x.grad, torch.zeros(3, dtype=torch.float64))


def test_normalization(rng):
    p = _pts(rng)
    size = (376, 1241)
    _close(jg.norm_hw_matrix(size, jnp.float64), tg.norm_hw_matrix(size, torch.float64))
    for a, b in zip(jg.normalize_hw(_j(p), size), tg.normalize_hw(_t(p), size)):
        _close(a, b)
    ph = np.concatenate([p, np.ones(p.shape[:-1] + (1,))], -1)
    w = rng.rand(2, 50)
    for weights in (None, w):
        ja = jg.hartley_normalize(_j(ph), None if weights is None else _j(weights))
        ta = tg.hartley_normalize(_t(ph), None if weights is None else _t(weights))
        for a, b in zip(ja, ta):
            _close(a, b)
    # A fully degenerate set takes the floored scale (1.4e6) in both. The
    # output is then scale * (x - c) with x - c at rounding level, so only
    # the scale agrees to 1e-10; the points agree to 1e-4 relative.
    same = np.tile(ph[:, :1], (1, 8, 1))
    (ja, jT), (ta, tT) = jg.hartley_normalize(_j(same)), tg.hartley_normalize(_t(same))
    _close(jT[..., 0, 0], tT[..., 0, 0])
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), rtol=1e-4)


def test_epipolar_distances(rng):
    d = synthetic_pair(rng, n=60, noise=1.0, outlier_frac=0.2)
    p1 = np.concatenate([d["x1"], np.ones((60, 1))], -1)[None]
    p2 = np.concatenate([d["x2"], np.ones((60, 1))], -1)[None]
    F = d["F"][None]
    _close(jg.epipolar_constraint_matrix(_j(p1), _j(p2)),
           tg.epipolar_constraint_matrix(_t(p1), _t(p2)))
    for clamp in (0.02, 0.5, 1e9):
        _close(jg.compute_epi_residual(_j(p1), _j(p2), _j(F), clamp_at=clamp),
               tg.compute_epi_residual(_t(p1), _t(p2), _t(F), clamp_at=clamp))
    for a, b in zip(jg.epi_distance(_j(F), _j(d["x1"][None]), _j(d["x2"][None])),
                    tg.epi_distance(_t(F), _t(d["x1"][None]), _t(d["x2"][None]))):
        _close(a, b)
    # The gradient at a zero-row F stays finite (safe norms).
    Fz = torch.from_numpy(F.copy()).requires_grad_(True)
    with torch.no_grad():
        Fz[:, 0] = 0.0
        Fz[:, 1] = 0.0
    tg.compute_epi_residual(_t(p1), _t(p2), Fz).sum().backward()
    assert torch.isfinite(Fz.grad).all()


def test_E_F_conversions(rng):
    d = synthetic_pair(rng)
    R, t, K = d["R"][None], d["t"][None], d["K"][None]
    for a, b in zip(jg.E_F_from_Rt(_j(R), _j(t), _j(K)), tg.E_F_from_Rt(_t(R), _t(t), _t(K))):
        _close(a, b, 1e-9)
    _close(jg.F_to_E(_j(d["F"]), _j(d["K"])), tg.F_to_E(_t(d["F"]), _t(d["K"])), 1e-9)
    _close(jg.E_to_F(_j(d["E"]), _j(d["K"])), tg.E_to_F(_t(d["E"]), _t(d["K"])), 1e-9)


def test_rotations(rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(16, random_state=1).as_matrix()
    R[0] = np.diag([1.0, -1.0, -1.0])  # trace -1: the non-w branches
    _close(jg.R_to_q(_j(R)), tg.R_to_q(_t(R)))
    R2 = Rotation.random(16, random_state=2).as_matrix()
    # acos near 1 amplifies rounding: 1e-6 deg is far below any error read.
    _close(jg.rotation_angle_error(_j(R), _j(R2)), tg.rotation_angle_error(_t(R), _t(R2)), 1e-6)
    v1, v2 = rng.randn(8, 3), rng.randn(8, 3)
    _close(jg.vector_angle(_j(v1), _j(v2)), tg.vector_angle(_t(v1), _t(v2)), 1e-8)
    _close(jg.vector_angle(_j(v1[..., None]), _j(v2)),
           tg.vector_angle(_t(v1[..., None]), _t(v2)), 1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_virtual_points(rng, dtype):
    """float32 is the data path's type; the Newton iteration's rounding
    differs between the two packages by a few pixels' worth of 1e-4."""
    F = np.stack([synthetic_pair(rng)["F"] for _ in range(3)]).astype(dtype)
    F = F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)
    size = (376, 1241)
    tol = 1e-9 if dtype == "float64" else 2e-3
    for a, b in zip(jg.virtual_grid(size, dtype=getattr(jnp, dtype)),
                    tg.virtual_grid(size, dtype=getattr(torch, dtype))):
        _close(a, b, 1e-6)
    ja = jg.get_virtual_points(_j(F), size)
    ta = tg.get_virtual_points(_t(F), size)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=0)
    # The corrected points satisfy the constraint.
    e = torch.einsum("bni,bij,bnj->bn", ta[1].double(), _t(F).double(), ta[0].double())
    assert e.abs().max() < (1e-6 if dtype == "float64" else 1e-4)


def test_decompose_and_recover_pose(rng):
    """E decomposition goes through the 3x3 Jacobi eigh on both sides. A
    true E has two equal singular values, which leaves the decomposition's
    basis free within that plane, so the candidates are compared on a
    perturbed E with a separated spectrum and the recovered pose on the
    true one."""
    items = [synthetic_pair(rng, n=80, noise=0.5) for _ in range(3)]
    E = np.stack([d["E"] for d in items])
    E_sep = E + 0.1 * rng.randn(*E.shape)
    Kinv = np.stack([np.linalg.inv(d["K"]) for d in items])
    x1 = np.stack([np.c_[d["x1"], np.ones(80)] @ k.T for d, k in zip(items, Kinv)])
    x2 = np.stack([np.c_[d["x2"], np.ones(80)] @ k.T for d, k in zip(items, Kinv)])
    for a, b in zip(jdec.decompose_E(_j(E_sep)), tdec.decompose_E(_t(E_sep))):
        _close(a, b, 1e-8)
    ja = jdec.two_view_depths(_j(items[0]["R"]), _j(items[0]["t"]), _j(x1[0]), _j(x2[0]))
    ta = tdec.two_view_depths(_t(items[0]["R"]), _t(items[0]["t"]), _t(x1[0]), _t(x2[0]))
    for a, b in zip(ja, ta):
        _close(a, b, 1e-8)
    jr = jdec.recover_pose(_j(E), _j(x1), _j(x2))
    tr = tdec.recover_pose(_t(E), _t(x1), _t(x2))
    _close(jr.R, tr.R, 1e-8)
    _close(jr.t, tr.t, 1e-8)
    _close(jr.inlier_frac, tr.inlier_frac)
    np.testing.assert_array_equal(np.asarray(jr.mask), tr.mask.numpy())
    # And the recovered pose is the true one.
    for d, R in zip(items, tr.R.numpy()):
        assert np.abs(R - d["R"]).max() < 1e-2
