"""Port parity: the robust epipolar residual (K3's function) and its
gradients.

The port's residual has two CPU routes: `compute_epi_residual` (the plain
version, differentiated by autograd) and the `EpiResidual` Function, which
on CPU tensors runs the kernels' plain versions in their [P, M, N] layout
and the backward kernels' formulas (`epi_residual_bwd_ref`). Both are held
against the JAX package at its three callers' broadcast patterns: DeepFNet
([B, N, 3] with [B, 3, 3]), the F-loss ([1, B, V, 3] with [L, B, 3, 3])
and the sample loss ([1, B, 1, V, 3] with [L, B, S, 3, 3]). Inputs come
from numpy seeds.

- Forward in float32 against JAX `compute_epi_residual` and against
  `epi_residual_pallas` in interpret mode, at tests/test_jacobi.py's bar
  for the Pallas kernel: rtol 1e-4, atol 1e-5.
- Gradients in float64 against `jax.grad` (points and F), within 1e-9 of
  the largest entry, on inputs that hold a zero-row F (tests/test_ops.py:
  229: (F x1)_xy is exactly 0, no gradient passes), an s = 0 and a residual
  exactly at the clamp (small powers of two: every step exact). At those
  two kinks the packages' conventions differ (JAX: |.|' = 1 at 0, clip
  passes 1/2 at the tie; torch: 0 and 1); the port's plain version and its
  kernels' formulas take torch's, held exactly against each other, and the
  JAX comparison gives those two points no cotangent.
- The kernels' CUDA versions are held against the plain versions on the
  card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.geometry.epipolar import compute_epi_residual as j_epi
from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

epi = importlib.import_module("deepfepe_tpu_torch.ops.epi_residual")

L, B, S, N = 3, 2, 4, 12
PATTERNS = {"deepfnet": ((B, N, 3), (B, 3, 3)),
            "f_loss": ((1, B, N, 3), (L, B, 3, 3)),
            "sample": ((1, B, 1, N, 3), (L, B, S, 3, 3))}
F_TIE = np.array([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])
# Point 1's residual against F_TIE, computed as both packages compute it.
TIE = 0.25 * (1.0 / (1.0 + 1e-6) + 1.0 / (1.0 + 1e-6))


def _inputs(pattern, seed=0, clamp=0.5):
    """Points in [-1, 1] homogeneous, x2 near x1's epipolar line of F_TIE,
    F = F_TIE + noise. The first F of the broadcast has zero rows; the last
    is F_TIE, against which point 0 (x1 = x2 = (0, 0, 1)) gives s = 0 and
    point 1 gives s = 0.25 and d = TIE exactly."""
    ps, fs = PATTERNS[pattern]
    rng = np.random.RandomState(seed)
    x1 = np.concatenate([rng.uniform(-1, 1, ps[:-1] + (2,)), np.ones(ps[:-1] + (1,))], -1)
    x2 = x1.copy()
    x2[..., 0] = rng.uniform(-1, 1, ps[:-1])
    x2[..., 1] += 0.5 * clamp * rng.randn(*ps[:-1])
    F = F_TIE + 0.1 * clamp * rng.randn(*fs)
    Ff = F.reshape(-1, 3, 3)
    Ff[0, :2] = 0.0
    Ff[-1] = F_TIE
    x1[..., 0, :] = x2[..., 0, :] = [0.0, 0.0, 1.0]
    x1[..., 1, :], x2[..., 1, :] = [0.25, 0.5, 1.0], [0.75, 0.25, 1.0]  # s = 0.25 on F_TIE
    return x1, x2, F


def _port(route, a, b, F, clamp):
    if route == "plain":
        return compute_epi_residual(a, b, F, clamp_at=clamp)
    return epi.EpiResidual.apply(a, b, F, clamp, 1e-6)


@pytest.mark.parametrize("route", ["plain", "kernel_layout"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_residual_matches_jax_f32(pattern, route):
    x1, x2, F = (a.astype(np.float32) for a in _inputs(pattern, clamp=0.02))
    ref = np.asarray(j_epi(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F), 0.02))
    got = _port(route, *(torch.from_numpy(a) for a in (x1, x2, F)), 0.02).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert 0.1 < np.mean(ref < 0.02) < 0.9  # clamped and unclamped residuals both occur


def test_residual_matches_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from deepfepe_tpu.ops.pallas import epi_residual_pallas

    x1, x2, F = (a.astype(np.float32) for a in _inputs("deepfnet", seed=1))
    F[0] = rng.randn(3, 3)  # the Pallas kernel's plain sqrt has no zero-norm guard
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(epi_residual_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F),
                                             0.5))
    for route in ("plain", "kernel_layout"):
        got = _port(route, *(torch.from_numpy(a) for a in (x1, x2, F)), 0.5).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=route)


def _grads(route, x1, x2, F, clamp, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, F)]
    out = _port(route, *ts, clamp)
    return out.detach(), [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


def _cotangent(x1, F, seed=3):
    return np.random.RandomState(seed).randn(*np.broadcast_shapes(x1.shape[:-2], F.shape[:-2]),
                                             N)


@pytest.mark.parametrize("route", ["plain", "kernel_layout"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gradients_match_jax_f64(pattern, route):
    """Every point off the two kinks (below) against jax.grad; the zero-row
    F passes no gradient at all."""
    x1, x2, F = _inputs(pattern, seed=2, clamp=TIE)
    g = _cotangent(x1, F)
    g.reshape(-1, N)[-1, :2] = 0.0  # the s = 0 and tie points: see the next test

    def jf(a, b, f):
        return jnp.sum(j_epi(a, b, f, TIE) * g)

    ref = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F))
    _, got = _grads(route, x1, x2, F, TIE, g)
    for name, a, r in zip(("pts1", "pts2", "F"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-9 * np.abs(r).max(), err_msg=name)
    assert np.all(got[2].reshape(-1, 3, 3)[0] == 0)  # every residual of the zero-row F is clamped


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gradients_at_the_kinks(pattern):
    """At s = 0 and at d == clamp_at the port takes torch's conventions, in
    its plain version and in the kernels' formulas alike: |s| passes no
    gradient at 0, and the clamp passes all of it at the tie (JAX's
    jnp.abs passes 1 at 0 and its clip 1/2 at the tie, on a set of measure
    zero of the path's float inputs)."""
    x1, x2, F = _inputs(pattern, seed=2, clamp=TIE)
    g = _cotangent(x1, F)
    out, plain = _grads("plain", x1, x2, F, TIE, g)
    _, layout = _grads("kernel_layout", x1, x2, F, TIE, g)
    for a, b in zip(plain, layout):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())
    last = out.reshape(-1, N)[-1]
    assert last[0].item() == 0.0 and last[1].item() == TIE
    for point, clamp_ref in ((0, TIE), (1, 1e30)):
        only = np.zeros_like(g)
        only.reshape(-1, N)[-1, point] = 1.0
        for route in ("plain", "kernel_layout"):
            got = _grads(route, x1, x2, F, TIE, only)[1]
            want = _grads("plain", x1, x2, F, clamp_ref, only)[1]  # the tie: as if unclamped
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                if point == 0:
                    assert not a.any()  # |s|'(0) = 0, and |s| = 0 zeroes the norms' terms


def test_zero_row_F_gradient_is_finite():
    """tests/test_ops.py:229's case through both routes: F with zero rows
    gives (F x1)_xy = 0, whose norm has no gradient; the result's gradient
    is finite and equals JAX's."""
    F = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.4e6, 1.3e5, -3.0e5]])
    rng = np.random.RandomState(0)
    p1 = np.concatenate([rng.uniform(-1, 1, (50, 2)), np.ones((50, 1))], -1)
    p2 = np.concatenate([rng.uniform(-1, 1, (50, 2)), np.ones((50, 1))], -1)
    ref = jax.grad(lambda f: jnp.mean(j_epi(jnp.asarray(p1), jnp.asarray(p2), f, 0.02)))(
        jnp.asarray(F))
    for route in ("plain", "kernel_layout"):
        f = torch.from_numpy(F).requires_grad_()
        val = _port(route, torch.from_numpy(p1), torch.from_numpy(p2), f, 0.02).mean()
        (gF,) = torch.autograd.grad(val, f)
        assert torch.isfinite(val) and torch.isfinite(gF).all()
        np.testing.assert_array_equal(gF.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shapes", [((2, 5, 3), (1, 3, 3)), ((3, 2, 5, 3), (2, 3, 3)),
                                    ((1, 5, 3), (2, 3, 3))])
def test_layout_raises_for_other_patterns(shapes):
    """The kernels' layout takes every batch axis of the points from F; F
    broadcast over the points (or over a point axis of another size) is not
    a pattern of the path and raises (the plain version computes it)."""
    ps, fs = shapes
    a, F = torch.zeros(ps), torch.zeros(fs)
    if ps[0] == 1 and fs[0] == 2:  # a pattern the layout takes: P = 1, M = 2
        assert epi.Layout(a, a, F).P == 1 and epi.Layout(a, a, F).M == 2
        return
    with pytest.raises(ValueError):
        epi.Layout(a, a, F)
    assert compute_epi_residual(a + 1, a + 1, F).shape == torch.broadcast_shapes(
        ps[:-1], fs[:-2] + (ps[-2],))


def test_layout_maps_the_sample_loss_pattern_without_expanding_points():
    a = torch.zeros(1, B, 1, N, 3)
    F = torch.randn(L, B, S, 3, 3)
    lay = epi.Layout(a, a, F)
    assert (lay.P, lay.M, lay.N) == (B, L * S, N)
    assert lay.points(a).shape == (B, N, 3)
    F9 = lay.matrices(F)
    assert torch.equal(F9[1, 2 * S + 3], F[2, 1, 3].reshape(9))
    out = torch.arange(B * L * S * N, dtype=torch.float32).reshape(B, L * S, N)
    res = lay.residual(out)
    assert res.shape == (L, B, S, N) and res[2, 1, 3, 5] == out[1, 2 * S + 3, 5]
    assert torch.equal(lay.cotangent(res), out)
    assert torch.equal(lay.F_grad(F9), F)


def test_cpu_routes_launch_no_kernel():
    before = (epi.epi_residual.launches, epi.epi_residual_bwd.launches)
    x1, x2, F = (torch.from_numpy(a).requires_grad_() for a in _inputs("f_loss"))
    for out in (compute_epi_residual(x1, x2, F), epi.EpiResidual.apply(x1, x2, F, 0.5, 1e-6)):
        out.sum().backward()
    assert (epi.epi_residual.launches, epi.epi_residual_bwd.launches) == before
