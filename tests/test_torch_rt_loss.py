"""Port parity: the closed-form E decomposition and the pose (q, t) loss.

Values and gradients against the JAX package in float64 (x64 is on,
tests/conftest.py), on essential matrices made with numpy from a seed:
noisy valid E, and near-rank-1 E (singular values 1, ~0.01, 0) where the
`gap_eps` broadening of the null-space eigengap bounds the backward. Both
packages solve the 3x3 eigenproblems by fixed-sweep Jacobi in float64:
values agree to 1e-9 and gradients to 1e-7 of their largest entry
(measured 1.6e-15 and 1.4e-16 for rt_loss).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.geometry.decompose import decompose_E_closed_form as jdecompose
from deepfepe_tpu.losses.rt_loss import rt_loss as jrt_loss
from deepfepe_tpu_torch.geometry import decompose_E_closed_form
from deepfepe_tpu_torch.losses import rt_loss
from deepfepe_tpu_torch.ops import set_nan2zero
from _torch_threads import one_torch_thread  # noqa: F401

VAL_TOL, GRAD_TOL = 1e-9, 1e-7


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def _rot(rng, deg):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    K = _skew(axis)
    a = np.deg2rad(deg) * rng.rand()
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _poses(rng, n):
    Rs = np.stack([_rot(rng, 5.0) for _ in range(n)])
    ts = rng.randn(n, 3)
    ts /= np.linalg.norm(ts, axis=-1, keepdims=True)
    return Rs, ts


def _essentials(rng, shape, near_rank1=False):
    n = int(np.prod(shape))
    Rs, ts = _poses(rng, n)
    E = np.stack([_skew(t) @ R for R, t in zip(Rs, ts)]) + 0.05 * rng.randn(n, 3, 3)
    if near_rank1:
        # Singular values (1, ~0.01, 0): the null vector's eigengap in
        # ÊÊᵀ is ~2e-4, below sqrt(gap_eps), so the broadening shapes the
        # backward while the vector itself stays well defined.
        U, V = _poses(rng, n)[0], _poses(rng, n)[0]
        s = np.stack([np.ones(n), 0.01 * (1 + rng.rand(n)), np.zeros(n)], -1)
        E = U @ (s[..., None] * np.swapaxes(V, -1, -2))
    return E.reshape(*shape, 3, 3)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0), np.abs(a - b).max()


@pytest.mark.parametrize("near_rank1", [False, True])
def test_closed_form_decomposition_matches_jax(near_rank1):
    rng = np.random.RandomState(1 + near_rank1)
    E = _essentials(rng, (4,), near_rank1)
    gap = 1e-4
    Et = torch.tensor(E, requires_grad=True)
    dec = decompose_E_closed_form(Et, gap_eps=gap)
    jd = jdecompose(jnp.asarray(E), gap_eps=gap)
    for ours, ref in zip(dec, jd):
        _close(ours.detach(), ref, VAL_TOL)

    w = rng.randn(3, 3)

    def jf(E):
        d = jdecompose(E, gap_eps=gap)
        return jnp.sum(jnp.sin(d.R1) * w) + jnp.sum(d.R2 ** 2 * w) + jnp.sum(jnp.cos(d.t))

    (torch.sum(torch.sin(dec.R1) * torch.tensor(w)) + torch.sum(dec.R2 ** 2 * torch.tensor(w))
     + torch.sum(torch.cos(dec.t))).backward()
    g = np.asarray(jax.grad(jf)(jnp.asarray(E)))
    _close(Et.grad, g, GRAD_TOL)
    assert np.isfinite(g).all()


def _rt_inputs(rng, near_rank1):
    L, B = 3, 4
    E = _essentials(rng, (L, B), near_rank1)
    Rs, ts = _poses(rng, B)
    q = np.stack([np.asarray(importlib.import_module(
        "deepfepe_tpu_torch.geometry.rotations").R_to_q(torch.tensor(R))) for R in Rs])
    return E, q, ts * 2.0, Rs


@pytest.mark.parametrize("near_rank1", [False, True])
@pytest.mark.parametrize("clamps", [(0.1, 0.5), (10.0, 10.0)])
def test_rt_loss_values_and_gradients_match_jax(near_rank1, clamps):
    rng = np.random.RandomState(7 + near_rank1)
    E, q, t, R = _rt_inputs(rng, near_rank1)
    Et = torch.tensor(E, requires_grad=True)
    ours = rt_loss(Et, torch.tensor(q), torch.tensor(t), torch.tensor(R), *clamps)
    ref = jrt_loss(jnp.asarray(E), jnp.asarray(q), jnp.asarray(t), jnp.asarray(R), *clamps)
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k].detach(), ref[k], VAL_TOL if "angle" not in k else 1e-6)

    (ours["loss_q"] + 0.3 * ours["loss_t"]).backward()

    def jl(E):
        d = jrt_loss(E, jnp.asarray(q), jnp.asarray(t), jnp.asarray(R), *clamps)
        return d["loss_q"] + 0.3 * d["loss_t"]

    g = np.asarray(jax.grad(jl)(jnp.asarray(E)))
    _close(Et.grad, g, GRAD_TOL)


def test_rt_loss_gap_eps_bounds_the_near_rank1_gradient():
    rng = np.random.RandomState(3)
    E, q, t, R = _rt_inputs(rng, True)
    norms = []
    for gap in (1e-4, 1e-10):
        Et = torch.tensor(E, requires_grad=True)
        rt_loss(Et, torch.tensor(q), torch.tensor(t), torch.tensor(R), 10.0, 10.0,
                decomp_gap_eps=gap)["loss_t"].backward()
        norms.append(float(Et.grad.norm()))
    assert norms[0] < norms[1] / 10, norms


def test_set_nan2zero():
    x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    assert set_nan2zero(x).tolist() == [1.0, 0.0, 0.0, 0.0]
