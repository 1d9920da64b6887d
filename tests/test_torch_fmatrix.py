"""Port parity: the weighted 8-point solve, 3x3 spectral ops and the F-loss.

Same numpy inputs through `deepfepe_tpu` and `deepfepe_tpu_torch` on the
CPU. float64 runs agree to ~1e-8 (the Jacobi eigensolves are the same
arithmetic); the float32 solve is held to 1e-4 on the unit-norm F, the
eigenvector bar of the JAX package's own eigh tests.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfepe_tpu.ops import fmatrix as j_fm, svd3 as j_svd3
from deepfepe_tpu_torch.ops import fmatrix as t_fm, svd3 as t_svd3

from conftest import synthetic_pair
from _torch_threads import one_torch_thread  # noqa: F401

# The packages re-export the function `f_loss` under the module's name.
j_floss = importlib.import_module("deepfepe_tpu.losses.f_loss")
t_floss = importlib.import_module("deepfepe_tpu_torch.losses.f_loss")


def _batch(rng, B=2, n=120, dtype="float64"):
    items = [synthetic_pair(rng, n=n, noise=0.5, outlier_frac=0.2) for _ in range(B)]
    p1 = np.stack([np.c_[d["x1"], np.ones(n)] for d in items]).astype(dtype)
    p2 = np.stack([np.c_[d["x2"], np.ones(n)] for d in items]).astype(dtype)
    w = rng.rand(B, n).astype(dtype)
    return items, p1, p2, w / w.sum(-1, keepdims=True)


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-8), ("float32", 1e-4)])
@pytest.mark.parametrize("normalize_svd", [True, False])
def test_weighted_eight_point_sign_canonical(rng, dtype, tol, normalize_svd):
    _, p1, p2, w = _batch(rng, dtype=dtype)
    rj = j_fm.weighted_eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                                   normalize_svd=normalize_svd, sign_canonical=True)
    rt = t_fm.weighted_eight_point(torch.from_numpy(p1), torch.from_numpy(p2),
                                   torch.from_numpy(w), normalize_svd=normalize_svd,
                                   sign_canonical=True)
    np.testing.assert_allclose(rt.f_vec.numpy(), np.asarray(rj.f_vec), atol=tol)
    np.testing.assert_allclose(rt.F_norm.numpy(), np.asarray(rj.F_norm), atol=tol)
    np.testing.assert_allclose(_unit(rt.F.numpy()), _unit(rj.F), atol=tol)
    scale = np.abs(np.asarray(rj.residual)).max()
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual), atol=tol * scale)
    for a, b in ((rt.T1, rj.T1), (rt.T2, rj.T2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol)


def test_weighted_eight_point_recovers_gt_F(rng):
    items, p1, p2, _ = _batch(rng, n=200)
    inl = np.ones((2, 200))
    rt = t_fm.weighted_eight_point(torch.from_numpy(p1), torch.from_numpy(p2),
                                   torch.from_numpy(inl / 200.0))
    # 20% outliers pull a uniform fit off; a fit on the inliers alone is exact.
    F_gt = np.stack([d["F"] for d in items])
    assert np.linalg.matrix_rank(rt.F.numpy()[0], tol=1e-9) == 2
    clean = [synthetic_pair(rng, n=60, noise=0.0) for _ in range(2)]
    q1 = torch.from_numpy(np.stack([np.c_[d["x1"], np.ones(60)] for d in clean]))
    q2 = torch.from_numpy(np.stack([np.c_[d["x2"], np.ones(60)] for d in clean]))
    F = t_fm.weighted_eight_point(q1, q2, torch.full((2, 60), 1 / 60, dtype=torch.float64)).F
    err = np.abs(np.abs(_unit(F.numpy())) - np.abs(_unit(np.stack([d["F"] for d in clean]))))
    assert err.max() < 1e-6 and F_gt.shape == (2, 3, 3)


def test_svd3_ops_match_jax(rng):
    F = rng.randn(5, 3, 3)
    for name in ("rank2_projection", "project_E_110", "singular_values_3x3"):
        a = getattr(j_svd3, name)(jnp.asarray(F))
        b = getattr(t_svd3, name)(torch.from_numpy(F))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-9, err_msg=name)


def _fake_outs(rng, L=3, B=2, N=40):
    T = np.tile(np.array([[2 / 1241, 0, -1], [0, 2 / 376, -1], [0, 0, 1.0]]), (B, 1, 1))
    out_layers = rng.randn(L, B, 3, 3) * 0.1
    w = rng.rand(L, B, N)
    return {
        "T1": T, "T2": T, "out_layers": out_layers, "F_est": out_layers[-1],
        "epi_res_layers": rng.rand(L - 1, B, N), "weights_layers": w / w.sum(-1, keepdims=True),
        "residual_layers": rng.randn(L, B, N) * 0.01,
    }


def test_f_loss_matches_jax(rng):
    outs = _fake_outs(rng)
    items = [synthetic_pair(rng) for _ in range(2)]
    Ks = np.stack([d["K"] for d in items])
    v1 = np.c_[rng.rand(100, 2) * [1241, 376], np.ones(100)][None].repeat(2, 0)
    v2 = v1 + np.c_[rng.randn(100, 2), np.zeros(100)][None]
    for clamp in (0.02, 10.0):
        lj = j_floss.f_loss({k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(v1),
                            jnp.asarray(v2), jnp.asarray(Ks), clamp)
        lt = t_floss.f_loss({k: torch.from_numpy(v) for k, v in outs.items()},
                            torch.from_numpy(v1), torch.from_numpy(v2), torch.from_numpy(Ks),
                            clamp)
        for k in lt:
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-9,
                                       atol=1e-12, err_msg=k)


def test_residual_summaries_and_unique_topk_match_jax(rng):
    outs = _fake_outs(rng)
    nums = np.array([25, 40], np.int32)
    sj = j_floss.residual_summaries({k: jnp.asarray(v) for k, v in outs.items()}, 5,
                                    jnp.asarray(nums))
    st = t_floss.residual_summaries({k: torch.from_numpy(v) for k, v in outs.items()}, 5,
                                    torch.from_numpy(nums))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-9, err_msg=k)
    xs = rng.randn(2, 40)
    np.testing.assert_allclose(
        t_floss.unique_topk(torch.from_numpy(xs), 4, torch.from_numpy(nums)).numpy(),
        np.asarray(j_floss.unique_topk(jnp.asarray(xs), 4, jnp.asarray(nums))))
