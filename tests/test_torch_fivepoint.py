"""Port parity: the five-point solver, its RANSAC baseline and the Sampson
and symmetric epipolar distances.

The five-point null space is four eigenvectors of a 9x9 Gram matrix whose
four smallest eigenvalues are all zero: any orthonormal basis of that
eigenspace is a right answer, and the two packages' Jacobi sweeps (the
same schedule, rounded differently) pick different ones. A basis fixes the
polynomial system, so the candidates are compared in float64 on ONE basis
(the JAX package's, handed to the port in place of its own): equal valid
masks and E equal up to sign within 1e-8. The bases are held to the same
subspace (equal projectors within 1e-9), and the port's own candidates to
the essential constraints (float64) and to the ground truth, at
tests/test_fivepoint.py's bars or tighter.

`ransac_e_batch` and `val_rt_batch(five_point=True)` replay the JAX
package's draws (`jax.random.split(key, B)`, then `randint(k, (H, 5), 0,
n)` a pair) on the JAX basis: in float64 the masks and inlier counts are
equal, E within 1e-8 up to sign, and the pose errors within 1e-6 deg. On
its own bases the port meets tests/test_fivepoint.py's bars in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs as JSyntheticPairs
from deepfepe_tpu.eval import ransac as j_ransac, val_rt as j_valrt
from deepfepe_tpu.geometry import epipolar as j_epi, fivepoint as j_fp
from deepfepe_tpu_torch.eval import ransac as t_ransac, val_rt as t_valrt
from deepfepe_tpu_torch.geometry import epipolar as t_epi, fivepoint as t_fp

from test_fivepoint import _E_err, _E_gt, _project_pair, _random_pose

_jax_basis = jax.jit(jax.vmap(j_fp._nullspace_basis))
_jax_cands = jax.jit(jax.vmap(j_fp.five_point_candidates))


def jax_basis(x1n, x2n):
    """The JAX package's null-space bases of [S, 5, 2] samples, as torch."""
    return torch.from_numpy(np.array(_jax_basis(jnp.asarray(x1n.numpy()),
                                                jnp.asarray(x2n.numpy()))))


@pytest.fixture(scope="module")
def samples():
    """Twelve five-point samples of known poses, float64, the last three
    degenerate (one index repeated, two repeated, all five the same), and
    a thirteenth of zeros."""
    rng = np.random.RandomState(3)
    x1, x2, E = [], [], []
    for _ in range(12):
        R, t = _random_pose(rng, rng.uniform(1, 8))
        a, b = _project_pair(rng, R, t, 5)
        x1.append(a)
        x2.append(b)
        E.append(_E_gt(R, t))
    x1, x2 = np.array(x1), np.array(x2)
    for s, pattern in ((9, [0, 0, 1, 2, 3]), (10, [0, 0, 1, 1, 2]), (11, [0, 0, 0, 0, 0])):
        x1[s], x2[s] = x1[s][pattern], x2[s][pattern]
    zero = np.zeros((1, 5, 2))
    return np.concatenate([x1, zero]), np.concatenate([x2, zero]), np.array(E)


def test_nullspaces_span_the_same_subspace(samples):
    x1, x2, _ = samples
    Bt = t_fp._nullspace_basis(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()[:9]
    Bj = np.asarray(_jax_basis(jnp.asarray(x1), jnp.asarray(x2)))[:9]
    proj = lambda B: np.einsum("ski,skj->sij", B.reshape(9, 4, 9), B.reshape(9, 4, 9))
    np.testing.assert_allclose(proj(Bt), proj(Bj), atol=1e-9)


def test_candidates_equal_jax_on_one_basis(samples, monkeypatch):
    """All thirteen samples: repeated indices leave a five-dimensional null
    space, and both packages solve the system of the chosen four vectors;
    the zeros make the 10x10 system singular, which JAX's solve turns into
    non-finite E and the port's solve_ex into a nonzero info: invalid in
    both."""
    x1, x2, _ = samples
    monkeypatch.setattr(t_fp, "_nullspace_basis", jax_basis)
    got = t_fp.five_point_candidates(torch.from_numpy(x1), torch.from_numpy(x2))
    want = _jax_cands(jnp.asarray(x1), jnp.asarray(x2))
    vt, vj = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(vt, vj)
    Et, Ej = got.E.numpy(), np.asarray(want.E)
    err = np.minimum(np.abs(Et - Ej).max((-1, -2)), np.abs(Et + Ej).max((-1, -2)))
    assert err[vj].max() < 1e-8
    assert vj[:9].sum(1).min() >= 2  # real roots come in pairs here
    assert not vj[12].any()


def test_own_candidates_are_essential_and_recover_the_pose(samples):
    """On its own bases the port recovers the pose of test_fivepoint.py's
    four samples (the same draws) at its 2e-3 bar. Two roots that fall in
    one grid cell of the bracketing are missed in either package, on some
    bases and not others (seen here in the JAX package's float32 run of
    sample 4 and the port's float64 run of sample 8), so the other samples
    are held to the constraints alone. Every valid float64 root is
    essential (det E and 2 E Eᵀ E - tr(E Eᵀ) E within 1e-8 and 1e-6, the
    JAX package reaching 2e-10 and 1e-7 here); in float32 both packages
    mark a few non-essential roots valid on these samples (det up to 0.03
    in the JAX package, 0.08 in the port), so float32 is held to the
    pose alone."""
    x1, x2, E_gt = samples
    for dtype, bar in ((torch.float64, 1e-6), (torch.float32, 2e-3)):
        c = t_fp.five_point_candidates(torch.from_numpy(x1[:9]).to(dtype),
                                       torch.from_numpy(x2[:9]).to(dtype))
        E, v = c.E.double().numpy(), c.valid.numpy()
        for s in range(9):
            assert v[s].any()
            if s < 4:
                assert min(_E_err(E[s, i], E_gt[s]) for i in range(10) if v[s, i]) < bar
            if dtype == torch.float64:
                for i in np.flatnonzero(v[s]):  # every valid root, gt or not
                    Ei = E[s, i]
                    assert abs(np.linalg.det(Ei)) < 1e-8
                    assert np.linalg.norm(2 * Ei @ Ei.T @ Ei - np.trace(Ei @ Ei.T) * Ei) < 1e-6


def test_degenerate_samples_raise_nothing(samples):
    """The port's own bases: no exception on repeated indices or the
    singular system, the zeros' sample invalid, every valid E finite."""
    x1, x2, _ = samples
    for dtype in (torch.float64, torch.float32):
        own = t_fp.five_point_candidates(torch.from_numpy(x1[9:]).to(dtype),
                                         torch.from_numpy(x2[9:]).to(dtype))
        assert not own.valid[-1].any() and own.valid[:-1].any(-1).all()
        assert torch.isfinite(own.E[own.valid]).all()


def test_nullspaces_take_one_eigh_call(monkeypatch):
    calls = []
    real = t_fp.safe_eigh

    def counted(A, *a):
        calls.append(tuple(A.shape))
        return real(A, *a)

    monkeypatch.setattr(t_fp, "safe_eigh", counted)
    x = torch.rand(3, 40, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    t_ransac.ransac_e_batch(x, x + 1e-3, num_hypotheses=16, refit=False,
                            generator=torch.Generator().manual_seed(1))
    assert calls == [(48, 9, 9)]


@pytest.mark.parametrize("fn", ["sym_epi_dist", "sampson_dist"])
def test_epipolar_distances_equal_jax(fn):
    rng = np.random.RandomState(2)
    F = rng.randn(3, 3, 3)
    p1, p2 = rng.rand(3, 50, 2) * 300, rng.rand(3, 50, 2) * 300
    kws = [{}, {"clamp_at": 0.5}] if fn == "sym_epi_dist" else [{}]
    for kw in kws:
        want = np.asarray(getattr(j_epi, fn)(jnp.asarray(F[:, None]), jnp.asarray(p1),
                                             jnp.asarray(p2), **kw))
        got = getattr(t_epi, fn)(torch.from_numpy(F[:, None]), torch.from_numpy(p1),
                                 torch.from_numpy(p2), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    want = np.asarray(getattr(j_epi, fn)(jnp.asarray(F[:, None]), jnp.asarray(p1),
                                         jnp.asarray(p2)))
    h1 = np.concatenate([p1, np.ones((3, 50, 1))], -1)
    h2 = np.concatenate([p2, np.ones((3, 50, 1))], -1)
    np.testing.assert_allclose(
        getattr(t_epi, fn)(torch.from_numpy(F[:, None]), torch.from_numpy(h1),
                           torch.from_numpy(h2), if_homo=True).numpy(), want, rtol=1e-12)


def jax_draw(key, B, n, H):
    keys = jax.random.split(key, B)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.randint(k, (H, 5), 0, n)) for k in keys]))


@pytest.fixture(scope="module")
def outlier_pairs():
    """Two pairs in normalized coordinates, 200 points, 0.5 px of noise at
    f = 1000 and the first 60 second points replaced (test_fivepoint's)."""
    rng = np.random.RandomState(7)
    x1s, x2s, Es = [], [], []
    for _ in range(2):
        R, t = _random_pose(rng, 5.0)
        x1, x2 = _project_pair(rng, R, t, 200)
        x1 += rng.randn(200, 2) * 5e-4
        x2 += rng.randn(200, 2) * 5e-4
        x2[:60] = rng.uniform(-0.5, 0.5, (60, 2))
        x1s.append(x1)
        x2s.append(x2)
        Es.append(_E_gt(R, t))
    return np.array(x1s), np.array(x2s), np.array(Es)


def test_ransac_e_batch_equals_jax_on_its_draws(outlier_pairs, monkeypatch):
    x1, x2, _ = outlier_pairs
    key, H = jax.random.PRNGKey(0), 16
    want = jax.jit(lambda a, b: j_ransac.ransac_e_batch(a, b, key, num_hypotheses=H,
                                                        threshold=2e-5))(jnp.asarray(x1),
                                                                         jnp.asarray(x2))
    monkeypatch.setattr(t_fp, "_nullspace_basis", jax_basis)
    got = t_ransac.ransac_e_batch(torch.from_numpy(x1), torch.from_numpy(x2),
                                  idxs=jax_draw(key, 2, 200, H), threshold=2e-5)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(want.num_inliers))
    Et, Ej = got.F.numpy(), np.asarray(want.F)
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < 1e-8
    one = t_ransac.ransac_e(torch.from_numpy(x1[1]), torch.from_numpy(x2[1]),
                            idxs=jax_draw(key, 2, 200, H)[1], threshold=2e-5)
    assert torch.equal(one.inlier_mask, got.inlier_mask[1])


def test_ransac_e_batch_meets_the_jax_bars_in_float32(outlier_pairs):
    """test_fivepoint.py's bars on its pair (pair 0, the same draws of the
    data), on the port's own hypotheses: inliers, E within 0.05, the
    outlier block under 0.2. Pair 1 is held to the inlier bars: on this
    seed its best hypothesis refits to 138 points, two of them outliers,
    and lands 0.084 from the truth (0.004 on seeds 1-5; the float64 run is
    the same)."""
    x1, x2, E_gt = outlier_pairs
    r = t_ransac.ransac_e_batch(torch.from_numpy(x1).float(), torch.from_numpy(x2).float(),
                                generator=torch.Generator().manual_seed(0), num_hypotheses=64,
                                threshold=2e-5)
    assert _E_err(r.F[0].double().numpy(), E_gt[0]) < 0.05
    for b in range(2):
        assert int(r.num_inliers[b]) > 0.5 * (200 - 60)
        assert r.inlier_mask[b, :60].float().mean() < 0.2
    assert r.F.shape == (2, 3, 3) and r.inlier_mask.shape == (2, 200)


def test_val_rt_five_point_equals_jax_on_its_draws(monkeypatch):
    d = JSyntheticPairs(good_num=128, noise_px=0.2, outlier_frac=0.1, seed=5).batch(2)
    d = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in d.items()}
    args = [d[k] for k in ("E_gts", "Ks", "matches_xy_ori", "E_gts", "delta_Rtijs_4_4")]
    key, hyps = jax.random.PRNGKey(2), 256
    want = jax.jit(lambda *a: j_valrt.val_rt_batch(*a, ransac_key=key, ransac_hypotheses=hyps,
                                                   five_point=True))(*map(jnp.asarray, args))
    monkeypatch.setattr(t_fp, "_nullspace_basis", jax_basis)
    got = t_valrt.val_rt_batch(*map(torch.from_numpy, args), ransac_hypotheses=hyps,
                               ransac_idxs=jax_draw(key, 2, 128, hyps // 8), five_point=True)
    for k in ("err_q_base", "err_t_base", "err_q_gt", "err_t_gt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["base_inliers"].numpy(), np.asarray(want["base_inliers"]))
    ref = np.asarray(want["epi_dists_base"])
    np.testing.assert_allclose(got["epi_dists_base"].numpy(), ref, rtol=1e-8,
                               atol=1e-6 * ref.max())
    # test_fivepoint.py's bars on the baseline; the gt sanity errors are the
    # JAX package's (above), 0.015 deg at most on this float32-made data.
    assert float(got["err_q_base"].median()) < 0.5 and float(got["err_t_base"].median()) < 5.0


def test_val_rt_five_point_on_its_own_draws_in_float32():
    from deepfepe_tpu_torch.data import SyntheticPairs

    d = SyntheticPairs(good_num=128, noise_px=0.2, outlier_frac=0.1, seed=5).batch(4)
    args = [torch.from_numpy(d[k]) for k in ("E_gts", "Ks", "matches_xy_ori", "E_gts",
                                             "delta_Rtijs_4_4")]
    out = t_valrt.val_rt_batch(*args, ransac_hypotheses=256, five_point=True,
                               generator=torch.Generator().manual_seed(2))
    assert float(out["err_q_base"].median()) < 0.5 and float(out["err_t_base"].median()) < 5.0
    # float32's acos floor near 0 is about 0.03 deg.
    assert float(out["err_q_gt"].max()) < 0.05
