"""Port parity: the RANSAC-F baseline and per-pair pose validation.

The port takes the hypotheses as indices; the test recomputes the JAX
package's draw (`jax.random.split(key, B)`, then per pair
`jax.random.randint(k, (H, 8), 0, n)`, as eval/ransac.py does) and hands
it over, so both packages fit the same minimal sets. In float64 the fits,
masks, inlier counts and pose errors then agree to rounding.

float32 is the path's type, but there a minimal fit is ill-conditioned:
the Gram matrix of 8 rows squares the condition number, and the two
packages' roundings move the per-hypothesis F by a median 5e-4 and up to
1 (unit-norm entries) on this data. The best hypothesis can then differ,
so float32 is held to the outcome, the inlier count, within 5% of N (the
masks themselves then differ on up to a third of the points, those near
the 1 px threshold).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs
from deepfepe_tpu.eval import ransac as j_ransac, val_rt as j_valrt
from deepfepe_tpu_torch.eval import ransac as t_ransac, val_rt as t_valrt

SIZE = (376, 1241)
H = 64


def jax_draw(key, B, n, H):
    keys = jax.random.split(key, B)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.randint(k, (H, 8), 0, n)) for k in keys]))


@pytest.fixture(scope="module")
def data():
    return SyntheticPairs(image_size=SIZE, good_num=150, seed=5).batch(3)


def _norm_F(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)
    flat = F.reshape(F.shape[:-2] + (9,))
    i = np.abs(flat).argmax(-1)[..., None]
    return F * np.sign(np.take_along_axis(flat, i, -1))[..., None]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("refit", [True, False])
def test_ransac_f_batch_matches_jax(data, dtype, refit):
    m = data["matches_xy_ori"].astype(dtype)
    x1, x2 = m[..., :2], m[..., 2:]
    key = jax.random.PRNGKey(4)
    rj = j_ransac.ransac_f_batch(jnp.asarray(x1), jnp.asarray(x2), key, num_hypotheses=H,
                                 refit=refit)
    rt = t_ransac.ransac_f_batch(torch.from_numpy(x1), torch.from_numpy(x2),
                                 idxs=jax_draw(key, 3, 150, H), refit=refit)
    mt, mj = rt.inlier_mask.numpy(), np.asarray(rj.inlier_mask)
    if dtype == "float64":
        np.testing.assert_allclose(_norm_F(rt.F.numpy()), _norm_F(rj.F), atol=1e-8)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(rt.num_inliers.numpy(), np.asarray(rj.num_inliers))
    else:
        assert np.abs(rt.num_inliers.numpy() - np.asarray(rj.num_inliers)).max() <= 0.05 * 150
    assert (rt.num_inliers.numpy() > 0.45 * 150).all()  # 15% outliers, 0.5 px noise


def test_single_pair_and_generator_draws(data):
    m = torch.from_numpy(data["matches_xy_ori"].astype(np.float64))
    x1, x2 = m[..., :2], m[..., 2:]
    idxs = t_ransac.draw_hypotheses(3, 150, H, torch.Generator().manual_seed(0))
    assert idxs.shape == (3, H, 8) and int(idxs.min()) >= 0 and int(idxs.max()) < 150
    batch = t_ransac.ransac_f_batch(x1, x2, idxs=idxs)
    one = t_ransac.ransac_f(x1[1], x2[1], idxs=idxs[1])
    assert torch.allclose(one.F, batch.F[1]) and torch.equal(one.inlier_mask, batch.inlier_mask[1])
    a = t_ransac.ransac_f_batch(x1, x2, generator=torch.Generator().manual_seed(0),
                                num_hypotheses=H)
    assert torch.equal(a.F, batch.F)


def test_val_rt_batch_matches_jax(data):
    dtype = "float64"
    """Pose errors of a perturbed E, of the gt E and of the baseline, in
    float64 (see the module docstring for why the float32 baseline is not
    compared pair by pair)."""
    d = {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in data.items()}
    rng = np.random.RandomState(0)
    E_est = (d["E_gts"] + 0.02 * rng.randn(*d["E_gts"].shape)).astype(dtype)
    args = (E_est, d["Ks"], d["matches_xy_ori"], d["E_gts"], d["delta_Rtijs_4_4"])
    key = jax.random.PRNGKey(9)
    oj = j_valrt.val_rt_batch(*map(jnp.asarray, args), ransac_key=key, ransac_hypotheses=H)
    ot = t_valrt.val_rt_batch(*map(torch.from_numpy, args), ransac_idxs=jax_draw(key, 3, 150, H),
                              ransac_hypotheses=H)
    bar = 1e-6
    for name in ("est", "gt", "base"):
        for k in (f"err_q_{name}", f"err_t_{name}"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=bar, err_msg=k)
        ref = np.asarray(oj[f"epi_dists_{name}"])
        np.testing.assert_allclose(ot[f"epi_dists_{name}"].numpy(), ref,
                                   rtol=1e-8, atol=1e-6 * ref.max(), err_msg=name)
        np.testing.assert_allclose(ot[f"M_cam_{name}"].numpy(), np.asarray(oj[f"M_cam_{name}"]),
                                   atol=1e-8)
    np.testing.assert_array_equal(ot["base_inliers"].numpy(), np.asarray(oj["base_inliers"]))
    assert ot["err_q_gt"].max() < 0.05
    ri, rj = t_valrt.inlier_ratios(ot["epi_dists_base"]), j_valrt.inlier_ratios(oj["epi_dists_base"])
    for k in rj:
        np.testing.assert_allclose(ri[k].numpy(), np.asarray(rj[k]))
