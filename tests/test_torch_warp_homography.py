"""Port parity: `utils/warp.py` and `geometry/homography.py`, and the numpy
stand-ins for OpenCV's perspective transform and warp.

- `fit_affine`, `vec2mtrx`, `mtrx2vec`, `compose`, `inverse`,
  `bilinear_sample` and `transform_image` against the JAX package's
  `utils/warp.py` (vmapped where the port batches) on the same float64
  inputs: 1e-12.
- `homography_from_points` (also weighted) and
  `homography_transfer_error` against `deepfepe_tpu.geometry.homography`:
  1e-9.
- `get_perspective_transform` against `cv2.getPerspectiveTransform`: 1e-9
  relative; `warp_perspective` against `cv2.warpPerspective` on float32
  images (noise, a synthetic frame, three channels), at homographies that
  move the corners by up to 8%, 30% and 60% of the frame (part of it
  mapped outside): max abs 1e-5; on noise frames at 376x1240 and 120x100
  (widths 8 and 4 past a multiple of 16, so cv2's scalar tail) the whole
  frame bit for bit.
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.geometry import homography as jh
from deepfepe_tpu.utils import warp as jw
from deepfepe_tpu_torch.data import SyntheticImagePairs
from deepfepe_tpu_torch.geometry import homography as th
from deepfepe_tpu_torch.utils import warp as tw

from _torch_threads import one_torch_thread  # noqa: F401

WARP_TOL = 1e-12
H_TOL = 1e-9
TYPES = ("translation", "similarity", "affine", "homography")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor)
                                          else b), np.asarray(a), rtol=tol, atol=tol)


def _homographies(rng, n, scale, size=(120, 160)):
    """n random homographies that move a frame's corners by up to `scale`
    of its size (the val_feature --homography family at scale 0.08)."""
    Hh, Ww = size
    src = np.array([[0, 0], [Ww, 0], [0, Hh], [Ww, Hh]], np.float32)
    out = []
    for _ in range(n):
        dst = (src + rng.uniform(-scale, scale, (4, 2)) * [Ww, Hh]).astype(np.float32)
        out.append(cv2.getPerspectiveTransform(src, dst))
    return np.stack(out)


@pytest.mark.parametrize("warp_type", TYPES)
def test_warp_parameters_match_jax(rng, warp_type):
    k = {"translation": 2, "similarity": 4, "affine": 6, "homography": 8}[warp_type]
    p = 0.1 * rng.randn(5, k)
    dp = 0.1 * rng.randn(5, k)
    _close(jw.vec2mtrx(jnp.asarray(p), warp_type), tw.vec2mtrx(_t(p), warp_type), WARP_TOL)
    M = np.asarray(jw.vec2mtrx(jnp.asarray(p), warp_type))
    _close(jw.mtrx2vec(jnp.asarray(M), warp_type), tw.mtrx2vec(_t(M), warp_type), WARP_TOL)
    _close(jw.compose(jnp.asarray(p), jnp.asarray(dp), warp_type),
           tw.compose(_t(p), _t(dp), warp_type), WARP_TOL)
    _close(jw.inverse(jnp.asarray(p), warp_type), tw.inverse(_t(p), warp_type), WARP_TOL)


def test_fit_affine_matches_jax(rng):
    src = rng.rand(30, 2) * 100
    A = np.array([[1.1, 0.2, 3.0], [-0.1, 0.9, -2.0], [0, 0, 1]])
    dst = src @ A[:2, :2].T + A[:2, 2] + 0.01 * rng.randn(30, 2)
    want = jw.fit_affine(jnp.asarray(src), jnp.asarray(dst))
    got = tw.fit_affine(_t(src), _t(dst))
    _close(want, got, WARP_TOL)
    assert got.dtype == torch.float64


def test_bilinear_sample_and_transform_image_match_jax(rng):
    """Batched over a leading dim where the JAX callers vmap; grids and
    warps that reach outside the image (the zero neighbours)."""
    img = rng.rand(3, 24, 32, 2)
    grid = rng.uniform(-3, 35, (3, 10, 12, 2))
    want = jax.vmap(jw.bilinear_sample)(jnp.asarray(img), jnp.asarray(grid))
    _close(want, tw.bilinear_sample(_t(img), _t(grid)), WARP_TOL)
    Hs = _homographies(rng, 3, 0.3, size=(24, 32))
    want = jax.vmap(jw.transform_image)(jnp.asarray(img), jnp.asarray(Hs))
    got = tw.transform_image(_t(img), _t(Hs))
    _close(want, got, WARP_TOL)
    assert float(np.abs(np.asarray(want)).min()) == 0.0  # part of each view is outside
    # One warp for the whole batch, and one image alone.
    want = jax.vmap(lambda im: jw.transform_image(im, jnp.asarray(Hs[0])))(jnp.asarray(img))
    _close(want, tw.transform_image(_t(img), _t(Hs[0])), WARP_TOL)
    _close(jw.transform_image(jnp.asarray(img[1]), jnp.asarray(Hs[1])),
           tw.transform_image(_t(img[1]), _t(Hs[1])), WARP_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_from_points_matches_jax(rng, weighted):
    Hs = _homographies(rng, 4, 0.2)
    x1 = rng.rand(4, 40, 2) * [160, 120]
    x1h = np.concatenate([x1, np.ones((4, 40, 1))], -1) @ np.swapaxes(Hs, -1, -2)
    x2 = x1h[..., :2] / x1h[..., 2:] + 0.3 * rng.randn(4, 40, 2)
    w = rng.rand(4, 40) if weighted else None
    want = jh.homography_from_points(jnp.asarray(x1), jnp.asarray(x2),
                                     None if w is None else jnp.asarray(w))
    got = th.homography_from_points(_t(x1), _t(x2), None if w is None else _t(w))
    _close(want, got, H_TOL)
    _close(jh.homography_transfer_error(want, jnp.asarray(x1), jnp.asarray(x2)),
           th.homography_transfer_error(got, _t(x1), _t(x2)), H_TOL)
    if not weighted:  # the noisy fit is near the generating homography
        assert np.abs(got.numpy() - Hs).max() < 0.05 * np.abs(Hs).max()


def test_get_perspective_transform_matches_cv2(rng):
    Ww, Hh = 160, 120
    src = np.array([[0, 0], [Ww, 0], [0, Hh], [Ww, Hh]], np.float32)
    for scale in (0.08, 0.3, 0.6):
        for _ in range(5):
            pert = rng.uniform(-scale, scale, (4, 2)) * [Ww, Hh]
            dst = (src + pert).astype(np.float32)
            want = cv2.getPerspectiveTransform(src, dst)
            got = tw.get_perspective_transform(src, dst)
            assert got.dtype == np.float64 and got[2, 2] == 1.0
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("image", ["noise", "synthetic", "three_channels"])
def test_warp_perspective_matches_cv2(rng, image):
    if image == "synthetic":
        img = SyntheticImagePairs(seed=100).batch(1)["imgs_grey"][0, 0].astype(np.float32)
    else:
        img = rng.rand(120, 160).astype(np.float32)
        if image == "three_channels":
            img = np.stack([img, 0.5 * img, 1.0 - img], -1)
    Hh, Ww = img.shape[:2]
    outside = 0
    for scale in (0.08, 0.3, 0.6):
        for H in _homographies(rng, 3, scale):
            want = cv2.warpPerspective(img, H, (Ww, Hh))
            got = tw.warp_perspective(img, H, (Ww, Hh))
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            outside += int((want == 0).sum())
    assert outside > 0


@pytest.mark.parametrize("size", [(376, 1240), (120, 100)])
def test_warp_perspective_bitwise_cv2_at_any_width(rng, size):
    Hh, Ww = size
    img = rng.rand(Hh, Ww).astype(np.float32)
    for scale in (0.08, 0.3):
        for H in _homographies(rng, 2, scale, size=size):
            want = cv2.warpPerspective(img, H, (Ww, Hh))
            got = tw.warp_perspective(img, H, (Ww, Hh))
            assert np.array_equal(got, want), np.abs(got - want).max()
