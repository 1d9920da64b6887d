"""Port parity: the SIFT frontend (`frontend/sift.py`, `ops/sift.py`,
`native/keypoint_filter.cpp`) and the two-NN matcher (`ops/knn2.py`)
against the JAX package's `sift_detect` and `knn_match`, which call
OpenCV (cv2.SIFT_create(nfeatures, contrastThreshold=1e-5) and
cv2.BFMatcher().knnMatch(k=2)).

- The blur: `gaussian_taps` equal `cv2.getGaussianKernel` at every size
  and sigma the pyramid uses, and `gaussian_blur` equals
  `cv2.GaussianBlur` bit for bit (OpenCV's AVX2 separable filter sums in
  fused multiply-adds, which the port emulates). A plain float32 blur
  meets the bars below but moves rows out of OpenCV's order
  (`tools/sift_blur_study.py`).
- The plain route against cv2 on every fixture case (tests/fixtures/sift:
  the KITTI frame and two 376x1240 synthetic frames, at n_features 2000
  and 300), at `frontend.sift.PARITY_BARS`: counts within 1.5%, 98.5% of
  each list paired within 0.01 px and 0.1 deg, 99% of paired descriptor
  rows within 2 in every entry. (Measured: equal counts in OpenCV's order,
  every keypoint paired, every entry within 1.) The fixtures are
  `sift_detect`'s results, and cv2's results now.
- The order step, fed OpenCV's own keypoints (all of them, at the doubled
  scale, with duplicates added) shuffled, returns OpenCV's rows in its
  order and count at n_features 2000 and 300.
- `knn2` + `ratio_matches` equal `knn_match` bit for bit, planted ties
  included; the ratio-0.8 matches of a synthetic pair share 97% of the
  larger set with the JAX package's.
- An empty (constant) frame gives no keypoints in both packages; a frame
  in [0, 1] is scaled by 255 as the JAX package scales it.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from deepfepe_tpu.data import dump_kitti as j_dump
from deepfepe_tpu_torch.data import dump_kitti as t_dump
from deepfepe_tpu_torch.frontend import sift
from deepfepe_tpu_torch.ops import knn2 as knn2_ops
from deepfepe_tpu_torch.ops import sift as sift_ops
from deepfepe_tpu_torch.utils.image_io import read_grey

from _torch_threads import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "sift")
FRAMES = ("kitti", "synthetic0", "synthetic1")
CASES = [(f, n) for f in FRAMES for n in (2000, 300)]


def _fixture(case, n):
    z = np.load(os.path.join(FIX, f"{case}_{n}.npz"))
    return z["kp"], z["des"].astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    return {f: read_grey(os.path.join(FIX, f"{f}.png")) for f in FRAMES}


@pytest.fixture(scope="module")
def port(frames):
    out = {}
    for case, n in CASES:
        kp, des = sift.detect_and_compute(frames[case], n, "cpu")
        out[case, n] = kp.numpy(), des.numpy()
    return out


@pytest.mark.parametrize("sigma", [float(s) for s in sift.layer_sigmas()[1:]] + [1.2489996])
def test_gaussian_taps_equal_cv2(sigma):
    k = sift.blur_ksize(sigma)
    want = cv2.getGaussianKernel(k, sigma, cv2.CV_32F).ravel()
    np.testing.assert_array_equal(sift.gaussian_taps(k, sigma), want)


@pytest.mark.parametrize("shape", [(37, 53), (47, 155), (4, 9), (1, 3), (3, 1)])
def test_gaussian_blur_equals_cv2(shape):
    """Bit for bit but where the float64 emulation of a fused multiply-add
    rounds twice (one element in 7,285 at 47x155), and then by one ulp."""
    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    for sigma in sift.layer_sigmas()[1:]:
        got = sift.gaussian_blur(torch.as_tensor(img), sigma).numpy()
        want = cv2.GaussianBlur(img, (0, 0), sigma, sigma)
        ulps = np.abs(got.view(np.int32) - want.view(np.int32))
        assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.999, (sigma, ulps.max())


def test_opencv_blur_order_keeps_opencv_rows_in_place():
    """`tools/sift_blur_study.py` on the KITTI frame at n_features 300: a
    plain float32 blur meets PARITY_BARS but moves rows (the loaders pick
    rows by number), OpenCV's order of sums keeps every row in place."""
    from deepfepe_tpu_torch.tools import sift_blur_study

    rows = {r["blur"]: r for r in sift_blur_study.study(torch.device("cpu"), frames=("kitti",),
                                                       n_features=(300,))}
    assert rows["opencv_order"]["ok"] and rows["plain"]["ok"]
    assert rows["opencv_order"]["in_place"] == 1.0 > rows["plain"]["in_place"]


def test_fixtures_are_cv2s(frames):
    for case, n in (("kitti", 2000), ("synthetic0", 300)):
        kps, des = cv2.SIFT_create(nfeatures=n, contrastThreshold=1e-5).detectAndCompute(
            frames[case], None)
        kp, d = _fixture(case, n)
        np.testing.assert_array_equal(kp[:, :2], np.float32([k.pt for k in kps]))
        np.testing.assert_array_equal(d, des)
        pts, jdes = j_dump.sift_detect(frames[case], n)
        np.testing.assert_array_equal(pts, kp[:, :2])
        np.testing.assert_array_equal(jdes, d)


@pytest.mark.parametrize("case,n", CASES)
def test_plain_route_matches_cv2(port, case, n):
    kp, des = port[case, n]
    want_kp, want_des = _fixture(case, n)
    r = sift.compare_keypoints(kp, des, want_kp, want_des)
    assert r["ok"], r
    assert des.dtype == np.float32 and ((des >= 0) & (des <= 255) & (des == np.rint(des))).all()


@pytest.mark.parametrize("case", FRAMES)
def test_sift_detect_matches_jax(frames, port, case):
    pts, des = t_dump.sift_detect(frames[case], 2000, device="cpu")
    np.testing.assert_array_equal(pts, port[case, 2000][0][:, :2])
    jpts, jdes = j_dump.sift_detect(frames[case], 2000)
    assert abs(len(pts) - len(jpts)) <= sift.PARITY_BARS["count_rel"] * len(jpts)
    near = np.hypot(pts[:, None, 0] - jpts[None, :, 0], pts[:, None, 1] - jpts[None, :, 1])
    assert (near.min(1) <= 0.01).mean() >= sift.PARITY_BARS["paired"]


def _cv2_all(img):
    """OpenCV's keypoints before retainBest (nfeatures 0), back at the
    doubled image's scale the order step works at."""
    kps = cv2.SIFT_create(nfeatures=0, contrastThreshold=1e-5).detect(img, None)
    kp = np.array([[k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave] for k in kps],
                  np.float64)
    octave = kp[:, 5].astype(np.int64)
    kp[:, :3] *= 2
    kp[:, 5] = (octave & ~255) | ((octave + 1) & 255)
    return kp.astype(np.float32)


@pytest.mark.parametrize("n", [2000, 1500, 300])
def test_order_step_returns_cv2_order(frames, n):
    img = frames["synthetic1"]
    full = _cv2_all(img)
    rng = np.random.RandomState(n)
    fed = np.concatenate([full, full[rng.choice(len(full), 40)]])  # duplicates to drop
    fed = fed[rng.permutation(len(fed))]
    kept = sift_ops.order_keypoints(torch.as_tensor(fed), n)
    got = sift.half_scale(torch.as_tensor(fed)[kept]).numpy()
    kps = cv2.SIFT_create(nfeatures=n, contrastThreshold=1e-5).detect(img, None)
    want = np.array([[k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave] for k in kps],
                    np.float32)
    assert len(want) >= min(n, len(full))  # retainBest keeps the n-th response's ties
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n1,n2", [(400, 500), (300, 2), (300, 1), (5, 0), (0, 5)])
def test_knn_match_equals_jax_bit_for_bit(n1, n2):
    rng = np.random.RandomState(n1 + 7 * n2)
    d1 = rng.randint(0, 40, (n1, 128)).astype(np.float32)
    d2 = rng.randint(0, 40, (n2, 128)).astype(np.float32)
    if n2 > 10:  # exact ties: equal train rows, and queries equal to them
        d2[3:7] = d2[2]
        d1[:4] = d2[2]
        d1[4:8] = d2[2] + 1
    if n1 > 10 and n2 > 10:  # near copies, so the ratio test passes for many rows
        d1[10:] = d2[rng.randint(0, n2, n1 - 10)] + rng.randint(-2, 3, (n1 - 10, 128))
    for ratio in (0.8, 0.9):
        idx, q = t_dump.knn_match(d1, d2, ratio, device="cpu")
        jidx, jq = j_dump.knn_match(d1, d2, ratio)
        assert idx.dtype == jidx.dtype and q.dtype == jq.dtype
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(q.view(np.int32), jq.view(np.int32))


def test_knn2_ties_go_to_the_lower_index():
    d2 = np.zeros((6, 128), np.float32)
    d2[1:] = 3.0
    d2[4] = 1.0
    d1 = np.full((2, 128), 2.0, np.float32)
    nn, dist = knn2_ops.knn2(torch.as_tensor(d1), torch.as_tensor(d2))
    assert nn.tolist() == [[1, 2], [1, 2]]  # |2 - 1| = |2 - 3|: rows 1, 2, 3, 4, 5 tie
    m = cv2.BFMatcher().knnMatch(d1, d2, k=2)
    assert [[x.trainIdx for x in p] for p in m] == nn.tolist()
    np.testing.assert_array_equal(dist.numpy(), np.float32([[x.distance for x in p] for p in m]))


def test_knn2_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        knn2_ops.launch(torch.zeros(3, 128), torch.zeros(4, 128))
    with pytest.raises(ValueError, match="128"):
        knn2_ops.launch(torch.zeros(3, 64), torch.zeros(4, 64))


def test_ratio_matches_shared_with_jax(frames):
    f0, f1 = frames["synthetic0"], frames["synthetic1"]
    good = t_dump.match_pair(f0, f1, device="cpu")[1]
    jgood = j_dump.match_pair(f0, f1)[1]
    assert len(jgood) > 200

    # A row of one is shared when the other has a row within 0.01 px in x1 y1 x2 y2.
    near = np.abs(good[:, None, :4] - jgood[None, :, :4]).max(-1) <= 0.01
    shared = min(near.any(1).sum(), near.any(0).sum())
    assert shared >= 0.97 * max(len(good), len(jgood)), (shared, len(good), len(jgood))


@pytest.mark.parametrize("value", [0, 7, 255])
def test_constant_frame_has_no_keypoints(value):
    img = np.full((64, 80), value, np.uint8)
    pts, des = t_dump.sift_detect(img, device="cpu")
    jpts, jdes = j_dump.sift_detect(img)
    assert pts.shape == jpts.shape == (0, 2) and des.shape == jdes.shape == (0, 128)


def test_unit_range_frames_are_scaled_by_255(frames):
    img = frames["kitti"][:120, :200]
    unit = img.astype(np.float64) / 255.0
    pts, des = t_dump.sift_detect(unit, 300, device="cpu")
    np.testing.assert_array_equal(sift.as_uint8_frame(unit), img)
    jpts, jdes = j_dump.sift_detect(unit, 300)
    r = sift.compare_keypoints(np.c_[pts, np.zeros((len(pts), 4))], des,
                               np.c_[jpts, np.zeros((len(jpts), 4))], jdes)
    assert r["ok"], r
    # A uint8 frame whose maximum is 1 is scaled too (the JAX package's
    # max() <= 1.0 test), so a 0/1 mask reads as 0/255.
    mask = (img > 128).astype(np.uint8)
    np.testing.assert_array_equal(sift.as_uint8_frame(mask), mask * 255)
    assert len(t_dump.sift_detect(mask, 300, device="cpu")[0]) == len(j_dump.sift_detect(mask,
                                                                                          300)[0])
