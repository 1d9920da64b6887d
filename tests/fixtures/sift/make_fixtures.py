"""Write OpenCV's SIFT results that the card checks the port against.

    python tests/fixtures/sift/make_fixtures.py

Needs OpenCV (cv2) and the repository's packages. For each frame (the
committed KITTI frame tests/fixtures/image_io/kitti_grey_q95.jpg as read by
cv2.imread(IMREAD_GRAYSCALE), and frames 0 and 1 of a 376x1240
SyntheticImageSequence with seed 1 and 400 corners, as uint8 of rint(255
x frame)) it writes the frame as `<case>.png` and, for n_features 2000 and
300, `<case>_<n>.npz` with cv2.SIFT_create(nfeatures=n,
contrastThreshold=1e-5).detectAndCompute's keypoints `kp` float32 [N, 6]
(x, y, size, angle, response, packed octave) in OpenCV's order and
descriptors `des` uint8 [N, 128]; `cv2.npz` records the OpenCV version.
"""

import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
N_FEATURES = (2000, 300)


def frames():
    sys.path.insert(0, REPO)
    from deepfepe_tpu_torch.data import SyntheticImageSequence

    kitti = cv2.imread(os.path.join(REPO, "tests", "fixtures", "image_io", "kitti_grey_q95.jpg"),
                       cv2.IMREAD_GRAYSCALE)
    seq = SyntheticImageSequence(n_frames=2, image_size=(376, 1240), seed=1, n_corners=400)
    return {"kitti": kitti, **{f"synthetic{k}": np.rint(seq.frame(k) * 255).astype(np.uint8)
                                for k in range(2)}}


def cv2_sift(img, n):
    kps, des = cv2.SIFT_create(nfeatures=n, contrastThreshold=1e-5).detectAndCompute(img, None)
    kp = np.array([[k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave] for k in kps],
                  np.float32).reshape(-1, 6)
    return kp, np.asarray(des, np.float32).reshape(-1, 128).astype(np.uint8)


def main():
    for case, img in frames().items():
        cv2.imwrite(os.path.join(HERE, f"{case}.png"), img)
        for n in N_FEATURES:
            kp, des = cv2_sift(img, n)
            np.savez_compressed(os.path.join(HERE, f"{case}_{n}.npz"), kp=kp, des=des)
            print(case, n, len(kp))
    np.savez(os.path.join(HERE, "cv2.npz"), version=np.array(cv2.__version__))


if __name__ == "__main__":
    main()
