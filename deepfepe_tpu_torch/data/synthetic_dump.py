"""A correspondence dump tree from known geometry, in the reference layout.

No KITTI data ships with the repository, so the loader, the CLI over dump
trees and the card's smoke run on trees written here: scenes of a
KITTI-like trajectory (about 1 m forward a frame, small rotations) seen by
a camera with KITTI's intrinsics and its cam0 -> cam2 offset, and per
consecutive pair the projections of random 3D points, with Gaussian pixel
noise and a share of outliers, in the `ij_match_quality_{i}-{j}_{good,all}`
files that `data.kitti.KittiCorrDataset` reads (two quality columns, as the
reference's SIFT dumps carry). `deltas` adds the pairs (i, i + delta) of
wider gaps (the reference's trees carry delta 1, 2, 3, 5, 8 and 10), each
gap from its own RandomState, so the delta-1 files do not depend on them. Optional extras: per-frame descriptor
files with match indices (`with_sift_des`) and lidar clouds (`with_X`).

    python -m deepfepe_tpu_torch.data.synthetic_dump OUT_DIR [--scenes 2]
        [--frames 11] [--matches 1200] [--noise_px 0.5] [--outlier_frac 0.15]
        [--seed 0] [--deltas 1,2]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from .kitti import rt_pad_np
from .synthetic import _random_rotation

KITTI_K = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]])
# KITTI's rectified cam0 -> cam2 transform: a 6 cm baseline.
KITTI_RT_CAM2 = np.array([[1.0, 0, 0, 0.0597], [0, 1.0, 0, -0.0004], [0, 0, 1.0, 0.0027],
                          [0, 0, 0, 1.0]])


def trajectory(rng: np.random.RandomState, n_frames: int) -> np.ndarray:
    """[n, 3, 4] cam0-to-world poses of a forward drive: each step ~1 m
    along +z with up to 1.5 deg of rotation."""
    poses = [np.eye(4)]
    for _ in range(n_frames - 1):
        T = np.eye(4)
        T[:3, :3] = _random_rotation(rng, 1.5)
        T[:3, 3] = (rng.randn() * 0.03, rng.randn() * 0.01, -(0.8 + 0.4 * rng.rand()))
        poses.append(poses[-1] @ np.linalg.inv(T))
    return np.stack([p[:3] for p in poses])


def pair_matches(rng: np.random.RandomState, rel: np.ndarray, K: np.ndarray, n: int,
                 image_size: Tuple[int, int], noise_px: float, outlier_frac: float
                 ) -> np.ndarray:
    """[n, 6] rows x1 y1 x2 y2 q0 q1 of points seen in both frames of the
    camera-frame relative pose `rel` ([4, 4], x2 = R x1 + t); the last
    `outlier_frac` of the rows have a random second point."""
    H, W = image_size
    rows = []
    while sum(len(r) for r in rows) < n:
        X1 = np.stack([rng.uniform(-20, 20, 4 * n), rng.uniform(-3, 2, 4 * n),
                       rng.uniform(4, 60, 4 * n)], -1)
        X2 = X1 @ rel[:3, :3].T + rel[:3, 3]
        x1 = X1 @ K.T
        x2 = X2 @ K.T
        ok = (X1[:, 2] > 1) & (X2[:, 2] > 1)
        x1 = x1[ok, :2] / x1[ok, 2:]
        x2 = x2[ok, :2] / x2[ok, 2:]
        inside = ((x1 >= 0) & (x1 < (W, H))).all(-1) & ((x2 >= 0) & (x2 < (W, H))).all(-1)
        rows.append(np.concatenate([x1[inside], x2[inside]], 1))
    m = np.concatenate(rows)[:n]
    m += rng.randn(*m.shape) * noise_px
    n_out = int(round(outlier_frac * n))
    if n_out:
        m[n - n_out:, 2] = rng.uniform(0, W, n_out)
        m[n - n_out:, 3] = rng.uniform(0, H, n_out)
    # SIFT-like quality: a descriptor distance (the loader divides col 0
    # by 300) and a ratio, worse for the outliers.
    q0 = rng.uniform(50, 250, n) + 150 * (np.arange(n) >= n - n_out)
    q1 = rng.uniform(0.3, 0.8, n)
    return np.concatenate([m, q0[:, None], q1[:, None]], 1).astype(np.float32)


def _write_pair(scene: Path, rng: np.random.RandomState, P: np.ndarray, i: int, j: int,
                matches: int, image_size: Tuple[int, int], noise_px: float,
                outlier_frac: float, extra_all: int, with_sift_des: bool) -> None:
    """The match files of frames (i, j) of a scene with cam0 poses P."""
    rel0 = np.linalg.inv(rt_pad_np(P[j])) @ rt_pad_np(P[i])
    rel = KITTI_RT_CAM2 @ rel0 @ np.linalg.inv(KITTI_RT_CAM2)  # the cam2 frame
    good = pair_matches(rng, rel, KITTI_K, matches, image_size, noise_px, outlier_frac)
    H, W = image_size
    extra = np.concatenate([rng.uniform(0, W, (extra_all, 1)), rng.uniform(0, H, (extra_all, 1)),
                            rng.uniform(0, W, (extra_all, 1)), rng.uniform(0, H, (extra_all, 1)),
                            rng.uniform(50, 400, (extra_all, 1)),
                            rng.uniform(0.3, 1.0, (extra_all, 1))], 1)
    np.save(scene / f"ij_match_quality_{i}-{j}_good.npy", good)
    np.save(scene / f"ij_match_quality_{i}-{j}_all.npy",
            np.concatenate([good, extra.astype(np.float32)]))
    if with_sift_des:
        idx = np.stack([rng.permutation(matches), rng.permutation(matches)], 1)
        np.save(scene / f"ij_idx_{i}-{j}_good_ij.npy", idx.astype(np.int32))


def write_corr_dump(root, scenes: int = 2, frames: int = 11, matches: int = 1200,
                    image_size: Tuple[int, int] = (376, 1241), noise_px: float = 0.5,
                    outlier_frac: float = 0.15, seed: int = 0, with_sift_des: bool = False,
                    with_X: bool = False, extra_all: int = 100,
                    deltas: Sequence[int] = (1,)) -> list:
    """Write `scenes` scene directories '00', '01', ... under `root`, each of
    `frames` frames; returns the scene names. The 'all' match files hold the
    good matches and `extra_all` more random rows. Pairs of each gap in
    `deltas` beyond 1 are drawn from RandomState([seed, scene, delta])."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    names = []
    for s in range(scenes):
        scene = root / f"{s:02d}"
        scene.mkdir(parents=True, exist_ok=True)
        names.append(scene.name)
        poses = trajectory(rng, frames)
        np.save(scene / "cam.npy", KITTI_K.astype(np.float32))
        np.save(scene / "poses.npy", poses.astype(np.float32))
        np.save(scene / "Rt_cam2_gt.npy", KITTI_RT_CAM2)
        P = poses.astype(np.float32).astype(np.float64)
        for delta in sorted(set(deltas) | {1}):
            r = rng if delta == 1 else np.random.RandomState([seed, s, delta])
            for i in range(frames - delta):
                _write_pair(scene, r, P, i, i + delta, matches, image_size, noise_px,
                            outlier_frac, extra_all, with_sift_des)
        for f in range(frames):
            if with_sift_des:
                np.save(scene / f"sift_{f:06d}.npy",
                        rng.rand(matches, 2 + 8).astype(np.float32))
            if with_X:
                for cam in ("cam0", "cam2"):
                    np.save(scene / f"X_{cam}_{f:06d}.npy",
                            rng.randn(rng.randint(20, 40), 3).astype(np.float32))
    return names


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--matches", type=int, default=1200)
    ap.add_argument("--noise_px", type=float, default=0.5)
    ap.add_argument("--outlier_frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deltas", default="1", help="comma list of frame gaps to write")
    args = ap.parse_args(argv)
    names = write_corr_dump(args.out_dir, args.scenes, args.frames, args.matches,
                            noise_px=args.noise_px, outlier_frac=args.outlier_frac,
                            seed=args.seed,
                            deltas=tuple(int(d) for d in args.deltas.split(",")))
    print(f"wrote scenes {names} under {args.out_dir}")


if __name__ == "__main__":
    main()
