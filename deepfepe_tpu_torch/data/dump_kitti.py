"""Offline dump creation: frames and poses -> the dump tree the loader reads.

Counterpart of `deepfepe_tpu/data/dump_kitti.py` in three parts:

- the SIFT dump (`sift_detect`, `knn_match`, `match_pair`,
  `dump_sequence`, `dump_kitti_odometry`): OpenCV's SIFT
  (`cv2.SIFT_create(nfeatures, contrastThreshold=1e-5)`) and two-NN
  matching with Lowe's ratio test (`cv2.BFMatcher().knnMatch(k=2)`) as
  this package computes them (`frontend/sift.py`: the kernels S1, S2a and
  S2b on the card; `ops/knn2.py`: S3), per frame `sift_%06d` ([N, 130]:
  x y + descriptor), per pair `ij_match_quality_{i}-{j}_{all,good}` (ratio
  0.9 and 0.8; [M, 6]: x1 y1 x2 y2, the second distance, the distance
  ratio) and `ij_idx_{i}-{j}_{all,good}_ij`, beside `cam.npy`, `poses.npy`
  and `Rt_cam2_gt.npy`; `dump_kitti_odometry` converts a raw KITTI
  odometry tree (P2 of calib.txt, its cam0 -> cam2 baseline);
- numpy helpers for raw KITTI (OXTS poses, calibration files, velodyne
  clouds in the camera frames, the `X_cam0_%06d` / `X_cam2_%06d` files of
  `with_X`), copied;
- the SuperPoint dump (`sp_detect_frames`, `dump_sequence_sp`) on this
  package's frontend: keypoints of each frame from `run_superpoint` (K5 on
  the card with the conv switch on 'pallas'), mutual-NN matches of each
  pair from `mutual_nn_match` (K4 on the card at K >= 768), in the SIFT
  dump's files.

Frames are read as grey through `utils.image_io` (JPEG or any PNG form, as
`cv2.imread(IMREAD_GRAYSCALE)` reads them) and written as `%06d.jpg` at
quality 95 through the native encoder (`utils.jpeg.write_jpeg`), the bytes
`cv2.imwrite` writes, as the JAX package writes them; the keypoints come
from the frames as read, before the JPEG round trip, in both packages.
The entry points that compute take `device` (None: the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..frontend import sift
from ..frontend.sift import sift_detect  # noqa: F401  (the JAX module's name)
from ..frontend.matching import mutual_nn_match
from ..frontend.pipeline import FrontendParams, run_superpoint
from ..ops.knn2 import knn2, ratio_matches
from ..utils.device import resolve_device
from ..utils.image_io import read_grey
from ..utils.jpeg import write_jpeg
from .kitti import save_arr


# ---------------------------------------------------------------------------
# The SIFT dump.
# ---------------------------------------------------------------------------


def sift_features(img_grey, n_features: int = 2000, device=None):
    """`sift_detect` with the descriptors left on the device: (pts [N, 2]
    float32 numpy, des [N, 128] float32 tensor)."""
    kp, des = sift.detect_and_compute(sift.as_uint8_frame(img_grey), n_features,
                                      resolve_device(device))
    return kp[:, :2].cpu().numpy(), des


def _knn_rows(des1, des2, ratios: Sequence[float], device=None):
    """Lowe's ratio test at each ratio on one two-NN search (S3 on the
    card): a list of (idx [M, 2] int32, quality [M, 2] float32) numpy."""
    dev = resolve_device(device)
    d1, d2 = torch.as_tensor(des1, device=dev), torch.as_tensor(des2, device=dev)
    nn, dist = knn2(d1.float(), d2.float())
    out = []
    for ratio in ratios:
        idx, q = ratio_matches(nn, dist, ratio)
        out.append((idx.cpu().numpy().astype(np.int32), q.cpu().numpy()))
    return out


def knn_match(des1, des2, ratio: float = 0.8, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Two-NN + Lowe's ratio test: (idx pairs [M, 2] int32, quality [M, 2]
    float32: the second distance and d1 / (d2 + 1e-9)), as the JAX
    package's `knn_match` returns them from cv2.BFMatcher, bit for bit."""
    return _knn_rows(des1, des2, (ratio,), device)[0]


def _match_rows(p1, p2, idx, q) -> np.ndarray:
    if len(idx) == 0:
        return np.zeros((0, 6), np.float32)
    return np.concatenate([p1[idx[:, 0]], p2[idx[:, 1]], q], 1).astype(np.float32)


def match_pair(img1: np.ndarray, img2: np.ndarray, ratio_all: float = 0.9,
               ratio_good: float = 0.8, n_features: int = 2000, device=None):
    """Detect + match one frame pair -> (all [Na, 6], good [Ng, 6])."""
    p1, d1 = sift_features(img1, n_features, device)
    p2, d2 = sift_features(img2, n_features, device)
    if len(p1) == 0 or len(p2) == 0:
        z = np.zeros((0, 6), np.float32)
        return z, z
    (ia, qa), (ig, qg) = _knn_rows(d1, d2, (ratio_all, ratio_good), device)
    return _match_rows(p1, p2, ia, qa), _match_rows(p1, p2, ig, qg)


def _save_scene_files(out: Path, K: np.ndarray, poses: np.ndarray,
                      Rt_cam2_gt: Optional[np.ndarray]) -> None:
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "cam.npy", K.astype(np.float32))
    np.save(out / "poses.npy", poses.astype(np.float32))
    np.save(out / "Rt_cam2_gt.npy",
            (Rt_cam2_gt if Rt_cam2_gt is not None else np.eye(4)).astype(np.float64))


def _read_frames(image_files: Sequence[str], out: Path) -> list:
    greys = []
    for i, f in enumerate(image_files):
        img = read_grey(f)
        greys.append(img)
        write_jpeg(out / f"{i:06d}.jpg", img)
    return greys


def dump_sequence(image_files: Sequence[str], poses: np.ndarray, K: np.ndarray, out_dir: str,
                  Rt_cam2_gt: Optional[np.ndarray] = None, delta_ijs: Sequence[int] = (1,),
                  n_features: int = 2000, use_h5: bool = False, device=None) -> None:
    """Write one scene in the reference dump layout with the SIFT frontend:
    the frames as `%06d.jpg`, `sift_%06d` ([N, 130]: x y + descriptor) a
    frame, and for each pair (i, i + delta) the ratio-0.9 ('all') and
    ratio-0.8 ('good') matches ([M, 6]: x1 y1 x2 y2, the second distance,
    the distance ratio) with their index pairs into the sift files.
    `use_h5`: the per-frame and per-pair files as .h5 (dataset 'arr')."""
    out = Path(out_dir)
    _save_scene_files(out, K, poses, Rt_cam2_gt)
    greys = _read_frames(image_files, out)
    feats = [sift_features(g, n_features, device) for g in greys]
    for i, (p, d) in enumerate(feats):
        save_arr(out / f"sift_{i:06d}", np.concatenate([p, d.cpu().numpy()], 1), use_h5)
    for i in range(len(greys)):
        for dij in delta_ijs:
            j = i + dij
            if j >= len(greys) or len(feats[i][0]) == 0 or len(feats[j][0]) == 0:
                continue
            (p1, d1), (p2, d2) = feats[i], feats[j]
            for kind, (idx, q) in zip(("all", "good"), _knn_rows(d1, d2, (0.9, 0.8), device)):
                save_arr(out / f"ij_match_quality_{i}-{j}_{kind}", _match_rows(p1, p2, idx, q),
                         use_h5)
                save_arr(out / f"ij_idx_{i}-{j}_{kind}_ij", idx.astype(np.int32), use_h5)


def read_p2(calib_path) -> Tuple[np.ndarray, np.ndarray]:
    """K and the cam0 -> cam2 offset [4, 4] from a KITTI odometry calib.txt's
    P2 row (K^-1 of P2's last column)."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith("P2:"):
                P = np.array(line[3:].split(), np.float64).reshape(3, 4)
                Rt_cam2 = np.eye(4)
                Rt_cam2[:3, 3] = np.linalg.inv(P[:, :3]) @ P[:, 3]
                return P[:, :3], Rt_cam2
    raise ValueError(f"no P2 in {calib_path}")


def dump_kitti_odometry(kitti_root: str, out_root: str, sequences: Sequence[str],
                        delta_ijs: Sequence[int] = (1,), cam: str = "image_2",
                        device=None) -> None:
    """Convert a standard KITTI odometry tree into the SIFT dump tree:
    {kitti_root}/sequences/NN/{cam}/*.png (or .jpg), sequences/NN/calib.txt
    and poses/NN.txt -> {out_root}/NN/."""
    for seq in sequences:
        seq_dir = Path(kitti_root) / "sequences" / seq
        imgs = sorted((seq_dir / cam).glob("*.png")) + sorted((seq_dir / cam).glob("*.jpg"))
        poses = np.genfromtxt(Path(kitti_root) / "poses" / f"{seq}.txt").reshape(-1, 3, 4)
        K, Rt_cam2 = read_p2(seq_dir / "calib.txt")
        dump_sequence([str(p) for p in imgs], poses, K, str(Path(out_root) / seq),
                      Rt_cam2_gt=Rt_cam2, delta_ijs=delta_ijs, device=device)


# ---------------------------------------------------------------------------
# Raw KITTI: OXTS poses, calibration, velodyne clouds (host-side numpy).
# ---------------------------------------------------------------------------

EARTH_RADIUS_M = 6378137.0


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def pose_from_oxts_packet(lat: float, lon: float, alt: float, roll: float, pitch: float,
                          yaw: float, scale: float) -> np.ndarray:
    """OXTS GPS/IMU packet -> SE(3) pose [4, 4] (Mercator translation, ZYX
    Euler rotation); `scale` = cos(lat0 pi / 180) of the first packet."""
    ty = lat * np.pi * EARTH_RADIUS_M / 180.0
    tx = scale * lon * np.pi * EARTH_RADIUS_M / 180.0
    T = np.eye(4)
    T[:3, :3] = _rot_z(yaw) @ _rot_y(pitch) @ _rot_x(roll)
    T[:3, 3] = (tx, ty, alt)
    return T


def oxts_to_poses(packets: np.ndarray) -> np.ndarray:
    """[N, 6] (lat lon alt roll pitch yaw) -> [N, 4, 4] poses relative to the
    first frame."""
    packets = np.asarray(packets, np.float64)
    scale = np.cos(packets[0, 0] * np.pi / 180.0)
    Ts = np.stack([pose_from_oxts_packet(*p, scale) for p in packets])
    return np.linalg.inv(Ts[0]) @ Ts


def read_calib_file(path: str) -> dict:
    """KITTI calib .txt -> {key: float array, or the text where not numeric}."""
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array([float(v) for v in value.split()])
            except ValueError:
                data[key.strip()] = value.strip()
    return data


def velo_to_cam_points(velo_xyz: np.ndarray, Tr_velo_to_cam: np.ndarray, R_rect: np.ndarray,
                       Rt_cam2: Optional[np.ndarray] = None, K: Optional[np.ndarray] = None,
                       image_hw: Optional[Tuple[int, int]] = None):
    """Velodyne scan [N, 3] -> (X_cam0 [M, 3] rectified cam0, X_cam2 [M, 3]):
    X_cam0 = R_rect Tr X_velo, X_cam2 = Rt_cam2 X_cam0, points in front of
    the camera, and with K and image_hw only those inside the cam2 image."""
    velo_xyz = np.asarray(velo_xyz, np.float64)
    Tr = np.asarray(Tr_velo_to_cam, np.float64)
    if Tr.shape == (3, 4):
        Tr = np.vstack([Tr, [0, 0, 0, 1.0]])
    R4 = np.eye(4)
    R4[:3, :3] = R_rect
    X_h = np.concatenate([velo_xyz, np.ones((len(velo_xyz), 1))], 1)
    X0_h = (R4 @ Tr @ X_h.T).T
    X0 = X0_h[:, :3] / X0_h[:, 3:4]
    Rt2 = np.eye(4) if Rt_cam2 is None else np.asarray(Rt_cam2, np.float64)
    X2_h = (Rt2 @ X0_h.T).T
    X2 = X2_h[:, :3] / X2_h[:, 3:4]
    keep = X2[:, 2] > 0
    if K is not None and image_hw is not None:
        x = X2[keep] @ np.asarray(K, np.float64).T
        px = x[:, :2] / x[:, 2:3]
        H, W = image_hw
        inview = (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        idx = np.flatnonzero(keep)
        keep = np.zeros(len(X2), bool)
        keep[idx[inview]] = True
    return X0[keep], X2[keep]


def dump_lidar_frames(velo_scans, Tr_velo_to_cam: np.ndarray, R_rect: np.ndarray, out_dir: str,
                      Rt_cam2: Optional[np.ndarray] = None, K: Optional[np.ndarray] = None,
                      image_hw: Optional[Tuple[int, int]] = None, use_h5: bool = False) -> int:
    """Write X_cam0_%06d / X_cam2_%06d for each scan ([N, 3] or [N, 4]);
    returns the frame count."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for i, scan in enumerate(velo_scans):
        X0, X2 = velo_to_cam_points(np.asarray(scan)[:, :3], Tr_velo_to_cam, R_rect,
                                    Rt_cam2=Rt_cam2, K=K, image_hw=image_hw)
        save_arr(out / f"X_cam0_{i:06d}", X0.astype(np.float32), use_h5)
        save_arr(out / f"X_cam2_{i:06d}", X2.astype(np.float32), use_h5)
        n += 1
    return n


# ---------------------------------------------------------------------------
# The SuperPoint dump.
# ---------------------------------------------------------------------------


@torch.no_grad()
def sp_detect_frames(greys, net, out_num_points: int = 1000, conf_thresh: float = 1e-3,
                     conv_impl: str | None = None):
    """SuperPoint keypoints of each frame ([H, W] grey, uint8 or in [0, 1]),
    one frame a call on the net's device: a list of (pts [Ni, 2] float32,
    desc [Ni, D] float32) of the valid keypoints. `conv_impl` is the
    fused forward's conv switch ('pallas': K5 on the card)."""
    fp = FrontendParams(out_num_points=out_num_points, conf_thresh=conf_thresh,
                        conv_impl=conv_impl)
    device = next(net.parameters()).device
    out = []
    for g in greys:
        img = np.asarray(g, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        kp = run_superpoint(net, torch.as_tensor(img, device=device)[None], fp)
        valid = kp.valid[0]
        pts = (kp.xy[0] + kp.offsets[0])[valid]
        out.append((pts.float().cpu().numpy(), kp.desc[0][valid].float().cpu().numpy()))
    return out


@torch.no_grad()
def match_frames(feats, i: int, j: int, nn_thresh: float, device) -> tuple:
    """Mutual-NN matches of frames i and j, their keypoints padded to the
    scene's largest count: [M, 6] rows (x1 y1 x2 y2, quality = 300 x the
    descriptor distance, the distance) and the index pairs [M, 2]."""
    K_pad = max(len(p) for p, _ in feats)
    (p1, d1), (p2, d2) = feats[i], feats[j]

    def pad(p, d):
        k = K_pad - len(p)
        return (torch.as_tensor(np.pad(d, ((0, k), (0, 0))), device=device)[None],
                torch.as_tensor(np.arange(K_pad) < len(p), device=device)[None])

    (d1p, v1), (d2p, v2) = pad(p1, d1), pad(p2, d2)
    m = mutual_nn_match(d1p, d2p, v1, v2, nn_thresh=nn_thresh)
    keep = m.valid[0].cpu().numpy()
    i1 = m.idx1[0].cpu().numpy()[keep]
    i2 = m.idx2[0].cpu().numpy()[keep]
    scores = m.scores[0].float().cpu().numpy()[keep]
    mat = np.concatenate([p1[i1], p2[i2], (scores * 300.0)[:, None], scores[:, None]],
                         1).astype(np.float32)
    return mat, np.stack([i1, i2], 1).astype(np.int32)


def dump_sequence_sp(image_files: Sequence[str], poses: np.ndarray, K: np.ndarray,
                     out_dir: str, net, Rt_cam2_gt: Optional[np.ndarray] = None,
                     delta_ijs: Sequence[int] = (1,), out_num_points: int = 1000,
                     nn_thresh: float = 1.0, use_h5: bool = False,
                     conv_impl: str | None = None) -> None:
    """Write one scene in the reference dump layout with a SuperPoint
    frontend (`net`, on its device): the frames as `%06d.jpg`, per-frame
    keypoints and descriptors (`sift_%06d`: x y + descriptor), and per pair
    the mutual-NN matches with quality col 0 = 300 x the descriptor
    distance (the loader's /300 returns the distance) as both the 'all'
    and the 'good' set."""
    out = Path(out_dir)
    _save_scene_files(out, K, poses, Rt_cam2_gt)
    greys = _read_frames(image_files, out)
    feats = sp_detect_frames(greys, net, out_num_points=out_num_points, conv_impl=conv_impl)
    for i, (p, d) in enumerate(feats):
        save_arr(out / f"sift_{i:06d}", np.concatenate([p, d], 1), use_h5)
    device = next(net.parameters()).device
    for i in range(len(greys)):
        for dij in delta_ijs:
            j = i + dij
            if j >= len(greys) or len(feats[i][0]) == 0 or len(feats[j][0]) == 0:
                continue
            mat, idx = match_frames(feats, i, j, nn_thresh, device)
            for kind in ("all", "good"):
                save_arr(out / f"ij_match_quality_{i}-{j}_{kind}", mat, use_h5)
                save_arr(out / f"ij_idx_{i}-{j}_{kind}_ij", idx, use_h5)
