"""Offline dump creation: frames and poses -> the dump tree the loader reads.

Counterpart of `deepfepe_tpu/data/dump_kitti.py` in two parts:

- numpy helpers for raw KITTI (OXTS poses, calibration files, velodyne
  clouds in the camera frames, the `X_cam0_%06d` / `X_cam2_%06d` files of
  `with_X`), copied;
- the SuperPoint dump (`sp_detect_frames`, `dump_sequence_sp`) on this
  package's frontend: keypoints of each frame from `run_superpoint` (K5 on
  the card with the conv switch on 'pallas'), mutual-NN matches of each
  pair from `mutual_nn_match` (K4 on the card at K >= 768), written as
  `ij_match_quality_{i}-{j}_{all,good}`, `ij_idx_{i}-{j}_{all,good}_ij`
  and `sift_%06d` beside `cam.npy`, `poses.npy` and `Rt_cam2_gt.npy`.

Frames are read as grey through `utils.image_io` (JPEG or any PNG form, as
`cv2.imread(IMREAD_GRAYSCALE)` reads them) and written as `%06d.jpg` at
quality 95 through the native encoder (`utils.jpeg.write_jpeg`), the bytes
`cv2.imwrite` writes, as the JAX package writes them; the keypoints come
from the frames as read, before the JPEG round trip, in both packages.
The SIFT dump (`dump_sequence`) needs OpenCV's SIFT, which the card's
machine does not have: it raises; `dump_kitti_odometry`, which drives it,
is left out.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..frontend.matching import mutual_nn_match
from ..frontend.pipeline import FrontendParams, run_superpoint
from ..utils.image_io import read_grey
from ..utils.jpeg import write_jpeg
from .kitti import save_arr

SIFT_ITEM = "ROADMAP Queue 1 item 8, the SIFT dump"


def dump_sequence(*args, **kwargs) -> None:
    """The SIFT dump: not ported (it needs cv2's SIFT)."""
    raise NotImplementedError(f"the SIFT dump needs OpenCV's SIFT, which the port does not use "
                              f"({SIFT_ITEM}); use dump_sequence_sp")


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
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "cam.npy", K.astype(np.float32))
    np.save(out / "poses.npy", poses.astype(np.float32))
    np.save(out / "Rt_cam2_gt.npy",
            (Rt_cam2_gt if Rt_cam2_gt is not None else np.eye(4)).astype(np.float64))
    greys = []
    for i, f in enumerate(image_files):
        img = read_grey(f)
        greys.append(img)
        write_jpeg(out / f"{i:06d}.jpg", img)
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
