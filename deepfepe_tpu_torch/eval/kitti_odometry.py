"""KITTI odometry benchmark metrics (numpy, on the host).

Counterpart of `deepfepe_tpu/eval/kitti_odometry.py`, a copy of the
metrics the reference reports through the `kitti-odom-eval` tool (the
KITTI devkit's definitions):

- translation error (%) and rotation error (deg/100 m) over sub-sequences
  of 100..800 m (`LENGTHS`), starting every 10 frames;
- ATE (m): the RMSE of the translations after alignment;
- RPE (m) and RPE (deg): the mean frame-to-frame relative pose error.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10


def load_poses_txt(path: str) -> np.ndarray:
    """A KITTI 12-column trajectory file -> [N, 4, 4]."""
    data = np.genfromtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (data.shape[0], 1, 1))
    out[:, :3, :] = data
    return out


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Path length up to each frame."""
    d = np.zeros(len(poses))
    d[1:] = np.cumsum(np.linalg.norm(poses[1:, :3, 3] - poses[:-1, :3, 3], axis=-1))
    return d


def _last_frame_from_len(dist: np.ndarray, first: int, length: float) -> int:
    idx = np.searchsorted(dist, dist[first] + length)
    return int(idx) if idx < len(dist) else -1


def _rotation_error(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def calc_sequence_errors(poses_gt: np.ndarray, poses_est: np.ndarray,
                         lengths: Sequence[float] = LENGTHS,
                         step: int = STEP_SIZE) -> List[tuple]:
    """(first frame, rotation error, translation error, length) of every
    sub-sequence, each error over its length (the KITTI devkit)."""
    dist = trajectory_distances(poses_gt)
    err = []
    n = min(len(poses_gt), len(poses_est))
    for first in range(0, n, step):
        for length in lengths:
            last = _last_frame_from_len(dist, first, length)
            if last == -1 or last >= n:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_est = np.linalg.inv(poses_est[first]) @ poses_est[last]
            pose_err = np.linalg.inv(delta_est) @ delta_gt
            err.append((first, _rotation_error(pose_err[:3, :3]) / length,
                        np.linalg.norm(pose_err[:3, 3]) / length, length))
    return err


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """The least-squares similarity aligning x (3xN) onto y (3xN): (R, t, c)
    with y ~ c R x + t (Umeyama, TPAMI 1991)."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    U, D, Vt = np.linalg.svd(yc @ xc.T / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = float(np.trace(np.diag(D) @ S) / ((xc ** 2).sum() / n)) if with_scale else 1.0
    t = my - c * R @ mx
    return R, t[:, 0], c


def align_trajectory(poses_gt: np.ndarray, poses_est: np.ndarray,
                     align: str = "scale") -> np.ndarray:
    """The estimate aligned onto gt before evaluation: 'none'; 'scale' (the
    Umeyama least-squares scale on the translations, the protocol of the
    reference's published results); '6dof' (rigid); '7dof' (similarity)."""
    n = min(len(poses_gt), len(poses_est))
    est = poses_est.copy()
    gt_xyz = poses_gt[:n, :3, 3].T
    est_xyz = poses_est[:n, :3, 3].T
    if align == "scale":
        _, _, c = umeyama_alignment(est_xyz, gt_xyz, with_scale=True)
        est[:, :3, 3] *= c
    elif align in ("6dof", "7dof"):
        R, t, c = umeyama_alignment(est_xyz, gt_xyz, with_scale=align == "7dof")
        est[:, :3, 3] = (c * R @ est_xyz + t[:, None]).T
        est[:, :3, :3] = R @ est[:, :3, :3]
    return est


def compute_ate(poses_gt: np.ndarray, poses_est: np.ndarray) -> float:
    """The RMSE ATE of (already aligned) trajectories."""
    n = min(len(poses_gt), len(poses_est))
    errs = np.linalg.norm(poses_gt[:n, :3, 3].T - poses_est[:n, :3, 3].T, axis=0)
    return float(np.sqrt(np.mean(errs ** 2)))


def compute_rpe(poses_gt: np.ndarray, poses_est: np.ndarray):
    """The mean frame-to-frame relative pose error -> (m, deg)."""
    n = min(len(poses_gt), len(poses_est))
    t_errs, r_errs = [], []
    for i in range(n - 1):
        rel_gt = np.linalg.inv(poses_gt[i]) @ poses_gt[i + 1]
        rel_est = np.linalg.inv(poses_est[i]) @ poses_est[i + 1]
        pe = np.linalg.inv(rel_est) @ rel_gt
        t_errs.append(np.linalg.norm(pe[:3, 3]))
        r_errs.append(_rotation_error(pe[:3, :3]))
    return float(np.mean(t_errs)), float(np.degrees(np.mean(r_errs)))


def evaluate_sequence(poses_gt: np.ndarray, poses_est: np.ndarray, align: str = "scale",
                      lengths: Sequence[float] = LENGTHS) -> Dict[str, float]:
    """The kitti-odom-eval report of one sequence: trans_err_pct,
    rot_err_deg_per_100m (NaN without a sub-sequence of the lengths),
    ATE_m, RPE_m, RPE_deg."""
    poses_est = align_trajectory(poses_gt, poses_est, align)
    errs = calc_sequence_errors(poses_gt, poses_est, lengths=lengths)
    if errs:
        trans_pct = float(np.mean([e[2] for e in errs]) * 100.0)
        rot_deg_per_100m = float(np.degrees(np.mean([e[1] for e in errs])) * 100.0)
    else:
        trans_pct = rot_deg_per_100m = float("nan")
    rpe_m, rpe_deg = compute_rpe(poses_gt, poses_est)
    return {"trans_err_pct": trans_pct, "rot_err_deg_per_100m": rot_deg_per_100m,
            "ATE_m": compute_ate(poses_gt, poses_est), "RPE_m": rpe_m, "RPE_deg": rpe_deg}
