"""Visual-odometry accumulation: relative poses -> trajectories -> exports.

Counterpart of `deepfepe_tpu/eval/vo.py`, a numpy copy of the reference's
`Exp_table_processor` VO machinery (utils/eval_tools.py): `get_abs_poses`
:268 (chain inverted relative poses), `export_poses` :297 (KITTI 12-column
text), `compensate_poses` :252, `compute_pose_error` :309 and
`pose_seq_ate` :334 (5-frame snippet ATE/RE with a scale a snippet), and
`relative_pose_cam_to_body` (Train_model_pipeline.py:1098-1108).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rt_pad_np(Rt: np.ndarray) -> np.ndarray:
    """[..., 3, 4] -> [..., 4, 4] (a [..., 4, 4] passes through)."""
    if Rt.shape[-2:] == (4, 4):
        return Rt
    bottom = np.zeros(Rt.shape[:-2] + (1, 4), Rt.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([Rt, bottom], axis=-2)


def relative_pose_cam_to_body(rel_pose: np.ndarray, Rt_cam2_gt: np.ndarray) -> np.ndarray:
    """A camera-frame relative pose conjugated into the body frame:
    inv(Rt_cam2_gt) @ rel @ Rt_cam2_gt."""
    return np.linalg.inv(Rt_cam2_gt) @ rt_pad_np(rel_pose) @ Rt_cam2_gt


def chain_relative_poses(rel_poses: np.ndarray) -> np.ndarray:
    """[N, 3|4, 4] relative (i -> i+1) poses chained into absolute [N+1, 4,
    4] poses: last = rel @ last, the absolute pose inv(last)."""
    n = len(rel_poses)
    out = np.tile(np.eye(4), (n + 1, 1, 1))
    last = np.eye(4)
    for i in range(n):
        last = rt_pad_np(rel_poses[i]) @ last
        out[i + 1] = np.linalg.inv(last)
    return out


def export_poses_kitti(poses: np.ndarray, path: str) -> None:
    """[N, 4, 4] (or [N, 3, 4]) poses as KITTI 12-column text."""
    np.savetxt(path, np.asarray(poses)[:, :3, :].reshape(-1, 12), delimiter=" ")


def compensate_poses(poses: np.ndarray) -> np.ndarray:
    """A pose snippet re-anchored at its first frame."""
    poses = np.array(poses[:, :3, :] if poses.shape[-2] == 4 else poses)
    first = poses[0]
    poses = poses.copy()
    poses[:, :, -1] -= first[:, -1]
    return np.linalg.inv(first[:, :3]) @ poses


def compute_pose_error(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """Snippet ATE/RE with the least-squares scale."""
    snippet_length = gt.shape[0]
    scale = float(np.sum(gt[:, :, -1] * pred[:, :, -1]) / np.sum(pred[:, :, -1] ** 2))
    ate = float(np.linalg.norm((gt[:, :, -1] - scale * pred[:, :, -1]).reshape(-1)))
    re = 0.0
    for g, p in zip(gt, pred):
        R = g[:, :3] @ np.linalg.inv(p[:, :3])
        s = np.linalg.norm([R[0, 1] - R[1, 0], R[1, 2] - R[2, 1], R[0, 2] - R[2, 0]])
        c = np.trace(R) - 1
        re += np.arctan2(s, c)
    return {"ATE": ate / snippet_length, "RE": re / snippet_length, "scale_factor": scale}


def pose_seq_ate(est_poses: np.ndarray, gt_poses: np.ndarray,
                 seq_length: int = 5) -> Dict[str, np.ndarray]:
    """5-frame snippet ATE/RE over a sequence."""
    assert len(est_poses) <= len(gt_poses)
    est_len = len(est_poses) - seq_length
    errors = np.zeros((est_len, 2), np.float32)
    scales = []
    for i in range(est_len):
        res = compute_pose_error(compensate_poses(gt_poses[i:i + seq_length]),
                                 compensate_poses(est_poses[i:i + seq_length]))
        errors[i] = res["ATE"], res["RE"]
        scales.append(res["scale_factor"])
    return {"errors": errors, "mean": errors.mean(0), "std": errors.std(0),
            "scale_factors": np.array(scales)}
