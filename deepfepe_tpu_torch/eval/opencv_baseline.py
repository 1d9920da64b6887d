"""Camera-pose baseline in the reference's `recover_camera_opencv` shape.

Counterpart of `deepfepe_tpu/eval/opencv_baseline.py`. The reference
validates estimates against cv2's RANSAC (dsac_tools/utils_opencv.py
:129-208); the card's machine has no OpenCV, so the port carries the JAX
package's cv2-free route (its `_native_fallback`): 8-point RANSAC for F on
the port's `ransac_f`, E = KᵀFK, and the pose by cheirality voting
(`recover_pose`). The cv2 options (the five-point solver, a given E,
normalized points, no RANSAC) raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry.decompose import recover_pose
from ..geometry.epipolar import F_to_E
from .ransac import ransac_f

CV2_ITEM = ("needs OpenCV, which the port does not use: the five-point route runs as "
            "val_rt_batch(five_point=True) (ROADMAP Queue 1 item 8)")


def _angle_errors(R: np.ndarray, t: np.ndarray, delta_Rtij_inv: np.ndarray):
    """Rotation and translation-direction errors (deg) of the inverted pose
    [R | t] against delta_Rtij_inv."""
    T = np.eye(4)
    T[:3, :3], T[:3, 3:4] = R, t
    T_inv = np.linalg.inv(T)
    cos = np.clip((np.trace(T_inv[:3, :3] @ delta_Rtij_inv[:3, :3].T) - 1) / 2, -1, 1)
    tg, tc = delta_Rtij_inv[:3, 3], T_inv[:3, 3]
    cos_t = np.clip(np.dot(tc, tg) / (np.linalg.norm(tc) * np.linalg.norm(tg) + 1e-10), -1, 1)
    return float(np.degrees(np.arccos(cos))), float(np.degrees(np.arccos(cos_t)))


def recover_camera_opencv(K: np.ndarray, x1: np.ndarray, x2: np.ndarray,
                          delta_Rtij_inv: np.ndarray, five_point: bool = False,
                          threshold: float = 0.1, if_normalized: bool = False,
                          E_given: Optional[np.ndarray] = None, ransac: bool = True,
                          ransac_idxs: torch.Tensor | None = None):
    """The relative pose of pixel matches x1, x2 [N, 2] by 8-point RANSAC
    (threshold max(threshold, 1) px; hypotheses `ransac_idxs` [H, 8], else
    drawn from a generator seeded 0), scored against delta_Rtij_inv.
    Returns (M [3, 4] = [R | t], (err_R_deg, err_t_deg), inlier_mask, (E,
    F)), as the reference."""
    if five_point or E_given is not None or if_normalized or not ransac:
        raise NotImplementedError(f"recover_camera_opencv's cv2 options {CV2_ITEM}")
    res = ransac_f(torch.as_tensor(x1, dtype=torch.float32),
                   torch.as_tensor(x2, dtype=torch.float32), idxs=ransac_idxs,
                   generator=torch.Generator().manual_seed(0),
                   threshold=max(threshold, 1.0))
    E = F_to_E(res.F, torch.as_tensor(K, dtype=torch.float32))
    K_inv = np.linalg.inv(K)

    def norm(x):
        return torch.as_tensor((np.hstack([x, np.ones((len(x), 1))]) @ K_inv.T)[:, :2],
                               dtype=torch.float32)

    rec = recover_pose(E, norm(x1), norm(x2))
    R = rec.R.double().numpy()
    t = rec.t.double().numpy()[:, None]
    return (np.hstack((R, t)), _angle_errors(R, t, delta_Rtij_inv),
            res.inlier_mask.numpy(), (E.double().numpy(), res.F.double().numpy()))
