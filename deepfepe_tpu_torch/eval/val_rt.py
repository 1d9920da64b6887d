"""Per-pair pose validation: estimate, ground truth and RANSAC baseline.

Counterpart of `deepfepe_tpu/eval/val_rt.py` with the 8-point RANSAC
baseline (`five_point=False`); the five-point baseline comes in a later
slice. err_q / err_t are the angular errors of the inverted recovered
pose against the inverse ground-truth pose.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry.basic import homo, rt_inverse
from ..geometry.decompose import recover_pose
from ..geometry.epipolar import E_to_F, F_to_E, epi_distance
from ..geometry.rotations import rotation_angle_error, vector_angle
from .ransac import ransac_f_batch


def _pose_errors(R_est, t_est, delta_Rtij_inv):
    Rt = torch.cat([R_est, t_est[..., None]], dim=-1)
    Rt_inv = rt_inverse(Rt)
    R_cam, t_cam = Rt_inv[..., :3, :3], Rt_inv[..., :3, 3]
    err_q = rotation_angle_error(R_cam, delta_Rtij_inv[..., :3, :3])
    err_t = vector_angle(t_cam, delta_Rtij_inv[..., :3, 3])
    M_cam = torch.cat([R_cam, t_cam[..., None]], dim=-1)
    return err_q, err_t, M_cam, Rt


def val_rt_batch(E_ests, Ks, matches, E_gts, delta_Rtijs_4_4, ransac: bool = True,
                 ransac_idxs: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, ransac_hypotheses: int = 512,
                 ransac_threshold_px: float = 1.0, five_point: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Pose errors of E_ests [B, 3, 3] and E_gts against delta_Rtijs_4_4
    [B, 4, 4] on matches [B, N, 4]; with `ransac`, also of the 8-point
    RANSAC baseline (hypotheses `ransac_idxs` [B, H, 8] or drawn from
    `generator`)."""
    if five_point:
        raise NotImplementedError("the five-point baseline is not ported yet")
    x1, x2 = matches[..., :2], matches[..., 2:4]
    K_inv_t = torch.linalg.inv(Ks).transpose(-1, -2)
    x1n, x2n = homo(x1) @ K_inv_t, homo(x2) @ K_inv_t
    delta_inv = torch.linalg.inv(delta_Rtijs_4_4)

    out: Dict[str, torch.Tensor] = {}
    for name, E in (("est", E_ests), ("gt", E_gts)):
        rec = recover_pose(E, x1n, x2n)
        err_q, err_t, M_cam, M = _pose_errors(rec.R, rec.t, delta_inv)
        # Scored with the SUM of the two one-sided line distances, the
        # reference's eval convention.
        _, d1, d2 = epi_distance(E_to_F(E, Ks), x1, x2)
        out.update({f"err_q_{name}": err_q, f"err_t_{name}": err_t,
                    f"M_cam_{name}": M_cam, f"M_{name}": M, f"epi_dists_{name}": d1 + d2})

    if ransac:
        rr = ransac_f_batch(x1, x2, idxs=ransac_idxs, generator=generator,
                            num_hypotheses=ransac_hypotheses, threshold=ransac_threshold_px)
        rec = recover_pose(F_to_E(rr.F, Ks), x1n, x2n)
        err_q, err_t, M_cam, M = _pose_errors(rec.R, rec.t, delta_inv)
        _, d1, d2 = epi_distance(rr.F, x1, x2)
        out.update({"err_q_base": err_q, "err_t_base": err_t, "M_cam_base": M_cam,
                    "M_base": M, "epi_dists_base": d1 + d2,
                    "base_inliers": rr.num_inliers})
    return out


def inlier_ratios(epi_dists: torch.Tensor, thresholds=(0.1, 1.0)) -> Dict[str, torch.Tensor]:
    """Share of correspondences under each epipolar-distance threshold."""
    return {f"ratio@{th}": (epi_dists < th).float().mean(dim=-1) for th in thresholds}
