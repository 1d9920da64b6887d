"""Pose (q, t) loss from the closed-form decomposition of each layer's E.

Counterpart of `deepfepe_tpu/losses/rt_loss.py`. The essential matrices
are decomposed transposed, as the reference does, so that the recovered
(R, t) live in the frame of the dataset's `q_cam`/`t_cam` (the inverse
relative pose); translations are compared after unit normalization. Per
(layer, item) the candidate with the smaller error is picked by
`torch.where`, so the gradient flows through the pick.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry.decompose import decompose_E_closed_form
from ..geometry.rotations import R_to_q, rotation_angle_error, vector_angle


def rt_loss(E_ests_layers: torch.Tensor, q_gt: torch.Tensor, t_gt: torch.Tensor,
            R_gt: torch.Tensor, loss_q_clamp: float = 0.1, loss_t_clamp: float = 0.5,
            decomp_gap_eps: float = 1e-4) -> Dict[str, torch.Tensor]:
    """E_ests_layers [L, B, 3, 3]; q_gt [B, 4] (w, x, y, z), t_gt [B, 3]
    and R_gt [B, 3, 3] of the inverse relative pose. Returns the clamped
    mean losses, per-(layer, item) errors and angle metrics in degrees.

    `decomp_gap_eps` broadens the null-space eigengap in the backward:
    near-rank-1 estimates would otherwise give t-gradients of 1/gap."""
    dec = decompose_E_closed_form(E_ests_layers.transpose(-1, -2), gap_eps=decomp_gap_eps)
    q1, q2 = R_to_q(dec.R1), R_to_q(dec.R2)  # [L, B, 4]

    t_gt_n = t_gt / (torch.linalg.vector_norm(t_gt, dim=-1, keepdim=True) + 1e-10)
    q_gt_b = q_gt.expand(q1.shape)
    t_gt_b = t_gt_n.expand(dec.t.shape)

    q_err1 = torch.linalg.vector_norm(q1 - q_gt_b, dim=-1)  # [L, B]
    q_err2 = torch.linalg.vector_norm(q2 - q_gt_b, dim=-1)
    t_err1 = torch.linalg.vector_norm(dec.t - t_gt_b, dim=-1)
    t_err2 = torch.linalg.vector_norm(-dec.t - t_gt_b, dim=-1)

    q_pick1 = q_err1 < q_err2
    t_pick1 = t_err1 < t_err2
    q_l2 = torch.where(q_pick1, q_err1, q_err2)
    t_l2 = torch.where(t_pick1, t_err1, t_err2)
    R_est = torch.where(q_pick1[..., None, None], dec.R1, dec.R2)
    t_est = torch.where(t_pick1[..., None], dec.t, -dec.t)

    R_angle = rotation_angle_error(R_est.detach(), R_gt.expand(R_est.shape))
    t_angle = vector_angle(t_est, t_gt_b)

    return {
        "loss_q": torch.clamp(q_l2, 0.0, loss_q_clamp).mean(),
        "loss_t": torch.clamp(t_l2, 0.0, loss_t_clamp).mean(),
        "q_l2_layers": q_l2,
        "t_l2_layers": t_l2,
        "q_l2_error_mean": q_l2.mean(),
        "t_l2_error_mean": t_l2.mean(),
        "R_angle_error_layers": R_angle,
        "t_angle_error_layers": t_angle,
        "R_angle_error_mean": R_angle.mean(),
        "t_angle_error_mean": t_angle.mean(),
    }
