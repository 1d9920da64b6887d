"""Square-root bundle adjustment: QR nullspace marginalization in float32.

Counterpart of `deepfepe_tpu/ba/sqrt_ba.py` (Demmel et al., CVPR 2021,
"Square Root Bundle Adjustment for Large-Scale Reconstruction"). The
normal equations JᵀJ square the problem's conditioning; here each
landmark's Jacobian block is QR-decomposed and the landmark eliminated by
projecting its rows onto the nullspace, which leaves a pose-only least
squares problem solved by a second QR. float32 then keeps the descent
direction where the float32 Schur solve loses it.

It solves the same damped system as the Schur step (`ba_step`): Levenberg
damping enters as sqrt(λ) I residual rows for both parameter groups. The
per-landmark QR is [2C+3, 3], one batched factorization over the landmark
axis; the per-landmark pose Jacobian is dense ([P, 2C, 6C]), which suits
keyframe windows of a few dozen cameras. Leading batch dimensions as in
`ba/bundle_adjustment.py`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..geometry.lie import se3_exp
from ..utils.device import no_tf32
from .bundle_adjustment import (BAProblem, _jacobians, _select, reprojection_cost,
                                reprojection_residuals)


def _stacked_jacobians(p: BAProblem):
    """Landmark-major residuals and Jacobians: r [..., P, 2C], J_l [..., P,
    2C, 3], J_p [..., P, 2C, 6C] (camera c's row pair touches only columns
    6c:6c+6), and the cost."""
    r, Xc = reprojection_residuals(p)  # [..., C, P, 2]
    J_cam, J_pt = _jacobians(p, Xc)
    C, P = r.shape[-3:-1]
    batch = r.shape[:-3]
    r_l = r.transpose(-3, -2).reshape(batch + (P, 2 * C))
    J_l = J_pt.transpose(-4, -3).reshape(batch + (P, 2 * C, 3))
    eyeC = torch.eye(C, dtype=r.dtype, device=r.device)
    J_p = torch.einsum("...cpkj,cd->...pckdj", J_cam, eyeC).reshape(batch + (P, 2 * C, 6 * C))
    return r_l, J_l, J_p, 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


@no_tf32()
def sqrt_ba_step(p: BAProblem, damping: float = 1e-4, fix_cameras: int = 1,
                 dof_mask: torch.Tensor | None = None
                 ) -> Tuple[BAProblem, Dict[str, torch.Tensor]]:
    """One damped Gauss-Newton step by QR marginalization (no normal
    equations). `dof_mask` [C, 6] (translation xyz, rotation xyz a camera;
    0 freezes a DoF) composes with `fix_cameras`: freezing the rotation
    block gives a translation-only refinement."""
    C = p.poses.shape[-3]
    P = p.points.shape[-2]
    batch = p.points.shape[:-2]
    dtype, dev = p.points.dtype, p.points.device
    sqrt_l = torch.sqrt(torch.tensor(damping, dtype=dtype, device=dev))

    r_l, J_l, J_p, cost = _stacked_jacobians(p)
    # Landmark damping as sqrt(λ) I3 rows (Levenberg's H_pp + λI squared).
    pad_l = (sqrt_l * torch.eye(3, dtype=dtype, device=dev)).expand(batch + (P, 3, 3))
    J_l_aug = torch.cat([J_l, pad_l], dim=-2)  # [..., P, 2C+3, 3]
    J_p_aug = torch.cat([J_p, J_p.new_zeros(batch + (P, 3, 6 * C))], dim=-2)
    r_aug = torch.cat([r_l, r_l.new_zeros(batch + (P, 3))], dim=-1)

    # Batched complete QR of the landmark blocks.
    Q, R_full = torch.linalg.qr(J_l_aug, mode="complete")  # [..., P, m, m], [..., P, m, 3]
    R_l = R_full[..., :3, :]
    Jp_rot = torch.einsum("...pmi,...pmk->...pik", Q, J_p_aug)  # QᵀJ_p
    r_rot = torch.einsum("...pmi,...pm->...pi", Q, r_aug)       # Qᵀr

    # The nullspace rows (landmark eliminated): a pose-only least squares.
    A = Jp_rot[..., 3:, :].reshape(batch + (-1, 6 * C))
    b = r_rot[..., 3:].reshape(batch + (-1,))
    # Pose damping rows and gauge fixing (the fixed cameras' columns zeroed).
    free = (torch.arange(6 * C, device=dev) >= 6 * fix_cameras).to(dtype)
    if dof_mask is not None:
        free = free * dof_mask.reshape(-1).to(dtype=dtype, device=dev)
    A = torch.cat([A * free, (sqrt_l * torch.eye(6 * C, dtype=dtype, device=dev))
                   .expand(batch + (6 * C, 6 * C))], dim=-2)
    b = torch.cat([b, b.new_zeros(batch + (6 * C,))], dim=-1)

    # min ||A dp + b|| by a reduced QR: dp = -R⁻¹ Qᵀ b.
    Qp, Rp = torch.linalg.qr(A, mode="reduced")
    qtb = torch.einsum("...mk,...m->...k", Qp, b)
    delta_c = -torch.linalg.solve_triangular(Rp, qtb[..., None], upper=True)[..., 0]
    delta_c = (delta_c * free).reshape(batch + (C, 6))

    # Landmark back-substitution from the top three rotated rows:
    # R_l δX = -(r̃[:3] + J̃_p[:3] δp).
    rhs = -(r_rot[..., :3] + torch.einsum("...pik,...k->...pi", Jp_rot[..., :3, :],
                                          delta_c.reshape(batch + (6 * C,))))
    delta_p = torch.linalg.solve_triangular(R_l, rhs[..., None], upper=True)[..., 0]

    new_poses = se3_exp(delta_c) @ p.poses
    new_points = p.points + delta_p
    new_cost = reprojection_cost(p._replace(poses=new_poses, points=new_points))
    improved = new_cost < cost
    out = p._replace(poses=_select(improved, new_poses, p.poses, 3),
                     points=_select(improved, new_points, p.points, 2))
    return out, {"cost": cost, "new_cost": new_cost, "accepted": improved}


def optimize_sqrt_ba(p: BAProblem, iters: int = 10, damping: float = 1e-4,
                     fix_cameras: int = 1):
    """`iters` square-root steps; returns (problem, the cost before each)."""
    costs = []
    for _ in range(iters):
        p, info = sqrt_ba_step(p, damping, fix_cameras)
        costs.append(info["cost"])
    return p, torch.stack(costs)
