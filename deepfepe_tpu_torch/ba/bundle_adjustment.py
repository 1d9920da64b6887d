"""Bundle adjustment with Schur-complement reduction (batched, analytic).

Counterpart of `deepfepe_tpu/ba/bundle_adjustment.py`: refine camera poses
and 3D points by minimizing reprojection error.

- The observation structure is dense [C, P] with a visibility mask
  (masked terms contribute zero), so every shape is static.
- Jacobian blocks (J_cam [C, P, 2, 6], J_pt [C, P, 2, 3]) are analytic.
- The points are eliminated in closed form (a batched [P, 3, 3] inverse)
  and the reduced camera system S = H_cc - W H_pp⁻¹ Wᵀ is solved densely.

Every tensor of a `BAProblem` may carry the same leading batch dimensions
(independent problems solved side by side, as `eval/refine.py` does); the
JAX package's unbatched problem is the case of none. Poses map world to
camera (x_cam = R X + t); updates are left-multiplicative se(3) twists.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..geometry.basic import skew
from ..geometry.lie import se3_exp
from ..utils.device import no_tf32


class BAProblem(NamedTuple):
    poses: torch.Tensor   # [..., C, 4, 4] world -> camera
    points: torch.Tensor  # [..., P, 3]
    obs: torch.Tensor     # [..., C, P, 2] pixel observations
    vis: torch.Tensor     # [..., C, P] visibility (or per-residual weight)
    K: torch.Tensor       # [..., 3, 3] shared intrinsics


def project(poses: torch.Tensor, points: torch.Tensor, K: torch.Tensor):
    """[..., C, P, 2] projections and [..., C, P, 3] camera-frame points."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    Xc = torch.einsum("...cij,...pj->...cpi", R, points) + t[..., :, None, :]
    uv_h = torch.einsum("...ij,...cpj->...cpi", K, Xc)
    return uv_h[..., :2] / (uv_h[..., 2:3] + 1e-12), Xc


def reprojection_residuals(p: BAProblem):
    """Visibility-weighted residuals [..., C, P, 2] and camera-frame points."""
    uv, Xc = project(p.poses, p.points, p.K)
    return (uv - p.obs) * p.vis[..., None], Xc


def reprojection_cost(p: BAProblem) -> torch.Tensor:
    """0.5 Σ r² over each problem: [...]."""
    r, _ = reprojection_residuals(p)
    return 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


def _jacobians(p: BAProblem, Xc: torch.Tensor):
    """Analytic per-observation Jacobians, masked by visibility:
    d(uv)/d(Xc) [..., C, P, 2, 3]; d(Xc)/d(δcam) = [I | -skew(Xc)];
    d(Xc)/d(X) = R. Returns (J_cam [..., C, P, 2, 6], J_pt [..., C, P, 2, 3])."""
    fx = p.K[..., 0, 0][..., None, None]
    fy = p.K[..., 1, 1][..., None, None]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / (z + 1e-12)
    zeros = torch.zeros_like(x)
    Jp = torch.stack([torch.stack([fx * zi, zeros, -fx * x * zi * zi], dim=-1),
                      torch.stack([zeros, fy * zi, -fy * y * zi * zi], dim=-1)], dim=-2)
    I3 = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    J_cam = Jp @ torch.cat([I3, -skew(Xc)], dim=-1)
    J_pt = torch.einsum("...cpij,...cjk->...cpik", Jp, p.poses[..., :3, :3])
    mask = p.vis[..., None, None]
    return J_cam * mask, J_pt * mask


def build_normal_blocks(p: BAProblem):
    """The Gauss-Newton blocks: H_cc [..., C, 6, 6], H_pp [..., P, 3, 3],
    W [..., C, P, 6, 3], b_c [..., C, 6], b_p [..., P, 3] and the cost."""
    r, Xc = reprojection_residuals(p)
    J_cam, J_pt = _jacobians(p, Xc)
    H_cc = torch.einsum("...cpki,...cpkj->...cij", J_cam, J_cam)
    H_pp = torch.einsum("...cpki,...cpkj->...pij", J_pt, J_pt)
    W = torch.einsum("...cpki,...cpkj->...cpij", J_cam, J_pt)
    b_c = torch.einsum("...cpki,...cpk->...ci", J_cam, r)
    b_p = torch.einsum("...cpki,...cpk->...pi", J_pt, r)
    return H_cc, H_pp, W, b_c, b_p, 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


def schur_reduce(H_cc, H_pp, W, b_c, b_p, damping: float):
    """The reduced camera system (S [..., C, C, 6, 6], g [..., C, 6]) after
    the points are eliminated, and the damped H_pp inverses."""
    C = H_cc.shape[-3]
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    Hpp_inv = torch.linalg.inv(H_pp + damping * eye3)  # [..., P, 3, 3]
    WH = torch.einsum("...cpij,...pjk->...cpik", W, Hpp_inv)
    # S = blockdiag(H_cc + λI) - W H_pp⁻¹ Wᵀ, coupled across cameras.
    S = -torch.einsum("...apik,...bpjk->...abij", WH, W)
    diag = H_cc + damping * torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    eyeC = torch.eye(C, dtype=H_cc.dtype, device=H_cc.device)
    S = S + torch.einsum("...cij,cd->...cdij", diag, eyeC)
    g = b_c - torch.einsum("...cpik,...pk->...ci", WH, b_p)
    return S, g, Hpp_inv


def _select(improved: torch.Tensor, new: torch.Tensor, old: torch.Tensor, event_dims: int):
    return torch.where(improved.reshape(improved.shape + (1,) * event_dims), new, old)


@no_tf32()
def ba_step(p: BAProblem, damping: float = 1e-4, fix_cameras: int = 1
            ) -> Tuple[BAProblem, Dict[str, torch.Tensor]]:
    """One damped Gauss-Newton step with Schur elimination; the first
    `fix_cameras` cameras are held (gauge freedom). The step is kept only
    where it lowers the cost."""
    C = p.poses.shape[-3]
    batch = p.poses.shape[:-3]
    H_cc, H_pp, W, b_c, b_p, cost = build_normal_blocks(p)
    S, g, Hpp_inv = schur_reduce(H_cc, H_pp, W, b_c, b_p, damping)

    # Gauge fixing: the fixed cameras' rows and columns zeroed, 1 on their
    # diagonal.
    S_full = S.transpose(-3, -2).reshape(batch + (C * 6, C * 6))
    g_full = g.reshape(batch + (C * 6,))
    mask = (torch.arange(C * 6, device=S.device) >= fix_cameras * 6).to(S.dtype)
    S_full = S_full * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    delta_c = -torch.linalg.solve(S_full, (g_full * mask)[..., None])[..., 0]
    delta_c = delta_c.reshape(batch + (C, 6))
    # Back-substitution: δX = -H_pp⁻¹ (b_p + Wᵀ δc).
    Wt_dc = torch.einsum("...cpij,...ci->...pj", W, delta_c)
    delta_p = -torch.einsum("...pij,...pj->...pi", Hpp_inv, b_p + Wt_dc)

    new_poses = se3_exp(delta_c) @ p.poses
    new_points = p.points + delta_p
    new_cost = reprojection_cost(p._replace(poses=new_poses, points=new_points))
    improved = new_cost < cost
    out = p._replace(poses=_select(improved, new_poses, p.poses, 3),
                     points=_select(improved, new_points, p.points, 2))
    return out, {"cost": cost, "new_cost": new_cost, "accepted": improved}


def optimize_ba(p: BAProblem, iters: int = 10, damping: float = 1e-4, fix_cameras: int = 1):
    """`iters` Schur steps; returns (problem, the cost before each step)."""
    costs = []
    for _ in range(iters):
        p, info = ba_step(p, damping, fix_cameras)
        costs.append(info["cost"])
    return p, torch.stack(costs)
