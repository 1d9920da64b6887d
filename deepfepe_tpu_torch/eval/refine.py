"""Two-view motion refinement: a square-root BA polish of each pair's pose.

Counterpart of `deepfepe_tpu/eval/refine.py`. The correspondences are
triangulated with the solver's (R, t), then a few damped Gauss-Newton
iterations of reprojection-error BA run over {camera 2's pose, the 3D
points} with camera 1 fixed (Hartley & Zisserman §12), by the square-root
step (`ba/sqrt_ba.py`) so float32 suffices. The solver's per-correspondence
weights weight the residuals (outliers get ~0), optionally with a Huber
IRLS on top. Batched over pairs, in float32.

Per-pair acceptance: a pair keeps its input pose unless the polish lowered
its robust (Huber, 2 px) reprojection cost and at least `min_matches`
effective correspondences back the solve. The polish helps on dense
accurate correspondences; on sparse noisy matches whose solver already
beats the reprojection optimum it would regress, and the guard leaves
those pairs alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ba.bundle_adjustment import BAProblem, reprojection_residuals
from ..ba.sqrt_ba import sqrt_ba_step
from ..geometry.basic import homo, safe_norm
from ..geometry.decompose import two_view_depths
from ..utils.device import no_tf32

HUBER_COST_PX = 2.0  # the acceptance cost's Huber threshold


def _robust_cost(p: BAProblem, vis: torch.Tensor) -> torch.Tensor:
    """Weighted Huber (2 px) reprojection cost of each pair: the residuals
    in pixels (unit visibility where observed), weighted by `vis`."""
    r, _ = reprojection_residuals(p._replace(vis=(vis > 0).to(vis.dtype)))
    rn = safe_norm(r, dim=-1)  # [B, 2, N] px
    d = HUBER_COST_PX
    hub = torch.where(rn <= d, 0.5 * rn ** 2, d * (rn - 0.5 * d))
    return torch.sum(vis * hub, dim=(-2, -1)) / (torch.sum(vis, dim=(-2, -1)) + 1e-9)


@no_tf32()
def refine_two_view_batch(matches: torch.Tensor, weights: torch.Tensor, Ks: torch.Tensor,
                          R: torch.Tensor, t: torch.Tensor, iters: int = 5,
                          damping: float = 1e-3, weight_floor: float = 0.0,
                          refine_rotation: bool = True, huber_px: float = 0.0,
                          min_matches: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched two-view BA refinement of x2 = R x1 + t. matches [B, N, 4]
    (x1 y1 x2 y2 in pixels), weights [B, N] (>= 0), Ks [B, 3, 3], R [B, 3,
    3], t [B, 3]. Returns (R [B, 3, 3], unit t [B, 3], info with per-pair
    'accepted', 'costs' [B, iters], 'cost_before', 'cost_after', 'n_eff',
    'final_rms_px'). `refine_rotation=False` freezes the rotations
    (translation and points only)."""
    dtype, dev = matches.dtype, matches.device
    B, N = matches.shape[:2]
    Ks = Ks.to(dtype)
    K_inv = torch.linalg.inv(Ks)
    x1n = homo(matches[..., :2]) @ K_inv.transpose(-1, -2)
    x2n = homo(matches[..., 2:4]) @ K_inv.transpose(-1, -2)

    # Triangulate in frame 1 with the initial pose.
    z1, z2 = two_view_depths(R, t, x1n, x2n)
    X = x1n * z1[..., None]  # [B, N, 3]

    # Visibility = normalized weights, zero where a depth is negative or
    # the weight is at or under the floor.
    w = weights / (torch.amax(weights, dim=-1, keepdim=True) + 1e-12)
    w = torch.where((z1 > 0) & (z2 > 0), w, torch.zeros_like(w))
    w = torch.where(w > weight_floor, w, torch.zeros_like(w))

    eye = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
    T2 = eye.clone()
    T2[:, :3, :3] = R
    T2[:, :3, 3] = t
    vis = torch.stack([w, w], dim=1)  # [B, 2, N]
    prob = BAProblem(poses=torch.stack([eye, T2], dim=1), points=X,
                     obs=torch.stack([matches[..., :2], matches[..., 2:4]], dim=1), vis=vis,
                     K=Ks)
    dof = None
    if not refine_rotation:  # camera 2's rotation block frozen (columns 3-5)
        dof = torch.tensor([[1.0, 1, 1, 0, 0, 0]] * 2, dtype=dtype, device=dev)

    cost_before = _robust_cost(prob, vis)
    costs = []
    for _ in range(iters):
        if huber_px > 0:
            # Huber IRLS on the current reprojection error in pixels (unit
            # weights where observed), scaling each observation's weight.
            r_cur, _ = reprojection_residuals(prob._replace(vis=(vis > 0).to(dtype)))
            rn = torch.linalg.vector_norm(r_cur, dim=-1)
            prob = prob._replace(vis=vis * torch.clamp(huber_px / (rn + 1e-9), max=1.0))
        prob, info = sqrt_ba_step(prob, damping=damping, fix_cameras=1, dof_mask=dof)
        costs.append(info["cost"])
    cost_after = _robust_cost(prob, vis)

    n_eff = torch.sum((w > 0).to(torch.float32), dim=-1)
    accept = (cost_after <= cost_before) & (n_eff >= min_matches)
    R_out = torch.where(accept[:, None, None], prob.poses[:, 1, :3, :3], R)
    t_raw = torch.where(accept[:, None], prob.poses[:, 1, :3, 3], t)
    t_out = t_raw / (torch.linalg.vector_norm(t_raw, dim=-1, keepdim=True) + 1e-12)
    r_fin, _ = reprojection_residuals(prob)
    return R_out, t_out, {
        "costs": torch.stack(costs, dim=-1), "accepted": accept, "cost_before": cost_before,
        "cost_after": cost_after, "n_eff": n_eff,
        "final_rms_px": torch.sqrt(torch.sum(r_fin ** 2, dim=(-3, -2, -1))
                                   / (torch.sum(vis, dim=(-2, -1)) + 1e-9)),
    }
