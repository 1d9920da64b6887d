"""Correspondence correction onto a ground-truth epipolar geometry.

Counterpart of `deepfepe_tpu/geometry/correct.py`: project a grid of
virtual correspondences onto x2ᵀ F x1 = 0 by Newton iteration on the KKT
conditions (the first step is the Sampson correction). The F-loss scores
each layer's F on these points.
"""

from __future__ import annotations

import torch

from .basic import homo


def _constraint_and_grad(F, x1, x2):
    """e = x2ᵀFx1 and its gradients with respect to inhomogeneous x1, x2."""
    x1h, x2h = homo(x1), homo(x2)
    Fx1 = x1h @ F.transpose(-1, -2)
    Ftx2 = x2h @ F
    e = torch.sum(x2h * Fx1, dim=-1)
    return e, Ftx2[..., :2], Fx1[..., :2]


def correct_matches(F, x1, x2, iters: int = 5, eps: float = 1e-12):
    """Project correspondences [..., N, 2] onto x2ᵀ F x1 = 0; returns the
    corrected (x1, x2)."""
    x1k, x2k = x1, x2
    for _ in range(iters):
        e, g1, g2 = _constraint_and_grad(F, x1k, x2k)
        # Linearize at the iterate; the projection is anchored at the input.
        resid = (e + torch.sum(g1 * (x1 - x1k), dim=-1)
                 + torch.sum(g2 * (x2 - x2k), dim=-1))
        denom = torch.sum(g1 * g1, dim=-1) + torch.sum(g2 * g2, dim=-1) + eps
        lam = (resid / denom)[..., None]
        x1k, x2k = x1 - lam * g1, x2 - lam * g2
    return x1k, x2k


def virtual_grid(image_size, step: float = 0.1, dtype=torch.float32, device=None):
    """The 10x10 virtual-point pixel grid; returns (pts1, pts2), each
    [100, 2] and identical. `image_size` is (H, W)."""
    H, W = float(image_size[0]), float(image_size[1])
    r = torch.arange(0.0, 1.0, step, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    pts = torch.stack([W * xx.reshape(-1), H * yy.reshape(-1)], dim=-1)
    return pts, pts


def get_virtual_points(F_gt: torch.Tensor, image_size, step: float = 0.1, iters: int = 8):
    """Virtual gt-consistent correspondences: homogeneous (pts1, pts2), each
    [..., 100, 3], with NaNs scrubbed to 0."""
    p1_b, p2_b = virtual_grid(image_size, step, dtype=F_gt.dtype, device=F_gt.device)
    batch_shape = F_gt.shape[:-2]
    p1 = p1_b.expand(batch_shape + p1_b.shape)
    p2 = p2_b.expand(batch_shape + p2_b.shape)
    x1c, x2c = correct_matches(F_gt, p1, p2, iters=iters)
    return homo(torch.nan_to_num(x1c)), homo(torch.nan_to_num(x2c))
