"""Epipolar geometry core (batched torch, differentiable).

Counterpart of `deepfepe_tpu/geometry/epipolar.py`: Hartley
normalization, the 9-column constraint matrix, epipolar distances and the
F/E conversions. The F convention is `x2ᵀ F x1 = 0`.
"""

from __future__ import annotations

import torch

from .basic import homo, safe_norm, skew


def norm_hw_matrix(image_size, dtype=torch.float32, device=None) -> torch.Tensor:
    """The [-1, 1] image-coordinate normalizer T = [[2/W, 0, -1],
    [0, 2/H, -1], [0, 0, 1]] for `image_size` (H, W)."""
    H, W = float(image_size[0]), float(image_size[1])
    return torch.tensor(
        [[2.0 / W, 0.0, -1.0], [0.0, 2.0 / H, -1.0], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device,
    )


def normalize_hw(pts: torch.Tensor, image_size):
    """Map pixel points [..., N, 2] into [-1, 1]² homogeneous [..., N, 3].

    Returns (pts_h_normalized, T) with T broadcast to the batch shape.
    """
    T = norm_hw_matrix(image_size, dtype=pts.dtype, device=pts.device)
    out = homo(pts) @ T.T
    return out, T.expand(pts.shape[:-2] + (3, 3))


def hartley_normalize(pts_h: torch.Tensor, weights: torch.Tensor | None = None,
                      eps: float = 1e-10):
    """Weighted Hartley normalization of homogeneous points [..., N, 3].

    Centres on the (weighted) centroid and scales the mean distance to
    sqrt(2); the mean distance is floored at 1e-6 so a degenerate set gives
    a large but finite scale. Returns (pts_out [..., N, 3], T [..., 3, 3]).
    """
    if weights is None:
        weights = torch.ones(pts_h.shape[:-1], dtype=pts_h.dtype, device=pts_h.device)
    w = weights[..., None]
    denom = torch.sum(w, dim=-2) + eps
    c = torch.sum(pts_h * w, dim=-2) / denom
    centered = pts_h - c[..., None, :]
    dist = safe_norm(centered[..., :2], dim=-1, keepdim=True)
    meandist = torch.sum(w * dist, dim=-2) / denom
    scale = (2.0 ** 0.5) / torch.clamp(meandist[..., 0], min=1e-6)
    z = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, z, -c[..., 0] * scale], dim=-1),
            torch.stack([z, scale, -c[..., 1] * scale], dim=-1),
            torch.stack([z, z, one], dim=-1),
        ],
        dim=-2,
    )
    return pts_h @ T.transpose(-1, -2), T


def epipolar_constraint_matrix(pts1_h: torch.Tensor, pts2_h: torch.Tensor) -> torch.Tensor:
    """[..., N, 9] rows [x2x1, x2y1, x2z1, y2x1, y2y1, y2z1, z2x1, z2y1, z2z1],
    so that row · vec(F) = x2ᵀ F x1 with row-major vec."""
    x1, y1, z1 = pts1_h[..., 0], pts1_h[..., 1], pts1_h[..., 2]
    x2, y2, z2 = pts2_h[..., 0], pts2_h[..., 1], pts2_h[..., 2]
    return torch.stack(
        [x2 * x1, x2 * y1, x2 * z1, y2 * x1, y2 * y1, y2 * z1,
         z2 * x1, z2 * y1, z2 * z1],
        dim=-1,
    )


def _prep(pts1, pts2, F, if_homo):
    if not if_homo:
        pts1, pts2 = homo(pts1), homo(pts2)
    Fx1 = pts1 @ F.transpose(-1, -2)  # rows (F x1)ᵀ: lines in image 2
    Ftx2 = pts2 @ F                   # rows (Fᵀ x2)ᵀ: lines in image 1
    s = torch.sum(pts2 * Fx1, dim=-1)
    return s, Fx1, Ftx2


def compute_epi_residual(pts1_h, pts2_h, F, clamp_at: float = 0.5, eps: float = 1e-6):
    """|x2ᵀFx1| · (1/(‖(Fx1)_xy‖+eps) + 1/(‖(Fᵀx2)_xy‖+eps)), clamped at
    `clamp_at`; homogeneous inputs [..., N, 3]. CPU tensors take the plain
    version; CUDA float32 tensors the K3 kernel and its backward
    (`ops.epi_residual`); other CUDA tensors raise."""
    from ..ops.epi_residual import epi_residual  # ops imports this module

    return epi_residual(pts1_h, pts2_h, F, clamp_at, eps)


def epi_distance(F, pts1, pts2, if_homo: bool = False, eps: float = 1e-10):
    """Unsquared epipolar line distances: (mean of both sides, distance to
    the line in image 2, distance to the line in image 1)."""
    s, Fx1, Ftx2 = _prep(pts1, pts2, F, if_homo)
    nom = torch.abs(s)
    d1 = nom / torch.sqrt(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + eps)
    d2 = nom / torch.sqrt(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2 + eps)
    return (d1 + d2) / 2.0, d1, d2


def F_to_E(F: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """E = Kᵀ F K (without the (1, 1, 0) projection)."""
    return K.transpose(-1, -2) @ F @ K


def E_to_F(E: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F = K⁻ᵀ E K⁻¹."""
    K_inv = torch.linalg.inv(K)
    return K_inv.transpose(-1, -2) @ E @ K_inv


def E_F_from_Rt(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor):
    """Ground-truth E = [t]× R and F = K⁻ᵀ E K⁻¹ for x2 = R x1 + t."""
    E = skew(t) @ R
    return E, E_to_F(E, K)
