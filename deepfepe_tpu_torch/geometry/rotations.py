"""Rotation and quaternion algebra (batched torch).

Counterpart of `deepfepe_tpu/geometry/rotations.py`. Quaternions are
`[..., 4]` in (w, x, y, z) order with w >= 0.
"""

from __future__ import annotations

import torch

from .basic import safe_norm


def R_to_q(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z),
    by the branchless Shepperd method: the best-conditioned of the four
    candidate constructions is selected per item."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _s(q2):
        return torch.sqrt(torch.clamp(q2, min=eps)) * 2.0

    sw, sx, sy, sz = _s(qw2), _s(qx2), _s(qy2), _s(qz2)
    cands = torch.stack(
        [
            torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
            torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
        ],
        dim=-2,
    )
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 0:1] < 0, -q, q)


def rotation_angle_error(R0: torch.Tensor, R1: torch.Tensor) -> torch.Tensor:
    """Relative rotation angle between [..., 3, 3] matrices in degrees:
    acos((tr(R0 R1ᵀ) - 1) / 2)."""
    R = R0 @ R1.transpose(-1, -2)
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def vector_angle(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Angle between [..., 3] (or [..., 3, 1]) vectors in degrees."""
    if v1.shape[-1] == 1:
        v1 = v1[..., 0]
    if v2.shape[-1] == 1:
        v2 = v2[..., 0]
    dot = torch.sum(v1 * v2, dim=-1)
    n1 = safe_norm(v1, dim=-1) + eps
    n2 = safe_norm(v2, dim=-1) + eps
    cos = torch.clamp(dot / (n1 * n2 + eps), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))

