"""SO(3) and SE(3) exponential and logarithm maps (batched torch).

Counterpart of `deepfepe_tpu/geometry/lie.py`: the local tangent-space
updates of the pose-graph and bundle-adjustment solvers (`ba/`). Every
function takes arbitrary leading batch dimensions. The small-angle
branches are series expansions selected by `torch.where`, never by a Python
`if`, so `torch.func.vmap` and `torch.func.jacrev` trace them and the
derivative at θ = 0 stays finite. Twists are (v, w): translation first.
"""

from __future__ import annotations

import torch

from .basic import skew

_EPS = 1e-8


def _sinc_taylor(theta2: torch.Tensor) -> torch.Tensor:
    """sin(θ)/θ from θ², with its series below θ² = 1e-8."""
    theta = torch.sqrt(theta2 + _EPS)
    return torch.where(theta2 < 1e-8, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)


def _cosc_taylor(theta2: torch.Tensor) -> torch.Tensor:
    """(1 - cos θ)/θ² from θ², with its series below θ² = 1e-8."""
    theta = torch.sqrt(theta2 + _EPS)
    return torch.where(theta2 < 1e-8, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / (theta2 + _EPS))


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    A = _sinc_taylor(theta2)[..., None, None]
    B = _cosc_taylor(theta2)[..., None, None]
    return _eye(3, w, W.shape) + A * W + B * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] (θ < π).

    θ/(2 sin θ) is a series in (1 - cos θ) near the identity; elsewhere
    arccos takes its input clamped strictly inside (-1, 1), so the branch
    `torch.where` drops keeps a finite derivative."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    # vee of the antisymmetric part: v = 2 sin(θ) axis.
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    near_id = cos > 1.0 - 1e-5
    theta_safe = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-6))
    exact = theta_safe / (2.0 * torch.sin(theta_safe) + _EPS)
    # θ² ≈ 2(1 - c): θ/(2 sin θ) = 1/2 + (1 - c)/6 + 7(1 - c)²/90 + ...
    series = 0.5 + (1.0 - cos) / 6.0 + (1.0 - cos) ** 2 * (7.0 / 90.0)
    return v * torch.where(near_id, series, exact)[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): se3_exp's translation factor."""
    theta2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    theta = torch.sqrt(theta2 + _EPS)
    B = _cosc_taylor(theta2)
    C = torch.where(theta2 < 1e-8, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - torch.sin(theta) / theta) / (theta2 + _EPS))
    return _eye(3, w, W.shape) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (v, w) -> SE(3) matrix [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom.expand(xi.shape[:-1] + (1, 4))], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) matrix [..., 4, 4] -> twist [..., 6] (v, w)."""
    w = so3_log(T[..., :3, :3])
    v = torch.linalg.solve(_so3_left_jacobian(w), T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)
