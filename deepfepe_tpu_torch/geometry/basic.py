"""Homogeneous-coordinate and SE(3) helpers (batched torch).

Counterpart of `deepfepe_tpu/geometry/basic.py`. Every function works on
arbitrary leading batch dimensions. Points are `[..., N, 2]` (homogeneous
`[..., N, 3]`); rigid transforms are `[..., 3, 4]` or padded `[..., 4, 4]`.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a zero gradient at exactly-zero input (the plain norm's
    gradient there is 0/0)."""
    d2 = torch.sum(x * x, dim=dim, keepdim=keepdim)
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def homo(pts: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1: [..., N, 2] -> [..., N, 3]."""
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype, device=pts.device)
    return torch.cat([pts, ones], dim=-1)


def dehomo(pts_h: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Divide by the last coordinate: [..., N, 3] -> [..., N, 2]."""
    return pts_h[..., :-1] / (pts_h[..., -1:] + eps)


def skew(t: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of [..., 3] or [..., 3, 1] vectors."""
    if t.shape[-1] == 1:
        t = t[..., 0]
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], z, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def rt_pad(Rt: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] by appending [0, 0, 0, 1]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=Rt.dtype, device=Rt.device)
    bottom = bottom.expand(Rt.shape[:-2] + (1, 4))
    return torch.cat([Rt, bottom], dim=-2)


def rt_inverse(Rt: torch.Tensor) -> torch.Tensor:
    """Invert [..., 3, 4] rigid transforms in closed form: [Rᵀ | -Rᵀt]."""
    R_T = Rt[..., :3, :3].transpose(-1, -2)
    t = Rt[..., :3, 3:4]
    return torch.cat([R_T, -R_T @ t], dim=-1)


def rt_depad(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 3, 4]."""
    return T[..., :3, :]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert [..., 4, 4] SE(3) matrices in closed form."""
    return rt_pad(rt_inverse(rt_depad(T)))


def se3_compose(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Compose two [..., 4, 4] transforms: the result maps like T_a after T_b."""
    return T_a @ T_b
