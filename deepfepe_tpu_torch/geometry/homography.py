"""Homography estimation: batched normalized DLT (and its weighted form),
and the symmetric transfer error.

Counterpart of `deepfepe_tpu/geometry/homography.py` (the reference's
`utils_F._H_from_XY` :769). The 2N x 9 DLT system is solved through its
9x9 Gram matrix, as the 8-point fit is (`ops.eigh.smallest_singular_vec_
gram`): a 9x9 Gram of a CUDA tensor goes to the eigh9 kernel, of a CPU
tensor to the plain Jacobi.
"""

from __future__ import annotations

import torch

from ..ops.eigh import DEFAULT_GAP_EPS, smallest_singular_vec_gram
from .basic import homo
from .epipolar import hartley_normalize


def homography_from_points(x1: torch.Tensor, x2: torch.Tensor,
                           weights: torch.Tensor | None = None,
                           gap_eps: float = DEFAULT_GAP_EPS) -> torch.Tensor:
    """Least-squares H with x2 ~ H x1 from [..., N, 2] point sets (and
    optional [..., N] weights), by normalized DLT: [..., 3, 3], H[2, 2] = 1."""
    p1, T1 = hartley_normalize(homo(x1))
    p2, T2 = hartley_normalize(homo(x2))
    u, v = p1[..., 0], p1[..., 1]
    x, y = p2[..., 0], p2[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    # Two rows a correspondence: [-u -v -1 0 0 0 xu xv x], [0 0 0 -u -v -1 yu yv y].
    r1 = torch.stack([-u, -v, -one, zero, zero, zero, x * u, x * v, x], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u, -v, -one, y * u, y * v, y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 2N, 9]
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    h = smallest_singular_vec_gram(A, gap_eps)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.inv(T2) @ Hn @ T1
    return H / H[..., 2:3, 2:3]


def homography_transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                              eps: float = 1e-9) -> torch.Tensor:
    """Symmetric transfer error ||H x1 - x2|| + ||H^-1 x2 - x1|| a point."""
    def transfer(M, a):
        ah = homo(a) @ M.transpose(-1, -2)
        return ah[..., :2] / (ah[..., 2:3] + eps)

    d1 = torch.linalg.norm(transfer(H, x1) - x2, dim=-1)
    d2 = torch.linalg.norm(transfer(torch.linalg.inv(H), x2) - x1, dim=-1)
    return d1 + d2
