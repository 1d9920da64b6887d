"""The batched differentiable weighted 8-point fundamental-matrix solve.

Counterpart of `deepfepe_tpu/ops/fmatrix.py`:
  1. Hartley-normalize pts1/pts2 (uniform weights unless asked);
  2. build the [..., N, 9] constraint rows, L2-normalize them
     (`normalize_svd`) and scale by the weights: X = p * w;
  3. f = smallest right singular vector of X, via eigh of XᵀX (9x9: the
     eigh9 kernel on the card);
  4. rank-2 projection, residual X @ f, denormalize F = T2ᵀ F' T1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.epipolar import epipolar_constraint_matrix, hartley_normalize
from .eigh import DEFAULT_GAP_EPS, smallest_singular_vec_gram
from .svd3 import rank2_projection


class FitResult(NamedTuple):
    F: torch.Tensor         # [..., 3, 3] denormalized rank-2 F
    residual: torch.Tensor  # [..., N] algebraic residual X @ f
    F_norm: torch.Tensor    # [..., 3, 3] rank-2 F in normalized coordinates
    f_vec: torch.Tensor     # [..., 9] unit null vector (before rank 2)
    T1: torch.Tensor        # [..., 3, 3] Hartley transforms
    T2: torch.Tensor


def weighted_eight_point(pts1_h, pts2_h, weights, normalize_svd: bool = True,
                         weighted_normalization: bool = False,
                         gap_eps: float = DEFAULT_GAP_EPS, eps: float = 1e-10,
                         sign_canonical: bool = False) -> FitResult:
    """Solve for F from homogeneous points [..., N, 3] and weights [..., N].

    `sign_canonical` fixes the sign of the null vector so that the
    largest-|.| residual entry is positive; the signed residual feeds the
    weight MLP, so this makes the recurrence independent of the solver.
    """
    norm_w = weights if weighted_normalization else None
    pts1n, T1 = hartley_normalize(pts1_h, norm_w, eps=eps)
    pts2n, T2 = hartley_normalize(pts2_h, norm_w, eps=eps)
    p = epipolar_constraint_matrix(pts1n, pts2n)
    if normalize_svd:
        p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + eps)
    X = p * weights[..., None]
    # The Gram matrix is summed in float64: a float32 matmul on the CPU sums
    # less exactly than the JAX package's float32 einsum, and near-degenerate
    # weighted fits (untrained weights, sampled subsets with repeated points)
    # took the float32 gradients twice as far from float64 as the JAX
    # package's (tests/test_torch_sample_loss.py).
    f = smallest_singular_vec_gram(X, gap_eps, accumulate=torch.float64)
    F2 = rank2_projection(f.reshape(f.shape[:-1] + (3, 3)), gap_eps)
    residual = (X @ f[..., :, None])[..., 0]
    if sign_canonical:
        idx = torch.argmax(torch.abs(residual), dim=-1, keepdim=True)
        r_max = torch.gather(residual, -1, idx)[..., 0]
        s = torch.where(r_max >= 0, 1.0, -1.0).to(residual.dtype).detach()
        residual = residual * s[..., None]
        f = f * s[..., None]
        F2 = F2 * s[..., None, None]
    F_out = T2.transpose(-1, -2) @ F2 @ T1
    return FitResult(F=F_out, residual=residual, F_norm=F2, f_vec=f, T1=T1, T2=T2)
