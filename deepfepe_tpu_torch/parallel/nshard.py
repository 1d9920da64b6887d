"""Correspondence-parallel weighted 8-point fit (the N axis sharded).

Counterpart of `deepfepe_tpu/parallel/nshard.py`. Every cross-point
reduction of `ops.fmatrix.weighted_eight_point` is a sum over N: the
Hartley sums (Σ1, Σx, Σdist) and the 9x9 Gram G = Σₙ (wₙpₙ)(wₙpₙ)ᵀ; the
row normalization and the algebraic residual are per point. So with each
rank of a group holding N / n of the correspondences, the fit is three
all-reduced sums and one all-reduced Gram (summed in float64, as the
one-device fit sums it), the smallest eigenvector of the global Gram
(`ops.eigh.smallest_eigvec`: the eigh9 kernel on the card), the rank-2
projection, and the residual, which stays N-sharded.

Differentiable under the conventions of `parallel.mesh`: the sums are
`reduce`d (their cotangent is the replicated one of F), and the
replicated centroid, transform and null vector enter the rank-local work
through `copy`, so a loss on the local residual reaches every rank's
points and weights as the one-device fit's gradient does.
"""

from __future__ import annotations

import torch

from ..geometry.basic import safe_norm
from ..geometry.epipolar import epipolar_constraint_matrix
from ..ops.eigh import DEFAULT_GAP_EPS, smallest_eigvec
from ..ops.svd3 import rank2_projection
from .mesh import MODEL_AXIS, Mesh, copy, reduce


def _hartley_T(c: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    z, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([torch.stack([scale, z, -c[..., 0] * scale], -1),
                        torch.stack([z, scale, -c[..., 1] * scale], -1),
                        torch.stack([z, z, one], -1)], -2)


def gram_partial(X: torch.Tensor) -> torch.Tensor:
    """This rank's share of the Gram matrix, XᵀX summed in float64."""
    Xa = X.to(torch.promote_types(X.dtype, torch.float64))
    return Xa.transpose(-1, -2) @ Xa


def make_nsharded_fit(mesh: Mesh, axis: str = MODEL_AXIS, normalize_svd: bool = True,
                      gap_eps: float = DEFAULT_GAP_EPS, eps: float = 1e-10):
    """fit(pts1_h, pts2_h, weights) on this rank's shard of N: points [B,
    N/n, 3] homogeneous, weights [B, N/n] -> (F [B, 3, 3], the same on every
    rank of the group; residual [B, N/n], this rank's), the values of
    `weighted_eight_point(...)[:2]` with uniform-weight normalization."""
    group = mesh.group(axis)

    def normalize(pts_h):
        """The global Hartley transform from the group's sums, applied to
        this rank's points (uniform weights, Fit.normalize DeepFNet.py:148)."""
        n_local = torch.full(pts_h.shape[:-2], float(pts_h.shape[-2]), dtype=pts_h.dtype,
                             device=pts_h.device)
        sw = reduce(n_local, group)
        c = reduce(pts_h.sum(-2), group) / sw[..., None]
        dist = safe_norm(pts_h[..., :2] - copy(c, group)[..., None, :2], dim=-1)
        meandist = reduce(dist.sum(-1), group) / sw
        T = _hartley_T(c, (2.0 ** 0.5) / torch.clamp(meandist, min=1e-6))
        return pts_h @ copy(T, group).transpose(-1, -2), T

    def fit(pts1_h, pts2_h, weights):
        pts1n, T1 = normalize(pts1_h)
        pts2n, T2 = normalize(pts2_h)
        p = epipolar_constraint_matrix(pts1n, pts2n)
        if normalize_svd:
            p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + eps)
        X = p * weights[..., None]
        G = reduce(gram_partial(X), group).to(X.dtype)
        _, f = smallest_eigvec(G, gap_eps)
        F2 = rank2_projection(f.reshape(f.shape[:-1] + (3, 3)), gap_eps)
        residual = (X @ copy(f, group)[..., :, None])[..., 0]
        return T2.transpose(-1, -2) @ F2 @ T1, residual

    return fit
