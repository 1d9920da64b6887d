"""Nister's five-point minimal solver for the essential matrix, batched.

Counterpart of `deepfepe_tpu/geometry/fivepoint.py`. The JAX package
solves one sample and vmaps it; here every function takes a leading
sample axis [S, ...] and no step loops over samples in Python:

1. Null space: the four smallest eigenvectors of each 5x9 constraint
   matrix's 9x9 Gram matrix, all S Grams through ONE `safe_eigh` call (one
   eigh9 launch on the card). E = x E1 + y E2 + z E3 + E4.
2. The ten cubic constraints (det E = 0, 2 E Eᵀ E - tr(E Eᵀ) E = 0) are
   expanded numerically, each polynomial a vector of its coefficients over
   the 20 monomials of total degree <= 3 (`_MONOMIALS`); a product of two
   polynomials is a fixed gather of the 84 coefficient pairs whose degrees
   fit, summed by a 0/1 matrix. (The JAX package convolves dense [4, 4, 4]
   tensors and keeps [:4, :4, :4]: the same coefficients, since no product
   here exceeds degree 3.)
3. Gauss-Jordan of the 10x20 matrix by one batched `linalg.solve_ex`; a
   singular system (a sample with a repeated index makes one) marks its
   sample invalid, as the JAX package's non-finite mask does, instead of
   raising.
4. Real roots of the degree-10 det B(z): z = tan(theta), the homogeneous
   form cos^10(theta) det B(tan theta) on a uniform theta grid, up to ten
   sign changes (earliest first, `topk`), then a fixed number of
   bisection steps as batched tensor operations.
5. Back-substitution of (x cos theta, y cos theta) by the normal
   equations, E normalized to unit Frobenius norm.

Returns up to ten candidates a sample with a validity mask; the RANSAC
selection over samples x candidates is `eval.ransac.ransac_e_batch`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.eigh import safe_eigh

# Monomials (powers of x, y, z) in the column order of Nister's 10x20
# matrix: the first ten are eliminated by Gauss-Jordan, the last ten are
# [xz², xz, x, yz², yz, y, z³, z², z, 1].
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
_X, _Y, _Z, _ONE = _INDEX[(1, 0, 0)], _INDEX[(0, 1, 0)], _INDEX[(0, 0, 1)], _INDEX[(0, 0, 0)]


def _product_table():
    """(IA, IB, OUT): every pair of monomials whose product has degree <= 3."""
    ia, ib, out = [], [], []
    for a, ma in enumerate(_MONOMIALS):
        for b, mb in enumerate(_MONOMIALS):
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            if sum(m) <= 3:
                ia.append(a)
                ib.append(b)
                out.append(_INDEX[m])
    return ia, ib, out


_IA, _IB, _OUT = _product_table()


class FivePointCandidates(NamedTuple):
    E: torch.Tensor      # [S, 10, 3, 3] candidate essential matrices (unit norm)
    valid: torch.Tensor  # [S, 10] bool: a real root was bracketed and E is finite


class _Poly:
    """Products of polynomials over `_MONOMIALS`, on one dtype and device."""

    def __init__(self, dtype, device):
        self.ia = torch.tensor(_IA, device=device)
        self.ib = torch.tensor(_IB, device=device)
        self.sum = torch.zeros(len(_IA), len(_MONOMIALS), dtype=dtype, device=device)
        self.sum[torch.arange(len(_IA)), torch.tensor(_OUT)] = 1.0

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[..., 20] x [..., 20] -> [..., 20] (broadcasting the lead axes)."""
        return (a[..., self.ia] * b[..., self.ib]) @ self.sum


def _nullspace_basis(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """[S, 5, 2] x [S, 5, 2] normalized correspondences -> E basis [S, 4, 3, 3]:
    the four smallest eigenvectors of the Gram matrices, one eigh call."""
    x1, y1 = x1n[..., 0], x1n[..., 1]
    x2, y2 = x2n[..., 0], x2n[..., 1]
    Q = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # [S, 5, 9]
    G = Q.transpose(-1, -2) @ Q
    _, V = safe_eigh(G)  # ascending
    return V[..., :4].transpose(-1, -2).reshape(x1n.shape[:-2] + (4, 3, 3))


def _constraint_matrix(Es: torch.Tensor, poly: _Poly) -> torch.Tensor:
    """The 10x20 coefficient matrices [S, 10, 20] from the bases [S, 4, 3, 3]."""
    P = torch.zeros(Es.shape[:-3] + (3, 3, len(_MONOMIALS)), dtype=Es.dtype, device=Es.device)
    for k, m in enumerate((_X, _Y, _Z, _ONE)):
        P[..., m] = Es[..., k, :, :]
    pm = poly.mul
    # det(E) by cofactors along the first row.
    minors = pm(P[..., 1, [1, 0, 0], :], P[..., 2, [2, 2, 1], :]) \
        - pm(P[..., 1, [2, 2, 1], :], P[..., 2, [1, 0, 0], :])  # [S, 3, 20]
    cof = pm(P[..., 0, :, :], minors)
    det = cof[..., 0, :] - cof[..., 1, :] + cof[..., 2, :]
    # A = E Eᵀ (degree 2): A[i, k] = sum_j E[i, j] E[k, j].
    A = pm(P[..., :, None, :, :], P[..., None, :, :, :]).sum(-2)  # [S, 3, 3, 20]
    trA = A[..., 0, 0, :] + A[..., 1, 1, :] + A[..., 2, 2, :]
    # C = 2 A E - tr(A) E (degree 3): C[i, l] = 2 sum_k A[i, k] E[k, l] - tr(A) E[i, l].
    AE = pm(A[..., :, None, :, :], P.transpose(-3, -2)[..., None, :, :, :]).sum(-2)
    C = 2.0 * AE - pm(trA[..., None, None, :], P)
    return torch.cat([det[..., None, :], C.reshape(C.shape[:-3] + (9, len(_MONOMIALS)))],
                     dim=-2)


def _B_row_polys(Bred: torch.Tensor):
    """Nister's row pairing on the reduced [S, 10, 10] (columns [xz², xz, x,
    yz², yz, y, z³, z², z, 1]): rows <e> - z<f>, <g> - z<h>, <i> - z<j>
    give B(z), 3x3, whose x and y entries have degree 3 and constant
    entries degree 4. Returns (bx [S, 3, 4], by [S, 3, 4], bc [S, 3, 5]),
    coefficients highest degree first."""
    e, f = Bred[..., [4, 6, 8], :], Bred[..., [5, 7, 9], :]
    bx = torch.stack([-f[..., 0], e[..., 0] - f[..., 1], e[..., 1] - f[..., 2], e[..., 2]], -1)
    by = torch.stack([-f[..., 3], e[..., 3] - f[..., 4], e[..., 4] - f[..., 5], e[..., 5]], -1)
    bc = torch.stack([-f[..., 6], e[..., 6] - f[..., 7], e[..., 7] - f[..., 8],
                      e[..., 8] - f[..., 9], e[..., 9]], -1)
    return bx, by, bc


def _homog_eval(coeffs: torch.Tensor, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """c^d p(s/c) = sum_k a_k s^(d-k) c^k for every row of coeffs [S, 3, d+1]
    at every angle of s, c [S, T] -> [S, T, 3]."""
    d = coeffs.shape[-1] - 1
    ks = torch.arange(d + 1, device=coeffs.device)
    basis = s[..., None] ** (d - ks) * c[..., None] ** ks  # [S, T, d+1]
    return (coeffs[..., None, :, :] * basis[..., None, :]).sum(-1)


def _det_b_homog(bx, by, bc, theta: torch.Tensor) -> torch.Tensor:
    """cos^10(theta) det B(tan theta) at theta [S, T] -> [S, T]: every term
    of the determinant takes one x entry (degree 3), one y entry (3) and one
    constant entry (4)."""
    s, c = torch.sin(theta), torch.cos(theta)
    xh, yh, ch = _homog_eval(bx, s, c), _homog_eval(by, s, c), _homog_eval(bc, s, c)
    return (xh[..., 0] * (yh[..., 1] * ch[..., 2] - yh[..., 2] * ch[..., 1])
            - yh[..., 0] * (xh[..., 1] * ch[..., 2] - xh[..., 2] * ch[..., 1])
            + ch[..., 0] * (xh[..., 1] * yh[..., 2] - xh[..., 2] * yh[..., 1]))


def five_point_candidates(x1n: torch.Tensor, x2n: torch.Tensor, grid: int = 512,
                          bisect_iters: int = 40) -> FivePointCandidates:
    """Every real-root essential-matrix candidate of each five-correspondence
    sample: x1n, x2n [S, 5, 2] K-normalized coordinates."""
    S = x1n.shape[0]
    dtype, device = x1n.dtype, x1n.device
    Es = _nullspace_basis(x1n, x2n)
    M = _constraint_matrix(Es, _Poly(dtype, device))
    Bred, info = torch.linalg.solve_ex(M[..., :10], M[..., 10:])
    solved = info == 0
    Bred = torch.where(solved[:, None, None], Bred, torch.zeros_like(Bred))
    bx, by, bc = _B_row_polys(Bred)

    # Sign changes on a uniform grid over (-pi/2, pi/2), earliest first.
    eps = 1e-4
    thetas = torch.linspace(-math.pi / 2 + eps, math.pi / 2 - eps, grid, dtype=dtype,
                            device=device)
    vals = _det_b_homog(bx, by, bc, thetas.expand(S, grid))
    sign = torch.sign(vals)
    change = (sign[:, :-1] * sign[:, 1:]) < 0  # [S, grid - 1]
    score = change.to(torch.float32) * 1e6 - torch.arange(grid - 1, device=device)
    idx = torch.topk(score, 10, dim=-1).indices  # distinct scores: a stable order
    valid = torch.gather(change, 1, idx) & solved[:, None]

    lo, hi = thetas[idx], thetas[idx + 1]
    f_lo = _det_b_homog(bx, by, bc, lo)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        f_mid = _det_b_homog(bx, by, bc, mid)
        take_lo = torch.sign(f_mid) == torch.sign(f_lo)
        lo = torch.where(take_lo, mid, lo)
        f_lo = torch.where(take_lo, f_mid, f_lo)
        hi = torch.where(take_lo, hi, mid)
    theta = 0.5 * (lo + hi)  # [S, 10]
    s, c = torch.sin(theta), torch.cos(theta)

    # c^4 times a B row: xh (x c) + yh (y c) + ch = 0, so u = x cos(theta),
    # v = y cos(theta) solve [xh yh][u v]ᵀ = -ch (three equations, normal
    # equations), bounded for roots near +-pi/2.
    Amat = torch.stack([_homog_eval(bx, s, c), _homog_eval(by, s, c)], dim=-1)  # [S, 10, 3, 2]
    rhs = -_homog_eval(bc, s, c)[..., None]
    At = Amat.transpose(-1, -2)
    AtA = At @ Amat + 1e-12 * torch.eye(2, dtype=dtype, device=device)
    uv, info2 = torch.linalg.solve_ex(AtA, At @ rhs)
    uv = uv[..., 0]
    E = (uv[..., 0, None, None] * Es[:, None, 0] + uv[..., 1, None, None] * Es[:, None, 1]
         + s[..., None, None] * Es[:, None, 2] + c[..., None, None] * Es[:, None, 3])
    nrm = torch.linalg.vector_norm(E.reshape(S, 10, 9), dim=-1)
    E = E / torch.clamp(nrm, min=1e-12)[..., None, None]
    valid = valid & (info2 == 0) & torch.isfinite(E.reshape(S, 10, 9)).all(-1)
    return FivePointCandidates(E=E, valid=valid)
