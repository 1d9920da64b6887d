"""Batched cyclic-Jacobi symmetric eigensolver (plain torch).

Counterpart of `deepfepe_tpu/ops/jacobi.py`. It is the plain version of
the eigh9 kernel (`ops/eigh9.py`, `csrc/eigh9.cu`): the same fixed sweep
schedule, rotation formulas and guards, written as whole-batch tensor
operations. It also serves every eigh that is not 9x9 (the 3x3 solves).
"""

from __future__ import annotations

import torch


def _rotate(G: torch.Tensor, V: torch.Tensor, p: int, q: int, eps: float) -> None:
    """Apply one (p, q) Jacobi rotation to the whole batch, in place."""
    app = G[..., p, p]
    aqq = G[..., q, q]
    apq = G[..., p, q]
    # Golub & Van Loan alg. 8.4.1, guarded for already-annihilated entries.
    small = torch.abs(apq) <= eps * torch.sqrt(torch.abs(app * aqq) + eps)
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)[..., None]
    s = torch.where(small, torch.zeros_like(s), s)[..., None]
    # Rows p, q of G, then columns p, q (keeps symmetry), then V <- V @ J.
    Gp, Gq = G[..., p, :].clone(), G[..., q, :].clone()
    G[..., p, :] = c * Gp - s * Gq
    G[..., q, :] = s * Gp + c * Gq
    Gp, Gq = G[..., :, p].clone(), G[..., :, q].clone()
    G[..., :, p] = c * Gp - s * Gq
    G[..., :, q] = s * Gp + c * Gq
    Vp, Vq = V[..., :, p].clone(), V[..., :, q].clone()
    V[..., :, p] = c * Vp - s * Vq
    V[..., :, q] = s * Vp + c * Vq


def _fix_eigvec_signs(V: torch.Tensor) -> torch.Tensor:
    """Deterministic sign: the largest-|.| component of each column is >= 0."""
    idx = torch.argmax(torch.abs(V), dim=-2, keepdim=True)
    pivot = torch.gather(V, -2, idx)
    return V * torch.where(pivot < 0, -1.0, 1.0).to(V.dtype)


def sort_and_fix_signs(w: torch.Tensor, V: torch.Tensor):
    """Sort eigenpairs ascending and fix the eigenvector signs (the
    convention of every eigh path)."""
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, _fix_eigvec_signs(V)


@torch.no_grad()
def jacobi_eigh(A: torch.Tensor, sweeps: int = 7, eps: float = 1e-12):
    """Eigendecomposition of symmetric [..., n, n] -> (w, V), ascending, by
    `sweeps` fixed cyclic-Jacobi sweeps; signs fixed by
    `sort_and_fix_signs`."""
    n = A.shape[-1]
    G = (A + A.transpose(-1, -2)) * 0.5
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                _rotate(G, V, p, q, eps)
    w = torch.diagonal(G, dim1=-2, dim2=-1)
    return sort_and_fix_signs(w, V)
