"""3x3 spectral ops on the safe eigensolver: rank-2 and (1, 1, 0)
projections, singular values. Counterpart of `deepfepe_tpu/ops/svd3.py`.

rank-2: F' = F (I - v₃ v₃ᵀ), v₃ the smallest eigenvector of FᵀF, so no
U is formed and nothing divides by a small singular value.
"""

from __future__ import annotations

import torch

from .eigh import DEFAULT_GAP_EPS, safe_eigh, smallest_eigvec


def rank2_projection(F: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS) -> torch.Tensor:
    """Project [..., 3, 3] matrices to rank 2 by zeroing the smallest s.v."""
    _, v3 = smallest_eigvec(F.transpose(-1, -2) @ F, gap_eps)
    return F - (F @ v3[..., :, None]) @ v3[..., None, :]


def project_E_110(E: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS, eps: float = 1e-12):
    """Project [..., 3, 3] to singular values (1, 1, 0): E V diag(1/s1, 1/s2,
    0) Vᵀ with (s², V) = eigh(EᵀE)."""
    w, V = safe_eigh(E.transpose(-1, -2) @ E, gap_eps)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    inv_s = torch.where(s > eps, 1.0 / torch.clamp(s, min=eps), torch.zeros_like(s))
    scale = torch.cat([torch.zeros_like(inv_s[..., :1]), inv_s[..., 1:]], dim=-1)
    return E @ ((V * scale[..., None, :]) @ V.transpose(-1, -2))


def singular_values_3x3(F: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS):
    """Descending singular values of [..., 3, 3] via eigh(FᵀF)."""
    w, _ = safe_eigh(F.transpose(-1, -2) @ F, gap_eps)
    return torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
