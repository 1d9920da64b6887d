"""Essential-matrix decomposition, two-view depths and pose recovery.

Counterpart of `deepfepe_tpu/geometry/decompose.py`: the batched,
closed-form replacement of cv2.recoverPose. V comes from eigh(EᵀE), U's
first two columns are E vᵢ / ‖E vᵢ‖ and u₃ = u₁ × u₂.
`decompose_E_closed_form` is the pose loss's decomposition, whose
gradients stay defined at the (s, s, 0) degeneracy of a valid E.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.eigh import DEFAULT_GAP_EPS, safe_eigh, smallest_eigvec
from .basic import homo, safe_norm, skew


class EDecomposition(NamedTuple):
    R1: torch.Tensor  # [..., 3, 3]  U W Vᵀ
    R2: torch.Tensor  # [..., 3, 3]  U Wᵀ Vᵀ
    t: torch.Tensor   # [..., 3]     unit left null vector (±t)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def decompose_E(E: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS, eps: float = 1e-12):
    """Four-candidate decomposition {R1, R2} × {t, -t} of [..., 3, 3]
    essential matrices, with W negated where det(U W Vᵀ) < 0."""
    G = E.transpose(-1, -2) @ E
    w, V_asc = safe_eigh(G, gap_eps)
    V = V_asc.flip(-1)  # columns: largest, middle, smallest
    Ev1 = (E @ V[..., :, 0:1])[..., 0]
    Ev2 = (E @ V[..., :, 1:2])[..., 0]
    u1 = Ev1 / (safe_norm(Ev1, dim=-1, keepdim=True) + eps)
    u2 = Ev2 / (safe_norm(Ev2, dim=-1, keepdim=True) + eps)
    u3 = torch.linalg.cross(u1, u2)
    U = torch.stack([u1, u2, u3], dim=-1)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Vt = V.transpose(-1, -2)
    sign = torch.where(_det3(U @ W @ Vt) < 0, -1.0, 1.0).to(E.dtype)[..., None, None]
    Wc = W * sign
    R1 = U @ Wc @ Vt
    R2 = U @ Wc.transpose(-1, -2) @ Vt
    t = u3 / (safe_norm(u3, dim=-1, keepdim=True) + eps)
    return EDecomposition(R1=R1, R2=R2, t=t)


def _cofactor_3x3(M: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of [..., 3, 3]: rows are cross products of M's rows."""
    m1, m2, m3 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    return torch.stack([torch.linalg.cross(m2, m3), torch.linalg.cross(m3, m1),
                        torch.linalg.cross(m1, m2)], dim=-2)


def decompose_E_closed_form(E: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS,
                            eps: float = 1e-12) -> EDecomposition:
    """Horn-style closed-form decomposition of [..., 3, 3] essential
    matrices. Only the well-separated null direction is solved spectrally:

      Ê  = √2 · E/‖E‖_F
      t  = unit left null vector of Ê (smallest eigvec of ÊÊᵀ)
      R₁ = cof(Ê) − [t]×Ê,   R₂ = cof(Ê) + [t]×Ê

    `gap_eps` broadens the eigengap in the backward (see `ops.safe_eigh`).
    """
    fro = torch.sqrt(torch.sum(E * E, dim=(-1, -2), keepdim=True) + eps)
    En = E * (2.0 ** 0.5 / fro)
    G = En @ En.transpose(-1, -2)
    _, t = smallest_eigvec(G, gap_eps)
    C = _cofactor_3x3(En)
    tE = skew(t) @ En
    return EDecomposition(R1=C - tE, R2=C + tE, t=t)


def two_view_depths(R, t, x1, x2, eps: float = 1e-12):
    """Closed-form depths (z1, z2) [..., N] solving z2·x̂2 = z1·R x̂1 + t for
    normalized homogeneous points x1, x2 [..., N, 3]."""
    Rx1 = x1 @ R.transpose(-1, -2)
    t_b = t[..., None, :].expand(Rx1.shape)
    x2 = x2.expand(Rx1.shape)
    c_a = torch.linalg.cross(x2, Rx1)
    z1 = -torch.sum(torch.linalg.cross(x2, t_b) * c_a, dim=-1) / (
        torch.sum(c_a * c_a, dim=-1) + eps)
    c_b = torch.linalg.cross(Rx1, x2)
    z2 = torch.sum(torch.linalg.cross(Rx1, t_b) * c_b, dim=-1) / (
        torch.sum(c_b * c_b, dim=-1) + eps)
    return z1, z2


class RecoveredPose(NamedTuple):
    R: torch.Tensor            # [..., 3, 3]
    t: torch.Tensor            # [..., 3] unit
    inlier_frac: torch.Tensor  # [...] share of points passing cheirality
    mask: torch.Tensor         # [..., N] cheirality mask of the winner


def recover_pose(E, x1_norm, x2_norm, point_weights=None, depth_thresh: float = 50.0,
                 gap_eps: float = DEFAULT_GAP_EPS) -> RecoveredPose:
    """Pick the (R, t) candidate with the most points in front of both
    cameras (depth in (0, depth_thresh)); points are normalized image
    coordinates [..., N, 2] or [..., N, 3]."""
    if x1_norm.shape[-1] == 2:
        x1_norm, x2_norm = homo(x1_norm), homo(x2_norm)
    dec = decompose_E(E, gap_eps)
    Rs = torch.stack([dec.R1, dec.R1, dec.R2, dec.R2], dim=-3)  # [..., 4, 3, 3]
    ts = torch.stack([dec.t, -dec.t, dec.t, -dec.t], dim=-2)    # [..., 4, 3]
    z1, z2 = two_view_depths(Rs, ts, x1_norm[..., None, :, :], x2_norm[..., None, :, :])
    good = (z1 > 0) & (z1 < depth_thresh) & (z2 > 0) & (z2 < depth_thresh)
    if point_weights is not None:
        votes = torch.sum(good * point_weights[..., None, :], dim=-1)
    else:
        votes = torch.sum(good, dim=-1)
    best = torch.argmax(votes, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = good.shape[-1]
    mask = torch.gather(good, -2, best[..., None, None].expand(best.shape + (1, n)))[..., 0, :]
    return RecoveredPose(R=R, t=t, inlier_frac=votes.max(dim=-1).values / x1_norm.shape[-2],
                         mask=mask)
