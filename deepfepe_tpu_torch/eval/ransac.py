"""Fixed-budget 8-point RANSAC baseline for F, batched over pairs.

Counterpart of `ransac_f` / `ransac_f_batch` in
`deepfepe_tpu/eval/ransac.py`. All B x H minimal fits are one 9x9 eigh
batch (one eigh9 launch on the card), scored as one [B, H, N] distance
array; the best hypothesis' inliers are refit with one more weighted
8-point solve (a second launch).

Hypotheses come from `idxs` [B, H, 8] when given (the tests pass the JAX
package's draw), else from `generator`. Draws are made on the CPU and
moved to the points' device, so a seed gives the same hypotheses on any
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.basic import homo
from ..geometry.epipolar import epi_distance, hartley_normalize
from ..ops.eigh import smallest_singular_vec_gram
from ..ops.fmatrix import weighted_eight_point
from ..ops.svd3 import rank2_projection


class RansacResult(NamedTuple):
    F: torch.Tensor            # [..., 3, 3] refit on inliers
    inlier_mask: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...]


def draw_hypotheses(B: int, n: int, num_hypotheses: int = 512,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Minimal-sample indices [B, H, 8] in [0, n)."""
    return torch.randint(0, n, (B, num_hypotheses, 8), generator=generator)


def _fit_minimal(pts1_h, pts2_h, idxs):
    """8-point fits on the subsets `idxs` [B, H, 8] of [B, N, 3] points."""
    b = torch.arange(pts1_h.shape[0], device=pts1_h.device)[:, None, None]
    p1n, T1 = hartley_normalize(pts1_h[b, idxs])  # [B, H, 8, 3]
    p2n, T2 = hartley_normalize(pts2_h[b, idxs])
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # [B, H, 8, 9]
    f = smallest_singular_vec_gram(A)
    F = rank2_projection(f.reshape(f.shape[:-1] + (3, 3)))
    return T2.transpose(-1, -2) @ F @ T1  # [B, H, 3, 3]


def ransac_f_batch(x1: torch.Tensor, x2: torch.Tensor, idxs: torch.Tensor | None = None,
                   generator: torch.Generator | None = None, num_hypotheses: int = 512,
                   threshold: float = 1.0, refit: bool = True) -> RansacResult:
    """8-point RANSAC for F on each pair of x1, x2 [B, N, 2] (the threshold
    is in the points' units)."""
    B, n = x1.shape[0], x1.shape[1]
    if idxs is None:
        idxs = draw_hypotheses(B, n, num_hypotheses, generator)
    idxs = idxs.to(device=x1.device, dtype=torch.long)
    pts1_h, pts2_h = homo(x1), homo(x2)
    Fs = _fit_minimal(pts1_h, pts2_h, idxs)
    d, _, _ = epi_distance(Fs, x1[:, None], x2[:, None])  # [B, H, N]
    inliers = d < threshold
    best = torch.argmax(inliers.sum(dim=-1), dim=-1)  # [B]
    ar = torch.arange(B, device=x1.device)
    mask = inliers[ar, best]
    if refit:
        w = mask.to(x1.dtype)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
        F_best = weighted_eight_point(pts1_h, pts2_h, w, normalize_svd=False).F
        d_f, _, _ = epi_distance(F_best, x1, x2)
        mask = d_f < threshold
    else:
        F_best = Fs[ar, best]
    return RansacResult(F=F_best, inlier_mask=mask, num_inliers=mask.sum(dim=-1))


def ransac_f(x1: torch.Tensor, x2: torch.Tensor, idxs: torch.Tensor | None = None,
             generator: torch.Generator | None = None, **kw) -> RansacResult:
    """8-point RANSAC for F on one pair: x1, x2 [N, 2], idxs [H, 8]."""
    r = ransac_f_batch(x1[None], x2[None], None if idxs is None else idxs[None],
                       generator, **kw)
    return RansacResult(F=r.F[0], inlier_mask=r.inlier_mask[0], num_inliers=r.num_inliers[0])
