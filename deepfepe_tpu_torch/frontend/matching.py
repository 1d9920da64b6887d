"""Mutual nearest-neighbour descriptor matching, batched and static-shape.

Counterpart of `deepfepe_tpu/frontend/matching.py`. A pair (i, j) is kept
when j is i's nearest neighbour, i is j's, the distance is below
`nn_thresh` and both keypoints are valid. Matches come sorted best-first
(a stable sort, as `jnp.argsort` is) and padded to `num_matches` with a
validity mask.

Two routes give the same match set:
- 'xla' (the JAX name, kept): the masked plain path, which forms the
  [B, K, K] distance matrix;
- 'pallas' (the JAX name, kept): kernel K4 (`ops.matcher.mutual_nn_kernel`),
  which never stores that matrix. Its outputs carry no gradient, so the
  chosen pairs' distances are recomputed from the indices by a gather, and
  the scores stay differentiable.
'auto' takes K4 for a CUDA tensor when K >= PALLAS_MATCHER_MIN_K, as the
JAX package does on the TPU, and the plain path otherwise: the same
routing rule, not a fallback. `DEEPFEPE_MATCHER_IMPL` sets the default.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..ops.matcher import mutual_nn_kernel

DEFAULT_MATCHER_BACKEND = os.environ.get("DEEPFEPE_MATCHER_IMPL", "auto")
PALLAS_MATCHER_MIN_K = 768
BACKENDS = ("auto", "xla", "pallas")
BIG = 1e9


class Matches(NamedTuple):
    idx1: torch.Tensor    # [B, M] indices into keypoint set 1
    idx2: torch.Tensor    # [B, M] indices into keypoint set 2
    scores: torch.Tensor  # [B, M] descriptor distance of the match
    valid: torch.Tensor   # [B, M] bool


def _zero_safe_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with value and gradient 0 at 0 (matched pairs minimize the
    distance, so 0 is the attractor, where sqrt's gradient is infinite)."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def descriptor_distance(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 distance of unit descriptors, sqrt(2 - 2 d1.d2):
    [..., K, D] x [..., K, D] -> [..., K, K]."""
    dot = desc1 @ desc2.transpose(-1, -2)
    return _zero_safe_sqrt(torch.clamp(2.0 - 2.0 * dot, min=0.0))


def route(backend: str | None, is_cuda: bool, K: int) -> str:
    """The route `mutual_nn_match` takes: 'pallas' (K4) or 'xla' (plain)."""
    backend = backend or DEFAULT_MATCHER_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"matcher backend {backend!r} is not one of {BACKENDS}")
    if backend == "auto":
        return "pallas" if is_cuda and K >= PALLAS_MATCHER_MIN_K else "xla"
    return backend


def mutual_nn_match(desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor,
                    valid2: torch.Tensor, nn_thresh: float = 1.0,
                    num_matches: int | None = None, backend: str | None = None) -> Matches:
    """Two-way mutual NN matching of desc [B, K, D] with masks [B, K]."""
    B, K, _ = desc1.shape
    num_matches = num_matches or K
    if route(backend, desc1.is_cuda, K) == "pallas":
        nn12, _, _, mutual = mutual_nn_kernel(desc1, desc2, valid1, valid2)
        nn12 = nn12.long()
        d2_sel = torch.gather(desc2, 1, nn12[..., None].expand(-1, -1, desc2.shape[-1]))
        dot = (desc1 * d2_sel).sum(-1)
        dist_i = _zero_safe_sqrt(torch.clamp(2.0 - 2.0 * dot, min=0.0))
    else:
        d = descriptor_distance(desc1, desc2)
        d = torch.where(valid1[..., :, None] & valid2[..., None, :], d,
                        torch.full_like(d, BIG))
        nn12 = torch.argmin(d, dim=-1)
        nn21 = torch.argmin(d, dim=-2)
        mutual = torch.gather(nn21, -1, nn12) == torch.arange(K, device=d.device)
        dist_i = torch.gather(d, -1, nn12[..., None])[..., 0]
    keep = mutual & (dist_i < nn_thresh) & valid1
    sort_key = torch.where(keep, dist_i, torch.full_like(dist_i, BIG))
    order = torch.argsort(sort_key.detach(), dim=-1, stable=True)[..., :num_matches]
    valid = torch.gather(keep, -1, order)
    zero = torch.zeros((), dtype=order.dtype, device=order.device)
    idx1 = torch.where(valid, order, zero)
    idx2 = torch.where(valid, torch.gather(nn12, -1, order), zero)
    scores = torch.where(valid, torch.gather(dist_i, -1, order), torch.zeros_like(dist_i[:, :1]))
    return Matches(idx1=idx1, idx2=idx2, scores=scores, valid=valid)


def gather_matches(kpts_xy1: torch.Tensor, kpts_xy2: torch.Tensor,
                   matches: Matches) -> torch.Tensor:
    """[B, M, 4] correspondences (x1, y1, x2, y2) from match indices; zero
    where a match is not valid."""
    p1 = torch.gather(kpts_xy1, 1, matches.idx1[..., None].expand(-1, -1, 2))
    p2 = torch.gather(kpts_xy2, 1, matches.idx2[..., None].expand(-1, -1, 2))
    out = torch.cat([p1, p2], dim=-1)
    return torch.where(matches.valid[..., None], out, torch.zeros_like(out))
