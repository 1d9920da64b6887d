"""Sampled minimal-subset fits: the sample-loss variant's auxiliary head.

Counterpart of `deepfepe_tpu/models/sample_fit.py` (ref
`DeepFNetSampleLoss.Fit.forward`): per pair, F fitted on `selects` subsets
of `topk` correspondences drawn with replacement in proportion to the
predicted weights among the first `unique_nums` (the unique matches), each
hypothesis scored by the normalized product of its members' weights. All
B x S subset fits are one weighted 8-point batch (one eigh9 launch on the
card). The JAX function also fits the top-`topk` weighted matches
('F_topK'), which nothing reads (XLA drops it under jit); the port does
not compute it.

The draws come from an explicit `torch.Generator` on the batch's device,
so they cannot equal the JAX package's `jax.random.categorical` draws from
the same seed; `idx` replays given indices instead (the tests pass the JAX
package's).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.fmatrix import weighted_eight_point


def draw_subsets(weights: torch.Tensor, unique_nums: torch.Tensor, selects: int, topk: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Indices [B, selects, topk] drawn with replacement with probability
    proportional to weights [B, N] + 1e-12 among each row's first
    `unique_nums[b]` entries (the JAX package's categorical over
    log(w + 1e-12), masked). Non-finite weights draw as 0."""
    B, N = weights.shape
    unique = torch.arange(N, device=weights.device) < unique_nums.to(weights.device)[:, None]
    w = torch.nan_to_num(weights.detach(), nan=0.0, posinf=0.0, neginf=0.0).clamp_min(0.0)
    p = torch.where(unique, w + 1e-12, torch.zeros_like(w))
    idx = torch.multinomial(p, selects * topk, replacement=True, generator=generator)
    return idx.view(B, selects, topk)


def sample_loss_fits(pts1_h, pts2_h, weights, unique_nums, generator: torch.Generator | None = None,
                     topk: int = 20, selects: int = 100,
                     idx: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """Points [B, N, 3], weights [B, N], unique_nums [B] -> {'F_samples' [B,
    S, 3, 3], 'sample_scores' [B, S], 'sample_idx' [B, S, K]}: the fits on
    the drawn subsets (`idx` [B, S, K] when given, else drawn from
    `generator`) and their scores, softmax over S of the summed
    log-weights: the reference's normalized product of w x 1000, which
    overflows float32 once the softmax concentrates, computed in log space
    (the x1000^K factor cancels)."""
    B = pts1_h.shape[0]
    if idx is None:
        idx = draw_subsets(weights, unique_nums, selects, topk, generator)
    idx = idx.to(device=pts1_h.device, dtype=torch.long)
    b = torch.arange(B, device=pts1_h.device)[:, None, None]
    w_sel = weights[b, idx]  # [B, S, K]
    fit = weighted_eight_point(pts1_h[b, idx], pts2_h[b, idx], w_sel)
    score = torch.softmax(torch.sum(torch.log(w_sel + 1e-12), dim=-1), dim=-1)
    return {"F_samples": fit.F, "sample_scores": score, "sample_idx": idx}
