"""Differentiable RANSAC (DSAC) for essential-matrix fitting.

Counterpart of `deepfepe_tpu/models/dsac.py` (the reference's
`dsac_tools/dsac.py` :15-194): minimal-subset E hypotheses, each scored by
a soft (sigmoid) Sampson inlier count; a softmax over the scores gives the
hypothesis distribution, whose expected loss is the DSAC objective, and
the best hypothesis is refit on its soft inlier weights. All hypotheses
are one batched weighted 8-point fit (one eigh9 launch on the card) and
the refit one more; the scores are one [H, N] distance array.

The minimal sets come from `idx` [hyps, sample_size] when given (a test
hands over the JAX package's draw, as `val_rt_batch(ransac_idxs=...)`
takes them), else from `generator`; draws are made on the CPU and moved to
the points' device, so a seed gives the same hypotheses on any device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..geometry.basic import homo
from ..geometry.epipolar import sampson_dist
from ..ops.fmatrix import weighted_eight_point


def dsac_essential(x1_norm: torch.Tensor, x2_norm: torch.Tensor,
                   generator: torch.Generator | None = None,
                   loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
                   hyps: int = 64, sample_size: int = 10, inlier_thresh: float = 1e-4,
                   inlier_beta: float = 1e5, inlier_alpha: float = 0.5,
                   idx: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """x1_norm, x2_norm [N, 2] K-normalized points -> {'E_best', 'E_hyps',
    'hyp_probs', 'soft_scores', 'inlier_weights'}, and with `loss_fn(E) ->
    scalar` (a hypothesis scored against ground truth, mapped over the
    hypotheses by `torch.func.vmap`) also 'exp_loss' and 'top_loss'."""
    n = x1_norm.shape[0]
    p1h, p2h = homo(x1_norm), homo(x2_norm)
    if idx is None:
        idx = torch.randint(0, n, (hyps, sample_size), generator=generator)
    idx = idx.to(x1_norm.device)
    hyps, sample_size = idx.shape
    w = torch.full((hyps, sample_size), 1.0 / sample_size, dtype=x1_norm.dtype,
                   device=x1_norm.device)
    E_hyps = weighted_eight_point(p1h[idx], p2h[idx], w).F  # normalized coordinates: F = E

    d = sampson_dist(E_hyps[:, None], x1_norm[None], x2_norm[None]).reshape(hyps, n)
    soft = 1.0 - torch.sigmoid(inlier_beta * (d - inlier_thresh))
    scores = soft.sum(-1)  # [H]
    probs = torch.softmax(inlier_alpha * scores, dim=0)
    best = torch.argmax(scores)

    w_ref = soft[best] / (soft[best].sum() + 1e-10)
    E_best = weighted_eight_point(p1h[None], p2h[None], w_ref[None]).F[0]
    out = {"E_best": E_best, "E_hyps": E_hyps, "hyp_probs": probs, "soft_scores": scores,
           "inlier_weights": w_ref}
    if loss_fn is not None:
        losses = torch.func.vmap(loss_fn)(E_hyps)  # [H]
        out["exp_loss"] = (probs * losses).sum()
        out["top_loss"] = losses[best]
    return out
