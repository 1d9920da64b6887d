"""Eval metric summaries: ratios, F1, threshold curves.

A copy of `deepfepe_tpu/eval/metrics_summary.py` (numpy only; the port
shares no module with the JAX package), itself a port of the reference's
`write_metrics_summary` (train_good_utils.py:758-856): per-eval
aggregation of err_q/err_t cumulative ratio curves at thresholds
[0.01 .. 180] deg, epi-dist inlier ratios @0.1/1.0, and the weight-vs-gt
inlier F1 score. Pure numpy over collected per-pair arrays (the reference
writes these to TensorBoard; here they return a flat dict for any sink).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

DEG_THRESHOLDS = (0.01, 0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 180)


def ratio_curves(
    err_q: np.ndarray, err_t: np.ndarray,
    thresholds: Sequence[float] = DEG_THRESHOLDS,
) -> Dict[str, float]:
    out = {}
    for th in thresholds:
        out[f"ratio_q@{th}"] = float(np.mean(err_q < th))
        out[f"ratio_t@{th}"] = float(np.mean(err_t < th))
    return out


def epi_inlier_ratios(
    epi_dists: np.ndarray, thresholds=(0.1, 1.0)
) -> Dict[str, float]:
    return {
        f"epi_ratio@{th}": float(np.mean(epi_dists < th)) for th in thresholds
    }


def weight_f1(
    weights: np.ndarray,       # [B, N] solver weights
    epi_dists_gt: np.ndarray,  # [B, N] gt-F epipolar distance per point
    weight_thresh: Optional[float] = None,
    inlier_px: float = 1.0,
) -> Dict[str, float]:
    """F1 of 'solver upweights true inliers': predicted positive = weight
    above (default: uniform 1/N), actual positive = gt epi dist < inlier_px."""
    n = weights.shape[-1]
    wt = weight_thresh if weight_thresh is not None else 1.0 / n
    pred = weights > wt
    actual = epi_dists_gt < inlier_px
    tp = np.sum(pred & actual)
    prec = tp / max(np.sum(pred), 1)
    rec = tp / max(np.sum(actual), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {
        "weight_precision": float(prec),
        "weight_recall": float(rec),
        "weight_f1": float(f1),
    }


def summarize(
    err_q: np.ndarray,
    err_t: np.ndarray,
    epi_dists: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    epi_dists_gt: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    out = {
        "err_q_mean": float(np.mean(err_q)),
        "err_q_median": float(np.median(err_q)),
        "err_t_mean": float(np.mean(err_t)),
        "err_t_median": float(np.median(err_t)),
    }
    out.update(ratio_curves(err_q, err_t))
    if epi_dists is not None:
        out.update(epi_inlier_ratios(epi_dists))
    if weights is not None and epi_dists_gt is not None:
        out.update(weight_f1(weights, epi_dists_gt))
    return out
