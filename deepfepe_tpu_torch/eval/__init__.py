"""Evaluation: the RANSAC-F baseline, per-pair pose validation and the
frontend's epipolar-distance evaluation."""

from .frontend_eval import frontend_epidist_eval
from .ransac import RansacResult, draw_hypotheses, ransac_f, ransac_f_batch
from .val_rt import inlier_ratios, val_rt_batch

__all__ = ["RansacResult", "draw_hypotheses", "frontend_epidist_eval", "inlier_ratios",
           "ransac_f", "ransac_f_batch", "val_rt_batch"]
