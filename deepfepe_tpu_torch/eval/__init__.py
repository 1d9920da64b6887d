"""Evaluation: the RANSAC-F baseline and per-pair pose validation."""

from .ransac import RansacResult, draw_hypotheses, ransac_f, ransac_f_batch
from .val_rt import inlier_ratios, val_rt_batch

__all__ = ["RansacResult", "draw_hypotheses", "inlier_ratios", "ransac_f",
           "ransac_f_batch", "val_rt_batch"]
