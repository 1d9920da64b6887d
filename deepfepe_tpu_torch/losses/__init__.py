"""Solver losses: the F-loss and the pose (q, t) loss."""

from .f_loss import f_loss, residual_summaries, unique_topk
from .rt_loss import rt_loss

__all__ = ["f_loss", "residual_summaries", "rt_loss", "unique_topk"]
