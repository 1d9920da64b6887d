"""Solver losses."""

from .f_loss import f_loss, residual_summaries, unique_topk

__all__ = ["f_loss", "residual_summaries", "unique_topk"]
