"""Solver networks: the weight MLPs (ErrorEstimator and its fusion heads,
GoodCorresNet), DeepFNet and differentiable RANSAC (`dsac_essential`)."""

from .deepfnet import DeepFNet
from .dsac import dsac_essential
from .error_estimator import (ErrorEstimator, ErrorEstimatorFeatFusion,
                              ErrorEstimatorFeatFusion2Head, GoodCorresNet, InstanceNorm1d)

__all__ = ["DeepFNet", "ErrorEstimator", "ErrorEstimatorFeatFusion",
           "ErrorEstimatorFeatFusion2Head", "GoodCorresNet", "InstanceNorm1d", "dsac_essential"]
