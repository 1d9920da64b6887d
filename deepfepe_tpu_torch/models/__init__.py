"""Solver networks: the weight MLPs (ErrorEstimator, GoodCorresNet) and DeepFNet."""

from .deepfnet import DeepFNet
from .error_estimator import ErrorEstimator, GoodCorresNet, InstanceNorm1d

__all__ = ["DeepFNet", "ErrorEstimator", "GoodCorresNet", "InstanceNorm1d"]
