"""Solver networks: the weight MLP and DeepFNet."""

from .deepfnet import DeepFNet
from .error_estimator import ErrorEstimator, InstanceNorm1d

__all__ = ["DeepFNet", "ErrorEstimator", "InstanceNorm1d"]
