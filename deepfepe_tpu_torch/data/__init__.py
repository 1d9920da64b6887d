"""Data: the synthetic two-view generators (correspondences, image pairs)."""

from .synthetic import SyntheticPairs
from .synthetic_images import SyntheticImagePairs

__all__ = ["SyntheticImagePairs", "SyntheticPairs"]
