"""Data: the synthetic two-view generators (correspondences, image pairs,
image sequences) and the dump-tree dataset."""

from .kitti import KittiCorrDataset
from .synthetic import SyntheticPairs
from .synthetic_images import SyntheticImagePairs, SyntheticImageSequence

__all__ = ["KittiCorrDataset", "SyntheticImagePairs", "SyntheticImageSequence", "SyntheticPairs"]
