"""Data: the synthetic two-view generators (correspondences, image pairs,
image sequences, correspondence sequences) and the dump-tree dataset."""

from .kitti import KittiCorrDataset
from .synthetic import SyntheticPairs
from .synthetic_images import SyntheticImagePairs, SyntheticImageSequence
from .synthetic_sequence import SyntheticSequence

__all__ = ["KittiCorrDataset", "SyntheticImagePairs", "SyntheticImageSequence", "SyntheticPairs",
           "SyntheticSequence"]
