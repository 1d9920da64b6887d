"""SuperPoint frontend: CNNs, NMS, soft-argmax, matching, pipeline."""

from .matching import Matches, descriptor_distance, gather_matches, mutual_nn_match
from .pipeline import (FrontendParams, ValModelHeatmap, frontend_params_from_config,
                       get_matches_from_sp, run_superpoint)
from .process import (Keypoints, extract_keypoints, nms_heatmap, sample_descriptors,
                      soft_argmax_refine, topk_keypoints)
from .superpoint import SuperPointNet, SuperPointNetGauss2, flatten_detection

__all__ = [k for k in dir() if not k.startswith("_")]
