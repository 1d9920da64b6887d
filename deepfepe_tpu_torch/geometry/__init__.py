"""Geometry: homogeneous helpers, epipolar core, rotations, the SO(3)/SE(3)
maps, correction, E decomposition."""

from .basic import (dehomo, homo, rt_depad, rt_inverse, rt_pad, safe_norm, se3_compose,
                    se3_inverse, skew)
from .correct import correct_matches, get_virtual_points, virtual_grid
from .decompose import decompose_E, decompose_E_closed_form, recover_pose
from .epipolar import (
    E_F_from_Rt,
    E_to_F,
    F_to_E,
    compute_epi_residual,
    epi_distance,
    epipolar_constraint_matrix,
    hartley_normalize,
    norm_hw_matrix,
    normalize_hw,
    sampson_dist,
    sym_epi_dist,
)
from .lie import se3_exp, se3_log, so3_exp, so3_log
from .rotations import R_to_q, l2_error, q_to_R, qmul, rotation_angle_error, vector_angle

__all__ = [k for k in dir() if not k.startswith("_")]
