"""Bundle adjustment and pose-graph fusion: the Schur and square-root BA
steps, synthetic SfM problems, and the SE(3) pose graph (dense and CG)."""

from .bundle_adjustment import (BAProblem, ba_step, build_normal_blocks, optimize_ba, project,
                                reprojection_residuals, schur_reduce)
from .pose_graph import (PoseGraph, edge_residuals, gauss_newton_step, gauss_newton_step_cg,
                         graph_from_odometry, optimize_pose_graph, optimize_pose_graph_two_stage)
from .sqrt_ba import optimize_sqrt_ba, sqrt_ba_step
from .synthetic import make_sfm_problem

__all__ = [k for k in dir() if not k.startswith("_")]
