"""Evaluation: the RANSAC baselines (8-point F, five-point E), per-pair pose
validation, metric summaries, the frontend's epipolar-distance evaluation,
the single-sample qualitative pipeline (`ValPipelineFrontend`), and visual
odometry (chaining, the KITTI and TUM trajectory metrics, result tables)."""

from .frontend_eval import frontend_epidist_eval
from .kitti_odometry import (align_trajectory, calc_sequence_errors, compute_ate, compute_rpe,
                             evaluate_sequence, load_poses_txt, umeyama_alignment)
from .opencv_baseline import recover_camera_opencv
from .ransac import (RansacResult, draw_hypotheses, ransac_e, ransac_e_batch, ransac_f,
                     ransac_f_batch)
from .val_pipeline import ValPipelineFrontend, load_params_msgpack
from .val_rt import inlier_ratios, val_rt_batch
from .vo import (chain_relative_poses, compensate_poses, compute_pose_error, export_poses_kitti,
                 pose_seq_ate, relative_pose_cam_to_body)

__all__ = [k for k in dir() if not k.startswith("_")]
