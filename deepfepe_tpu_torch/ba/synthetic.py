"""Synthetic SfM problems for the BA tests and benchmark.

Counterpart of `deepfepe_tpu/ba/synthetic.py`: a forward-motion keyframe
trajectory with windowed landmark visibility, the structure of a real
odometry or SfM run, at (C cameras, P landmarks). Every draw is numpy's, in
the JAX package's order, so both packages build the same problem from one
`RandomState`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.lie import se3_exp
from .bundle_adjustment import BAProblem


def make_sfm_problem(rng: np.random.RandomState, C: int = 100, P: int = 10_000,
                     window: int = 20, noise_px: float = 0.5, perturb: float = 0.1,
                     device=None):
    """Landmark p is seen by `window` consecutive cameras around its anchor
    frame (and only where it projects in front of the camera and inside a
    376x1240 image). Returns (float32 problem with perturbed poses and
    points on `device`, gt poses [C, 4, 4], gt points [P, 3], camera
    centres [C, 3]), the last three float64 numpy."""
    f = 718.0  # KITTI-like focal
    K = np.array([[f, 0, 620.0], [0, f, 188.0], [0, 0, 1.0]])
    poses = [np.eye(4)]
    for c in range(C - 1):  # forward motion and a gentle yaw
        yaw = 0.002 * np.sin(c / 7.0) + rng.randn() * 5e-4
        T = np.eye(4)
        T[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        T[:3, 3] = [rng.randn() * 0.01, rng.randn() * 0.005, -1.0 + rng.randn() * 0.02]
        poses.append(T @ poses[-1])
    poses = np.stack(poses)  # world -> camera
    cam_centers = -np.einsum("cij,ci->cj", poses[:, :3, :3].transpose(0, 2, 1), poses[:, :3, 3])

    # Landmarks in front of their anchor frame.
    anchor = rng.randint(0, C, P)
    Xc_anchor = np.stack([rng.uniform(-15, 15, P), rng.uniform(-3, 6, P),
                          rng.uniform(6, 40, P)], -1)
    Ra, ta = poses[anchor, :3, :3], poses[anchor, :3, 3]
    X = np.einsum("pij,pj->pi", Ra.transpose(0, 2, 1), Xc_anchor - ta)

    lo = np.clip(anchor - window // 2, 0, C - 1)
    cams = np.arange(C)[:, None]
    vis = ((cams >= lo[None, :]) & (cams < lo[None, :] + window)).astype(np.float64)
    Xc = np.einsum("cij,pj->cpi", poses[:, :3, :3], X) + poses[:, :3, 3][:, None, :]
    uv_h = np.einsum("ij,cpj->cpi", K, Xc)
    uv = uv_h[..., :2] / np.clip(uv_h[..., 2:3], 1e-6, None)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < 1240) & (uv[..., 1] >= 0) & (uv[..., 1] < 376))
    vis = vis * (Xc[..., 2] > 1.0) * in_img
    obs = uv + rng.randn(C, P, 2) * noise_px

    poses_init = poses.copy()
    for c in range(1, C):
        xi = torch.as_tensor(rng.randn(6) * perturb * 0.02)
        poses_init[c] = se3_exp(xi).numpy() @ poses_init[c]
    X_init = X + rng.randn(P, 3) * perturb

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    prob = BAProblem(poses=t(poses_init), points=t(X_init), obs=t(obs), vis=t(vis), K=t(K))
    return prob, poses, X, cam_centers
