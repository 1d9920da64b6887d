"""Synthetic odometry sequences: a whole trajectory of two-frame samples.

Counterpart of `deepfepe_tpu/data/synthetic_sequence.py`, a numpy copy:
one smooth forward-dominant trajectory and consecutive-pair correspondence
samples in the standard batch schema, so the whole VO stack (solver ->
recover_pose -> chaining -> KITTI metrics) runs with exact ground truth.
Its RandomState draws come in the JAX package's order, so the same seed
gives the same pairs; the virtual points come from this package's
`get_virtual_points`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..geometry.correct import get_virtual_points
from .synthetic import _R_to_q_np, _random_rotation


class SyntheticSequence:
    def __init__(self, n_frames: int = 30, image_size: Tuple[int, int] = (376, 1241),
                 focal: float = 707.0, good_num: int = 512, noise_px: float = 0.3,
                 outlier_frac: float = 0.1, step_length: float = 1.0,
                 max_angle_deg: float = 1.5, seed: int = 0):
        self.image_size = image_size
        self.good_num = good_num
        self.noise_px = noise_px
        self.outlier_frac = outlier_frac
        self.rng = np.random.RandomState(seed)
        H, W = image_size
        self.K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
        # Camera-to-world pose per frame, advancing along +z.
        cam2world = [np.eye(4)]
        for _ in range(n_frames - 1):
            R = _random_rotation(self.rng, max_angle_deg)
            t = np.array([self.rng.randn() * 0.03, self.rng.randn() * 0.02,
                          step_length * (0.9 + 0.2 * self.rng.rand())])
            step = np.eye(4)
            step[:3, :3], step[:3, 3] = R, t
            cam2world.append(cam2world[-1] @ step)
        self.cam2world = np.stack(cam2world)
        self.world2cam = np.linalg.inv(self.cam2world)
        self.n_frames = n_frames

    def gt_trajectory(self) -> np.ndarray:
        """[N, 4, 4] cam-to-world gt poses (the KITTI gt file convention)."""
        return self.cam2world

    def relative_pose(self, i: int, j: int) -> np.ndarray:
        """T_ij with x_j = T_ij x_i (frame-i coordinates into frame j)."""
        return self.world2cam[j] @ self.cam2world[i]

    def _pair_item(self, i: int, delta: int = 1) -> Dict[str, np.ndarray]:
        H, W = self.image_size
        K = self.K
        rel = self.relative_pose(i, i + delta)
        R, t = rel[:3, :3], rel[:3, 3]
        n = self.good_num
        x1, x2 = np.zeros((n, 2)), np.zeros((n, 2))
        got = 0
        while got < n:
            m = (n - got) * 4
            # Points in frame-i camera coordinates, in front of both cameras.
            X1 = np.stack([self.rng.uniform(-25, 25, m), self.rng.uniform(-6, 3, m),
                           self.rng.uniform(5, 60, m)], -1)
            X2 = X1 @ R.T + t
            ok = (X1[:, 2] > 1) & (X2[:, 2] > 1)
            p1 = (X1 / X1[:, 2:3]) @ K.T
            p2 = (X2 / X2[:, 2:3]) @ K.T
            ok &= ((p1[:, 0] > 0) & (p1[:, 0] < W) & (p1[:, 1] > 0) & (p1[:, 1] < H)
                   & (p2[:, 0] > 0) & (p2[:, 0] < W) & (p2[:, 1] > 0) & (p2[:, 1] < H))
            take = min(n - got, int(ok.sum()))
            x1[got:got + take] = p1[ok][:take, :2]
            x2[got:got + take] = p2[ok][:take, :2]
            got += take
        x1 += self.rng.randn(n, 2) * self.noise_px
        x2 += self.rng.randn(n, 2) * self.noise_px
        n_out = int(self.outlier_frac * n)
        if n_out:
            idx = self.rng.choice(n, n_out, replace=False)
            x2[idx] = np.stack([self.rng.uniform(0, W, n_out), self.rng.uniform(0, H, n_out)], -1)

        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
        rel_inv = np.linalg.inv(rel)
        return {
            "matches_xy_ori": np.concatenate([x1, x2], -1).astype(np.float32),
            "quality": np.ones((n, 1), np.float32),
            "Ks": K.astype(np.float32),
            "K_invs": np.linalg.inv(K).astype(np.float32),
            "E_gts": E.astype(np.float32),
            "F_gts": (F / np.linalg.norm(F)).astype(np.float32),
            "q_cam": _R_to_q_np(rel_inv[:3, :3]).astype(np.float32),
            "t_cam": rel_inv[:3, 3].astype(np.float32),
            "delta_Rtijs_4_4": rel.astype(np.float32),
            "matches_good_unique_nums": np.int32(n),
            "t_scene_scale": np.float32(np.linalg.norm(t)),
            "frame_i": np.int32(i),
        }

    def pair_batches(self, batch_size: int, delta: int = 1):
        """Frame-ordered (i, i + delta) pair batches over the whole sequence,
        the last one padded by repeating its final pair (`frame_i` tells the
        padding apart). All pairs are drawn before the first batch is
        yielded, as in the JAX package."""
        items: List[dict] = [self._pair_item(i, delta) for i in range(self.n_frames - delta)]
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            chunk += [chunk[-1]] * (batch_size - len(chunk))
            out = {k: np.stack([it[k] for it in chunk]) for k in chunk[0]}
            p1v, p2v = get_virtual_points(torch.from_numpy(out["F_gts"]), self.image_size,
                                          iters=8)
            out["pts1_virt"] = p1v.numpy().astype(np.float32)
            out["pts2_virt"] = p2v.numpy().astype(np.float32)
            yield out
