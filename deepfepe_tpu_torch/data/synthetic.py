"""Synthetic two-view correspondence generator (host-side numpy).

Counterpart of `deepfepe_tpu/data/synthetic.py`, a numpy copy of its
generator: KITTI-like forward motion with small rotations, 3D points in a
road-scene slab, pixel noise, uniform outliers on the second view and
SIFT-like quality scores. The same seed gives the same pairs as the JAX
package; the virtual points come from this package's
`get_virtual_points`.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry.correct import get_virtual_points


def _random_rotation(rng: np.random.RandomState, max_angle_deg: float):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(max_angle_deg) * rng.rand()
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _R_to_q_np(R: np.ndarray) -> np.ndarray:
    """w>=0 canonical unit quaternion (matches geometry.rotations.R_to_q)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[i + 1] = 0.25 * s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


class SyntheticPairs:
    """KITTI-like two-view sample stream.

    Forward-dominant motion with small rotations, 3D points in a road-scene
    slab, pixel noise and uniform outliers on the second view, SIFT-like
    quality scores anti-correlated with the injected error.
    """

    def __init__(
        self,
        image_size: Tuple[int, int] = (376, 1241),
        good_num: int = 1000,
        focal: float = 707.0,
        noise_px: float = 0.5,
        outlier_frac: float = 0.15,
        max_angle_deg: float = 3.0,
        t_scale: float = 1.0,
        virtual_iters: int = 8,
        seed: int = 0,
    ):
        self.image_size = image_size
        self.good_num = good_num
        self.noise_px = noise_px
        self.outlier_frac = outlier_frac
        self.max_angle_deg = max_angle_deg
        self.t_scale = t_scale
        self.virtual_iters = virtual_iters
        self.rng = np.random.RandomState(seed)
        H, W = image_size
        self.K = np.array(
            [[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]], np.float64
        )

    def _sample_pose(self):
        R = _random_rotation(self.rng, self.max_angle_deg)
        # Forward-dominant translation (KITTI-like), unit-ish scale.
        t = np.array(
            [
                self.rng.randn() * 0.1,
                self.rng.randn() * 0.05,
                -(0.5 + self.rng.rand()),
            ]
        )
        t = t / np.linalg.norm(t) * self.t_scale * (0.5 + self.rng.rand())
        return R, t

    def _sample_item(self) -> Dict[str, np.ndarray]:
        H, W = self.image_size
        K = self.K
        n = self.good_num
        R, t = self._sample_pose()

        # Rejection-sample 3D points visible in both views.
        x1 = np.zeros((n, 2))
        x2 = np.zeros((n, 2))
        got = 0
        while got < n:
            m = (n - got) * 3
            X1 = np.stack(
                [
                    self.rng.uniform(-20, 20, m),
                    self.rng.uniform(-5, 3, m),
                    self.rng.uniform(4, 60, m),
                ],
                axis=-1,
            )
            X2 = X1 @ R.T + t
            ok = (X1[:, 2] > 1) & (X2[:, 2] > 1)
            p1 = (X1 / X1[:, 2:3]) @ K.T
            p2 = (X2 / X2[:, 2:3]) @ K.T
            ok &= (
                (p1[:, 0] > 0) & (p1[:, 0] < W) & (p1[:, 1] > 0) & (p1[:, 1] < H)
                & (p2[:, 0] > 0) & (p2[:, 0] < W) & (p2[:, 1] > 0) & (p2[:, 1] < H)
            )
            take = min(n - got, int(ok.sum()))
            x1[got : got + take] = p1[ok][:take, :2]
            x2[got : got + take] = p2[ok][:take, :2]
            got += take

        err1 = self.rng.randn(n, 2) * self.noise_px
        err2 = self.rng.randn(n, 2) * self.noise_px
        x1n = x1 + err1
        x2n = x2 + err2
        n_out = int(self.outlier_frac * n)
        out_idx = self.rng.choice(n, n_out, replace=False)
        x2n[out_idx] = np.stack(
            [self.rng.uniform(0, W, n_out), self.rng.uniform(0, H, n_out)], -1
        )
        err_mag = np.linalg.norm(err1, axis=1) + np.linalg.norm(err2, axis=1)
        err_mag[out_idx] = 100.0
        quality = np.exp(-err_mag)[:, None]  # in (0, 1], SIFT-ratio-like

        tx = np.array(
            [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
        )
        E = tx @ R
        F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)

        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        T_inv = np.linalg.inv(T)
        q_cam = _R_to_q_np(T_inv[:3, :3])
        t_cam = T_inv[:3, 3]

        return {
            "matches_xy_ori": np.concatenate([x1n, x2n], -1).astype(np.float32),
            "quality": quality.astype(np.float32),
            "Ks": K.astype(np.float32),
            "K_invs": np.linalg.inv(K).astype(np.float32),
            "E_gts": E.astype(np.float32),
            "F_gts": (F / np.linalg.norm(F)).astype(np.float32),
            "q_cam": q_cam.astype(np.float32),
            "t_cam": t_cam.astype(np.float32),
            "delta_Rtijs_4_4": T.astype(np.float32),
            "matches_good_unique_nums": np.int32(n),
            "t_scene_scale": np.float32(np.linalg.norm(t)),
        }

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        items = [self._sample_item() for _ in range(batch_size)]
        out = {k: np.stack([it[k] for it in items]) for k in items[0]}
        # Virtual gt-consistent points, batched in torch on the CPU.
        p1v, p2v = get_virtual_points(torch.from_numpy(out["F_gts"]), self.image_size,
                                      iters=self.virtual_iters)
        out["pts1_virt"] = p1v.numpy().astype(np.float32)
        out["pts2_virt"] = p2v.numpy().astype(np.float32)
        return out

    def batches(self, batch_size: int, steps: int | None = None):
        """`steps` batches, or an endless stream when `steps` is None."""
        it = itertools.count() if steps is None else range(steps)
        for _ in it:
            yield self.batch(batch_size)
