"""Synthetic image pairs and sequences with exact geometry (host-side numpy).

Counterpart of `SyntheticImagePairs` and `SyntheticImageSequence` in
`deepfepe_tpu/data/synthetic_images.py`, a numpy copy of its generators:
blob-textured scenes of fronto-parallel planes at different depths (one
plane alone is degenerate for F), seen from two poses. Each plane induces
an exact homography H_i = K (R + t n^T / d_i) K^-1, so the pair is
photometrically consistent with the ground-truth (R, t) and E = [t]x R
holds for every rendered point. The same seed gives the same images and
poses as the JAX package; the virtual points come from this package's
`get_virtual_points`.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry.correct import get_virtual_points
from .synthetic import _R_to_q_np, _random_rotation


def _render_texture(rng, H, W, n_blobs=60, n_corners=0):
    """Random gaussian-blob texture in [0, 1]; `n_corners` adds hard-edged
    rotated rectangles, whose corners a corner detector fires on."""
    img = np.zeros((H, W))

    def window(cx, cy, r):
        """The pixel grid of a feature's support window around (cx, cy)."""
        x0, x1 = max(0, int(cx - r)), min(W, int(cx + r) + 1)
        y0, y1 = max(0, int(cy - r)), min(H, int(cy + r) + 1)
        if x0 >= x1 or y0 >= y1:
            return None
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
        return (slice(y0, y1), slice(x0, x1)), yy, xx

    for _ in range(n_blobs):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        s = rng.uniform(1.5, 6.0)
        a = rng.uniform(-1.0, 1.0)
        win = window(cx, cy, 3.5 * s)
        if win is None:
            continue
        sl, yy, xx = win
        img[sl] += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    for _ in range(n_corners):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        w2, h2 = rng.uniform(2.0, 7.0), rng.uniform(2.0, 7.0)
        th = rng.uniform(0, np.pi)
        a = rng.uniform(0.4, 1.0) * rng.choice([-1.0, 1.0])
        win = window(cx, cy, float(np.hypot(w2, h2)) + 1.0)
        if win is None:
            continue
        sl, yy, xx = win
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        img[sl] += a * ((np.abs(u) < w2) & (np.abs(v) < h2))
    img -= img.min()
    img /= img.max() + 1e-9
    return img


def _warp_bilinear(img, Hmat, H, W):
    """out(x) = img(Hmat @ x), bilinear, zero outside the image."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(H * W)])
    w = Hmat @ pts
    u = w[0] / w[2]
    v = w[1] / w[2]
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = u - x0
    fy = v - y0

    def at(ys, xs):
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        vals = np.zeros(len(xs))
        vals[ok] = img[ys[ok], xs[ok]]
        return vals

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
           + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    return out.reshape(H, W)


class SyntheticImagePairs:
    """Image-pair stream with ground-truth geometry."""

    def __init__(self, image_size: Tuple[int, int] = (120, 160), focal: float = 140.0,
                 depths: Tuple[float, ...] = (6.0, 12.0), max_angle_deg: float = 2.0,
                 t_scale: float = 0.15, depth_jitter: float = 0.0, n_blobs: int = 60,
                 n_corners: int = 0, virtual_iters: int = 8, seed: int = 0):
        """`depths` may hold any number of planes (vertical strips of image
        1, near to far from left to right); `depth_jitter` scales each
        plane's depth by U[1 - j, 1 + j] per item."""
        self.image_size = image_size
        self.depths = depths
        self.max_angle_deg = max_angle_deg
        self.t_scale = t_scale
        self.depth_jitter = depth_jitter
        self.n_blobs = n_blobs
        self.n_corners = n_corners
        self.virtual_iters = virtual_iters
        self.rng = np.random.RandomState(seed)
        H, W = image_size
        self.K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])

    def plane_homography(self, R, t, d):
        """H mapping image-1 pixels to image-2 pixels for the plane z = d."""
        n = np.array([0.0, 0.0, 1.0])
        H = self.K @ (R + np.outer(t, n) / d) @ np.linalg.inv(self.K)
        return H / H[2, 2]

    def _sample_item(self) -> Dict[str, np.ndarray]:
        H, W = self.image_size
        rng = self.rng
        R = _random_rotation(rng, self.max_angle_deg)
        t = rng.randn(3) * np.array([1.0, 0.5, 1.5])
        t = t / np.linalg.norm(t) * self.t_scale

        img1 = np.zeros((H, W))
        img2 = np.zeros((H, W))
        nd = len(self.depths)
        bounds = [W * k // nd for k in range(nd + 1)]
        j = self.depth_jitter
        for idx, d in enumerate(self.depths):
            if j > 0:
                d = d * rng.uniform(1.0 - j, 1.0 + j)
            tex = _render_texture(rng, H, W, n_blobs=self.n_blobs, n_corners=self.n_corners)
            Hm = self.plane_homography(R, t, d)
            region1 = np.zeros((H, W))
            region1[:, bounds[idx]:bounds[idx + 1]] = 1.0
            img1 += tex * region1
            img2 += _warp_bilinear(tex * region1, np.linalg.inv(Hm), H, W)

        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        K = self.K
        F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        T_inv = np.linalg.inv(T)
        return {
            "imgs_grey": np.stack([img1, img2]).astype(np.float32),
            "Ks": K.astype(np.float32),
            "K_invs": np.linalg.inv(K).astype(np.float32),
            "E_gts": E.astype(np.float32),
            "F_gts": (F / np.linalg.norm(F)).astype(np.float32),
            "q_cam": _R_to_q_np(T_inv[:3, :3]).astype(np.float32),
            "t_cam": T_inv[:3, 3].astype(np.float32),
            "delta_Rtijs_4_4": T.astype(np.float32),
            "t_scene_scale": np.float32(np.linalg.norm(t)),
        }

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        items = [self._sample_item() for _ in range(batch_size)]
        out = {k: np.stack([it[k] for it in items]) for k in items[0]}
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


class SyntheticImageSequence:
    """One persistent two-plane scene seen along a smooth, forward-dominant
    trajectory: every frame warps the same frame-0 textures, so consecutive
    frames are consistent with the chained ground-truth poses and features
    track across the sequence. The input the dump tooling expects, rendered
    from exact geometry at any size; the same seed gives the JAX package's
    frames and poses."""

    def __init__(self, n_frames: int = 60, image_size: Tuple[int, int] = (240, 320),
                 focal: float = 280.0, depths: Tuple[float, float] = (12.0, 24.0),
                 step_length: float = 0.12, max_angle_deg: float = 0.6, n_blobs: int = 240,
                 n_corners: int = 0, seed: int = 0):
        self.n_frames = n_frames
        self.image_size = image_size
        self.depths = depths
        rng = np.random.RandomState(seed)
        H, W = image_size
        self.K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
        # Frame-0 appearance: the left half the near plane, the right half the far one.
        split = W // 2
        self.layers = []
        for idx, d in enumerate(depths):
            tex = _render_texture(rng, H, W, n_blobs=n_blobs, n_corners=n_corners)
            region = np.zeros((H, W))
            if idx == 0:
                region[:, :split] = 1.0
            else:
                region[:, split:] = 1.0
            self.layers.append((tex * region, d))
        # x_k = R_step x_{k-1} + t_step, accumulated into T_0k (frame 0 -> k).
        T_0k = np.eye(4)
        self.T_0k_list = [T_0k.copy()]
        for _ in range(n_frames - 1):
            R = _random_rotation(rng, max_angle_deg)
            t = np.array([rng.randn() * 0.02, rng.randn() * 0.015,
                          step_length * (0.9 + 0.2 * rng.rand())])
            step = np.eye(4)
            step[:3, :3], step[:3, 3] = R, t
            T_0k = step @ T_0k
            self.T_0k_list.append(T_0k.copy())
        total_z = self.T_0k_list[-1][2, 3]
        if total_z > 0.7 * min(depths):
            raise ValueError(f"trajectory advances {total_z:.2f} toward a plane at depth "
                             f"{min(depths)}; reduce n_frames or step_length")

    def frame(self, k: int) -> np.ndarray:
        """Frame k in [0, 1]: each plane layer warped by the homography
        H_0k = K (R + t n^T / d) K^-1 of T_0k."""
        H, W = self.image_size
        T = self.T_0k_list[k]
        R, t = T[:3, :3], T[:3, 3]
        img = np.zeros((H, W))
        n = np.array([0.0, 0.0, 1.0])
        for layer, d in self.layers:
            Hm = self.K @ (R + np.outer(t, n) / d) @ np.linalg.inv(self.K)
            img += _warp_bilinear(layer, np.linalg.inv(Hm), H, W)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def frames(self) -> np.ndarray:
        return np.stack([self.frame(k) for k in range(self.n_frames)])

    def cam2world_poses(self) -> np.ndarray:
        """[N, 3, 4] camera-to-world poses (world = frame 0's camera), the
        `poses.npy` convention of a dump."""
        return np.stack([np.linalg.inv(T)[:3] for T in self.T_0k_list])

    def gt_trajectory(self) -> np.ndarray:
        """[N, 4, 4] camera-to-world poses (the KITTI gt file convention)."""
        out = np.tile(np.eye(4), (self.n_frames, 1, 1))
        out[:, :3] = self.cam2world_poses()
        return out

    def _pair_item(self, i: int, delta: int = 1) -> Dict[str, np.ndarray]:
        """Frames (i, i + delta) with their exact geometry."""
        Tij = self.T_0k_list[i + delta] @ np.linalg.inv(self.T_0k_list[i])
        R, t = Tij[:3, :3], Tij[:3, 3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        K = self.K
        F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
        T_inv = np.linalg.inv(Tij)
        return {
            "imgs_grey": np.stack([self.frame(i), self.frame(i + delta)]).astype(np.float32),
            "Ks": K.astype(np.float32),
            "K_invs": np.linalg.inv(K).astype(np.float32),
            "E_gts": E.astype(np.float32),
            "F_gts": (F / np.linalg.norm(F)).astype(np.float32),
            "q_cam": _R_to_q_np(T_inv[:3, :3]).astype(np.float32),
            "t_cam": T_inv[:3, 3].astype(np.float32),
            "delta_Rtijs_4_4": Tij.astype(np.float32),
            "t_scene_scale": np.float32(np.linalg.norm(t)),
            "frame_i": np.int32(i),
        }

    def pair_batches(self, batch_size: int, delta: int = 1):
        """Frame-ordered (i, i + delta) pair batches over the sequence; the
        last batch is padded by repeating its final pair."""
        items = [self._pair_item(i, delta) for i in range(self.n_frames - delta)]
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            while len(chunk) < batch_size:
                chunk.append(chunk[-1])
            out = {k: np.stack([it[k] for it in chunk]) for k in chunk[0]}
            p1v, p2v = get_virtual_points(torch.from_numpy(out["F_gts"]), self.image_size,
                                          iters=8)
            out["pts1_virt"] = p1v.numpy().astype(np.float32)
            out["pts2_virt"] = p2v.numpy().astype(np.float32)
            yield out
