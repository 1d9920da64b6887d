"""SuperPoint training: synthetic-shapes detector supervision, the
descriptor loss over warped pairs, and homographic adaptation.

Counterpart of `deepfepe_tpu/frontend/train_sp.py` (the external
pytorch-superpoint's `Train_model_frontend`, which the reference depends
on): render synthetic shapes with exactly known corners, supervise the
65-way cell classifier, and train the descriptors on homography-warped
pairs.

- Data (host numpy, copied from the JAX package with its RandomState draw
  order, so the same seeds give the same arrays): `SyntheticShapes`,
  `CornerTextures`, `sample_homography`, `warp_labels`; `heatmap_to_cells`
  turns an aggregated heatmap into pseudo-labels.
- Losses: `detector_loss` (65-way cross entropy a cell), `descriptor_loss`
  (dense hinge over the [B, N, N] cell pairs, or `hard_neg` mining).
- Steps: `make_detector_train_step`, `make_detector_train_step_bn`,
  `make_joint_sp_train_step`, `make_warped_joint_train_step` each return
  `step(batch)`, which runs the net's module forward (never the fused conv
  route, as the JAX steps call `net.apply`), takes one Adam update and
  returns the JAX step's loss or its {'loss', 'det', 'desc'} metrics as
  0-d tensors. A batch holds numpy arrays or tensors; they go to the net's
  device. The forward and backward run under `ops.conv.step_convs`, as
  the joint train step's: a float32 net under `exact_convs` (no TF32, no
  oneDNN, and on the card no cuDNN, whose float32 weight gradient takes
  Winograd). The optimizer is `torch.optim.Adam` with optax's defaults
  (`adam`). BatchNorm buffers take no gradient in torch, so the JAX
  package's `freeze_batch_stats_grads` has no counterpart: the steps other
  than `make_detector_train_step_bn` run a gauss2 net in eval mode and
  leave its buffers alone.
- `homographic_adaptation`: the detector heatmap averaged over K warped
  views, each view's vote masked where it fell outside the warped frame,
  its forwards under `step_convs` as the steps'.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.conv import step_convs
from ..utils.warp import transform_image
from .process import nms_heatmap
from .superpoint import flatten_detection

# ---------------------------------------------------------------------------
# Synthetic-shapes data (host-side numpy): images and exact corner labels.
# ---------------------------------------------------------------------------


class SyntheticShapes:
    """Random polygons / line junctions with known corner keypoints."""

    def __init__(self, image_size: Tuple[int, int] = (120, 160), seed: int = 0):
        self.H, self.W = image_size
        self.rng = np.random.RandomState(seed)

    def _draw_line(self, img, p0, p1, value):
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2 + 1)
        xs = np.linspace(p0[0], p1[0], n)
        ys = np.linspace(p0[1], p1[1], n)
        for x, y in zip(xs, ys):
            xi, yi = int(round(x)), int(round(y))
            if 0 <= xi < self.W and 0 <= yi < self.H:
                img[max(yi - 1, 0): yi + 1, max(xi - 1, 0): xi + 1] = value

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (image [H, W] in [0, 1], corners [K, 2] xy)."""
        rng = self.rng
        img = np.full((self.H, self.W), rng.uniform(0.0, 0.3))
        corners = []
        for _ in range(rng.randint(2, 6)):
            # A random polygon with 3-6 vertices.
            n_v = rng.randint(3, 7)
            cx, cy = rng.uniform(20, self.W - 20), rng.uniform(15, self.H - 15)
            radius = rng.uniform(8, 30)
            angles = np.sort(rng.uniform(0, 2 * np.pi, n_v))
            pts = np.stack([cx + radius * np.cos(angles), cy + radius * np.sin(angles)], -1)
            val = rng.uniform(0.4, 1.0)
            for i in range(n_v):
                self._draw_line(img, pts[i], pts[(i + 1) % n_v], val)
            for p in pts:
                if 4 <= p[0] < self.W - 4 and 4 <= p[1] < self.H - 4:
                    corners.append(p)
        img += rng.randn(self.H, self.W) * 0.03  # sensor noise
        img = np.clip(img, 0, 1)
        return img.astype(np.float32), np.array(corners, np.float32).reshape(-1, 2)

    def batch(self, batch_size: int, max_pts: int = 64) -> Dict[str, np.ndarray]:
        imgs, labels = [], []
        for _ in range(batch_size):
            img, c = self.sample()
            imgs.append(img)
            labels.append(self.corners_to_cells(c))
        return {"image": np.stack(imgs), "cells": np.stack(labels)}  # cells [B, H/8, W/8] in [0, 64]

    def corners_to_cells(self, corners: np.ndarray) -> np.ndarray:
        """Corner pixels -> 65-way cell labels (64 positions + dustbin = 64)."""
        Hc, Wc = self.H // 8, self.W // 8
        lab = np.full((Hc, Wc), 64, np.int32)  # dustbin
        for x, y in corners:
            cx, cy = int(x) // 8, int(y) // 8
            if 0 <= cx < Wc and 0 <= cy < Hc:
                lab[cy, cx] = (int(y) % 8) * 8 + (int(x) % 8)
        return lab

    def pool(self, n: int):
        """Pre-render n (image, corners) samples for reuse across epochs."""
        return [self.sample() for _ in range(n)]


class CornerTextures(SyntheticShapes):
    """Exactly labeled samples in the joint-training texture style: gaussian
    blobs (unlabeled background) and hard-edged rotated rectangle stamps
    whose 4 corners are the keypoint labels (the texture family of
    `data/synthetic_images._render_texture(n_corners=...)`)."""

    def __init__(self, image_size=(120, 160), n_blobs=40, n_rects=14, seed: int = 0):
        super().__init__(image_size=image_size, seed=seed)
        self.n_blobs = n_blobs
        self.n_rects = n_rects

    def sample(self):
        rng = self.rng
        H, W = self.H, self.W
        img = np.zeros((H, W))
        yy0, xx0 = np.mgrid[0:H, 0:W].astype(np.float64)
        for _ in range(self.n_blobs):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            s = rng.uniform(1.5, 6.0)
            a = rng.uniform(-1.0, 1.0)
            r = int(np.ceil(3.5 * s))
            x0, x1 = max(0, int(cx - r)), min(W, int(cx + r) + 1)
            y0, y1 = max(0, int(cy - r)), min(H, int(cy + r) + 1)
            if x0 >= x1 or y0 >= y1:
                continue
            yy, xx = yy0[y0:y1, x0:x1], xx0[y0:y1, x0:x1]
            img[y0:y1, x0:x1] += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
        corners = []
        for _ in range(self.n_rects):
            cx, cy = rng.uniform(6, W - 6), rng.uniform(6, H - 6)
            w2, h2 = rng.uniform(2.0, 7.0), rng.uniform(2.0, 7.0)
            th = rng.uniform(0, np.pi)
            a = rng.uniform(0.4, 1.0) * rng.choice([-1.0, 1.0])
            ct, st = np.cos(th), np.sin(th)
            u = (xx0 - cx) * ct + (yy0 - cy) * st
            v = -(xx0 - cx) * st + (yy0 - cy) * ct
            img += a * ((np.abs(u) < w2) & (np.abs(v) < h2))
            for su, sv in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                # The rectangle's corner in image coordinates: c + R(th)^T (+-w2, +-h2).
                px = cx + su * w2 * ct - sv * h2 * st
                py = cy + su * w2 * st + sv * h2 * ct
                if 0 <= px < W and 0 <= py < H:
                    corners.append((px, py))
        img -= img.min()
        img /= img.max() + 1e-9
        return img.astype(np.float32), np.asarray(corners if corners else np.zeros((0, 2)),
                                                  np.float64)


def sample_homography(rng: np.random.RandomState, image_size: Tuple[int, int],
                      max_angle: float = 0.35, scale_range: Tuple[float, float] = (0.85, 1.2),
                      max_translation: float = 0.08, max_perspective: float = 6e-4) -> np.ndarray:
    """A random pixel homography img1 -> img2 about the image centre
    (rotation x scale x translation x mild perspective): [3, 3] float32."""
    Hh, Ww = image_size
    cx, cy = Ww / 2.0, Hh / 2.0
    to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    a = rng.uniform(-max_angle, max_angle)
    s = rng.uniform(*scale_range)
    ca, sa = np.cos(a), np.sin(a)
    rs = np.array([[s * ca, -s * sa, 0], [s * sa, s * ca, 0], [0, 0, 1]])
    tx = rng.uniform(-max_translation, max_translation) * Ww
    ty = rng.uniform(-max_translation, max_translation) * Hh
    tr = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
    p1, p2 = rng.uniform(-max_perspective, max_perspective, 2)
    pe = np.array([[1, 0, 0], [0, 1, 0], [p1, p2, 1]], np.float64)
    M = np.linalg.inv(to_c) @ tr @ pe @ rs @ to_c
    return (M / M[2, 2]).astype(np.float32)


def warp_labels(corners: np.ndarray, H_mat: np.ndarray,
                image_size: Tuple[int, int]) -> np.ndarray:
    """Keypoint labels warped by a homography, out-of-bounds points dropped
    (the reference's datasets/data_tools.warpLabels :37)."""
    Hh, Ww = image_size
    if len(corners) == 0:
        return corners
    pts_h = np.concatenate([corners, np.ones((len(corners), 1))], axis=1)
    w = pts_h @ H_mat.T
    w = w[:, :2] / (w[:, 2:3] + 1e-12)
    ok = (w[:, 0] >= 0) & (w[:, 0] < Ww) & (w[:, 1] >= 0) & (w[:, 1] < Hh)
    return w[ok].astype(np.float32)


def heatmap_to_cells(heatmap: np.ndarray, conf_thresh: float = 0.015,
                     nms_dist: int = 4) -> np.ndarray:
    """An aggregated heatmap [H, W] -> 65-way cell labels [H/8, W/8] (the
    pseudo-labels of homographic adaptation): NMS (`process.nms_heatmap`),
    the threshold, then the strongest keypoint of each 8x8 cell; empty
    cells get the dustbin."""
    hm = nms_heatmap(torch.from_numpy(np.array(heatmap))[None], nms_dist)[0].numpy()
    Hh, Ww = hm.shape
    Hc, Wc = Hh // 8, Ww // 8
    lab = np.full((Hc, Wc), 64, np.int32)
    best = np.zeros((Hc, Wc), np.float32)
    ys, xs = np.nonzero(hm > conf_thresh)
    for y, x in zip(ys, xs):
        cy, cx = y // 8, x // 8
        if cy < Hc and cx < Wc and hm[y, x] > best[cy, cx]:
            best[cy, cx] = hm[y, x]
            lab[cy, cx] = (y % 8) * 8 + (x % 8)
    return lab


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def detector_loss(semi: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """65-way cross entropy a cell (the SuperPoint detector loss):
    semi [B, Hc, Wc, 65], cells [B, Hc, Wc] integer labels."""
    logp = torch.log_softmax(semi, dim=-1)
    return -logp.gather(-1, cells.long()[..., None]).mean()


def correspondence(H_mat: torch.Tensor, Hc: int, Wc: int, cell: int = 8) -> torch.Tensor:
    """[B, N, N] cell correspondence, N = Hc Wc: 1 where H_mat [B, 3, 3]
    maps cell i's centre within half a cell of cell j's centre. Computed in
    float64 whatever the descriptors' dtype (the JAX package's is in
    theirs): d2 <= (cell / 2)^2 is an exact boundary test, and float64
    keeps a centre near it on one side on every device."""
    dt = torch.float64
    ys, xs = torch.meshgrid(torch.arange(Hc, dtype=dt, device=H_mat.device),
                            torch.arange(Wc, dtype=dt, device=H_mat.device), indexing="ij")
    centers = torch.stack([xs * cell + cell / 2, ys * cell + cell / 2, torch.ones_like(xs)],
                          -1).reshape(-1, 3)
    warped = torch.einsum("bij,nj->bni", H_mat.to(dt), centers)
    warped = warped[..., :2] / (warped[..., 2:3] + 1e-9)
    d2 = ((warped[:, :, None, :] - centers[None, None, :, :2]) ** 2).sum(-1)
    return d2 <= (cell / 2.0) ** 2


def _hinge(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with jnp.maximum's gradient, 1/2 at x = 0 (torch's clamp
    passes 1 there): a positive whose two descriptors are equal sits on
    that tie. The value is max(0, x) exactly."""
    return 0.5 * (x + x.abs())


def descriptor_loss(desc1: torch.Tensor, desc2: torch.Tensor, H_mat: torch.Tensor,
                    pos_margin: float = 1.0, neg_margin: float = 0.2, lambda_d: float = 250.0,
                    cell: int = 8, hard_neg: int = 0) -> torch.Tensor:
    """The dense hinge descriptor loss of a warped pair (SuperPoint eq. 4):
    desc [B, Hc, Wc, D], H_mat [B, 3, 3] the pixel homography img1 -> img2;
    cells that correspond under H are positives (`correspondence`).

    `hard_neg` > 0 replaces the dense negative mean by the mean over each
    anchor cell's `hard_neg` hardest negatives, mined along both matching
    directions, and divides the positive term by the number of positives,
    as the JAX package does (its per-positive normalization, ROADMAP Queue
    3); 0 is the dense form."""
    B, Hc, Wc, D = desc1.shape
    s = correspondence(H_mat, Hc, Wc, cell).to(desc1.dtype)
    dot = torch.einsum("bnd,bmd->bnm", desc1.reshape(B, -1, D), desc2.reshape(B, -1, D))
    pos = _hinge(pos_margin - dot)
    neg = _hinge(dot - neg_margin)
    if hard_neg <= 0:
        return (lambda_d * s * pos + (1.0 - s) * neg).mean()
    k = min(int(hard_neg), s.shape[-1])
    neg_masked = torch.where(s > 0, torch.full_like(neg, float("-inf")), neg)
    row_top = torch.topk(neg_masked, k, dim=-1).values
    col_top = torch.topk(neg_masked.transpose(-1, -2), k, dim=-1).values
    hard = torch.cat([row_top, col_top], dim=-1)
    hard = torch.where(torch.isfinite(hard), hard, torch.zeros_like(hard))  # all-positive rows
    pos_term = (lambda_d * s * pos).sum() / (s.sum() + 1e-9)
    return pos_term + hard.mean()


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def adam(net: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 (`train/engine.
    make_optimizer`'s convention)."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _device_batch(net: torch.nn.Module, batch) -> Dict[str, torch.Tensor]:
    p = next(net.parameters())
    return {k: torch.as_tensor(v, device=p.device,
                               dtype=p.dtype if k in ("image", "image2", "H") else None)
            for k, v in batch.items()}


def _images(x: torch.Tensor) -> torch.Tensor:
    return x[..., None].contiguous()


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One Adam update. A parameter the loss does not reach (the descriptor
    head under the detector loss) takes a zero gradient, not none: optax
    steps every leaf, so its moments decay and its step count advances with
    the others', which sets its bias correction once it is trained."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def make_detector_train_step(net: torch.nn.Module, opt: torch.optim.Optimizer):
    """step(batch {'image' [B, H, W], 'cells' [B, Hc, Wc]}) -> the detector
    cross entropy, after one update."""
    def step(batch):
        b = _device_batch(net, batch)
        with step_convs(net):
            loss = detector_loss(net(_images(b["image"]))["semi"], b["cells"])
            _update(opt, loss)
        return loss.detach()

    return step


def make_detector_train_step_bn(net: torch.nn.Module, opt: torch.optim.Optimizer):
    """The detector step of a BatchNorm net (SuperPointNetGauss2): the
    forward runs BatchNorm on the batch's statistics (train mode), and the
    running buffers take its one momentum update, as the JAX step threads
    them through; the net's mode is restored after."""
    def step(batch):
        b = _device_batch(net, batch)
        was_training = net.training
        net.train()
        try:
            with step_convs(net):
                loss = detector_loss(net(_images(b["image"]))["semi"], b["cells"])
                _update(opt, loss)
        finally:
            net.train(was_training)
        return loss.detach()

    return step


def _joint_losses(net, img1, img2, b, desc_weight, hard_neg, cells2):
    """Both views through one [2B] module forward (BatchNorm, if any, on its
    running statistics: the same as two passes)."""
    B = img1.shape[0]
    outs = net(_images(torch.cat([img1, img2], dim=0)))
    semi1, semi2 = outs["semi"][:B], outs["semi"][B:]
    l_det = detector_loss(semi1, b["cells"])
    if cells2:
        l_det = l_det + detector_loss(semi2, b["cells2"])
    l_desc = descriptor_loss(outs["desc"][:B], outs["desc"][B:], b["H"], hard_neg=hard_neg)
    return l_det + desc_weight * l_desc, l_det, l_desc


def make_joint_sp_train_step(net: torch.nn.Module, opt: torch.optim.Optimizer,
                             desc_weight: float = 1e-4, hard_neg: int = 0):
    """step(batch {'image', 'image2', 'cells', 'H'}) -> {'loss', 'det',
    'desc'}: the detector CE on image 1 and the descriptor loss across the
    pair, after one update."""
    def step(batch):
        b = _device_batch(net, batch)
        with step_convs(net):
            loss, l_det, l_desc = _joint_losses(net, b["image"], b["image2"], b, desc_weight,
                                                hard_neg, cells2=False)
            _update(opt, loss)
        return {"loss": loss.detach(), "det": l_det.detach(), "desc": l_desc.detach()}

    return step


def warp_second_view(images: torch.Tensor, H_mat: torch.Tensor) -> torch.Tensor:
    """The second view of each item, img2(x) = img1(H^-1 x), on the images'
    device: images [B, H, W], H_mat [B, 3, 3] img1 -> img2."""
    with torch.no_grad():
        return transform_image(images[..., None], torch.linalg.inv(H_mat))[..., 0]


def make_warped_joint_train_step(net: torch.nn.Module, opt: torch.optim.Optimizer,
                                 desc_weight: float = 1e-4, hard_neg: int = 0):
    """The joint detector + descriptor step whose second view is warped
    inside the step, on the net's device (`warp_second_view`).

    batch: {'image' [B, H, W], 'cells' [B, Hc, Wc], 'cells2' [B, Hc, Wc],
    'H' [B, 3, 3] pixel homography img1 -> img2}; returns {'loss', 'det',
    'desc'}, the detector term the sum over both views."""
    def step(batch):
        b = _device_batch(net, batch)
        img2 = warp_second_view(b["image"], b["H"])
        with step_convs(net):
            loss, l_det, l_desc = _joint_losses(net, b["image"], img2, b, desc_weight, hard_neg,
                                                cells2=True)
            _update(opt, loss)
        return {"loss": loss.detach(), "det": l_det.detach(), "desc": l_desc.detach()}

    return step


# ---------------------------------------------------------------------------
# Homographic adaptation
# ---------------------------------------------------------------------------


def homographic_adaptation(net: torch.nn.Module, images: torch.Tensor,
                           H_mats: torch.Tensor) -> torch.Tensor:
    """The detector heatmap aggregated over K homographic views (the
    SuperPoint label refinement that makes pseudo-ground-truth keypoints on
    unlabeled images): images [B, H, W] grey in [0, 1], H_mats [K, 3, 3]
    (image -> view). For each view: warp the images, run the detector
    (module forward), warp the heatmap back and add it where the view's
    frame, warped back, is above 0.5; the mean over the votes, [B, H, W]."""
    B, Hh, Ww = images.shape
    H_mats = torch.as_tensor(H_mats, dtype=images.dtype, device=images.device)
    ones = torch.ones((Hh, Ww, 1), dtype=images.dtype, device=images.device)
    acc = torch.zeros_like(images)
    cnt = torch.zeros_like(images)
    with torch.no_grad(), step_convs(net):
        for H_k in H_mats:
            H_inv = torch.linalg.inv(H_k)
            # warped(x) = image(H_k^-1 x): points map by H_k.
            warped = transform_image(images[..., None], H_inv)
            valid_w = transform_image(ones, H_inv)[..., 0]
            heat = flatten_detection(net(warped)["semi"])
            # Back to the image's frame: heat0(x) = heat(H_k x).
            heat0 = transform_image(heat[..., None], H_k)[..., 0]
            valid0 = transform_image(valid_w[..., None], H_k)[..., 0]
            mask = (valid0 > 0.5).to(heat0.dtype)
            acc = acc + heat0 * mask
            cnt = cnt + mask
    return acc / torch.clamp(cnt, min=1.0)
