"""Frontend-quality evaluation: epipolar distance of the matches under the
ground-truth F, and the detector and descriptor metrics under a known
homography.

Counterpart of `deepfepe_tpu/eval/frontend_eval.py`:

- `frontend_epidist_eval` (the reference's evaluation_epiDist
  val_feature): run the frontend on both frames, match, and score each
  match by the sum of its two one-sided epipolar distances under F_gt, with
  optional Gaussian noise on the match positions;
- the homography half (the reference's evaluate_frontend metric surface,
  evaluate_frontend.py:26-276): `compute_repeatability`,
  `homography_correctness`, `average_precision`, `matching_score_and_map`
  and `evaluate_homography_pair`, numpy around the port's SuperPoint and
  matcher. The warped view is rendered by `utils.warp.warp_perspective`,
  the numpy copy of the `cv2.warpPerspective` the JAX package calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..frontend import FrontendParams, get_matches_from_sp
from ..frontend.matching import gather_matches, mutual_nn_match
from ..frontend.pipeline import run_superpoint
from ..geometry.epipolar import epi_distance
from ..utils.warp import warp_perspective

THRESHOLDS = (0.1, 0.5, 1.0, 2.0)


def frontend_epidist_eval(net, imgs_grey: Tuple[torch.Tensor, torch.Tensor], F_gt: torch.Tensor,
                          fp: FrontendParams, noise_std: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          thresholds=THRESHOLDS) -> Dict[str, np.ndarray]:
    """{'epi_dists' [B, N] (NaN where no match), 'num_matches' [B],
    'ratio@<t>' [B]: the share of a pair's matches within t pixels}.
    Noise (when `noise_std` > 0 and a CPU `generator` is given) is drawn
    on the CPU and moved to the matches' device."""
    with torch.no_grad():
        out = get_matches_from_sp(net, imgs_grey, fp)
        matches = out["matches_xy_ori"]
        if noise_std > 0.0 and generator is not None:
            noise = torch.randn(matches.shape, generator=generator, dtype=matches.dtype)
            matches = matches + noise_std * noise.to(matches.device)
        _, d1, d2 = epi_distance(F_gt, matches[..., :2], matches[..., 2:4], if_homo=False)
        d = d1 + d2
        valid = out["valid"]
        nv = valid.sum(-1)
        res = {"epi_dists": torch.where(valid, d, torch.full_like(d, float("nan"))),
               "num_matches": nv}
        for t in thresholds:
            res[f"ratio@{t}"] = ((d < t) & valid).sum(-1) / torch.clamp(nv, min=1)
    return {k: v.cpu().numpy() for k, v in res.items()}


def warp_keypoints(kpts_xy: np.ndarray, H: np.ndarray) -> np.ndarray:
    """A homography applied to [N, 2] points (the reference's
    detector_evaluation.warp_keypoints :136)."""
    h = np.concatenate([kpts_xy, np.ones((len(kpts_xy), 1))], axis=1)
    w = h @ H.T
    return w[:, :2] / w[:, 2:3]


def compute_repeatability(kpts1: np.ndarray, kpts2: np.ndarray, H: np.ndarray,
                          image_shape: Tuple[int, int],
                          distance_thresh: float = 3.0) -> Dict[str, float]:
    """Detector repeatability under the homography H img1 -> img2 (the
    reference's detector_evaluation.compute_repeatability :150-220)."""
    Hh, Ww = image_shape

    def in_bounds(p):
        return (p[:, 0] >= 0) & (p[:, 0] < Ww) & (p[:, 1] >= 0) & (p[:, 1] < Hh)

    warped1 = warp_keypoints(kpts1, H)
    k1 = warped1[in_bounds(warped1)]
    back2 = warp_keypoints(kpts2, np.linalg.inv(H))
    k2 = kpts2[in_bounds(back2)]
    n1, n2 = len(k1), len(k2)
    if n1 == 0 or n2 == 0:
        return {"repeatability": 0.0, "localization_error": float("nan"),
                "count1": n1, "count2": n2}
    dists = np.linalg.norm(k1[:, None] - k2[None], axis=-1)
    min1 = dists.min(axis=1)
    min2 = dists.min(axis=0)
    count1 = np.sum(min1 <= distance_thresh)
    count2 = np.sum(min2 <= distance_thresh)
    le = float(np.mean(min1[min1 <= distance_thresh])) if count1 else float("nan")
    return {"repeatability": float((count1 + count2) / (n1 + n2)), "localization_error": le,
            "count1": int(n1), "count2": int(n2)}


def homography_correctness(matches: np.ndarray, H_gt: np.ndarray, image_shape: Tuple[int, int],
                           thresholds=(1.0, 3.0, 5.0)) -> Dict[str, float]:
    """H estimated from the matches [N, 4] (DLT over all of them) and its
    mean corner error against H_gt (the reference's
    descriptor_evaluation.compute_homography)."""
    x1 = matches[:, :2]
    x2 = matches[:, 2:4]
    if len(x1) < 4:
        return {f"correct@{t}": 0.0 for t in thresholds}
    A = []
    for (x, y), (u, v) in zip(x1, x2):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vh = np.linalg.svd(np.asarray(A))
    H_est = Vh[-1].reshape(3, 3)
    Hh, Ww = image_shape
    corners = np.array([[0, 0], [Ww - 1, 0], [0, Hh - 1], [Ww - 1, Hh - 1]], np.float64)
    err = float(np.mean(np.linalg.norm(warp_keypoints(corners, H_gt)
                                       - warp_keypoints(corners, H_est), axis=1)))
    out = {f"correct@{t}": float(err <= t) for t in thresholds}
    out["corner_error"] = err
    return out


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over the score-ranked matches
    (sklearn's average_precision_score, as the reference's computeAP uses
    it, evaluate_frontend.py:225-232)."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    if labels.size == 0 or labels.sum() == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    l_sorted = labels[order]
    tp = np.cumsum(l_sorted)
    precision = tp / (np.arange(len(l_sorted)) + 1.0)
    recall = tp / l_sorted.sum()
    prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev) * precision))


def _match(desc1, desc2, valid1, valid2, nn_thresh: float):
    """Mutual-NN matches of one pair, on the descriptors' device (numpy on
    the CPU): K4 on the card where the matcher's route takes it."""
    d1, d2 = torch.as_tensor(desc1), torch.as_tensor(desc2)
    v1 = torch.as_tensor(valid1, device=d1.device)
    v2 = torch.as_tensor(valid2, device=d2.device)
    return mutual_nn_match(d1[None], d2[None], v1[None], v2[None], nn_thresh=nn_thresh)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def matching_score_and_map(kpts1, desc1, valid1, kpts2, desc2, valid2, H_gt: np.ndarray,
                           image_shape: Tuple[int, int], nn_thresh: float = 1.2,
                           inlier_px: float = 3.0, match=None) -> Dict[str, float]:
    """Descriptor matching score and detection mAP under a gt homography
    (the reference's evaluate_frontend.eva_mscore :178-276, inliers_method
    'gt': a match is an inlier iff |H x1 - x2| < inlier_px). Keypoints [K,
    2] (x, y), descriptors [K, D] and masks [K], numpy or tensors (the
    matching runs on the descriptors' device).

    - mscore = 2 inliers / (n_kpts1 + image-2 keypoints that warp back into
      image 1), the reference's warpLabels-filtered denominator;
    - mAP = AP of the inlier labels ranked by the flipped match distance
      (max(dist) - dist, evaluate_frontend.py:236-267).

    `match`: the pair's mutual-NN match at `nn_thresh`, where the caller has
    it (`evaluate_homography_pair`), else it is taken here."""
    m = match if match is not None else _match(desc1, desc2, valid1, valid2, nn_thresh)
    keep = _np(m.valid[0])
    i1, i2 = _np(m.idx1[0])[keep], _np(m.idx2[0])[keep]
    dists = _np(m.scores[0])[keep]
    kpts1, kpts2, valid1, valid2 = (_np(a) for a in (kpts1, kpts2, valid1, valid2))
    x1, x2 = kpts1[i1], kpts2[i2]
    if len(x1):
        inl = np.linalg.norm(warp_keypoints(x1, np.asarray(H_gt)) - x2, axis=1) < inlier_px
        ap = average_precision(inl, dists.max() - dists)
        n_inl = int(inl.sum())
    else:
        ap, n_inl = 0.0, 0
    Hh, Ww = image_shape
    k1, k2 = kpts1[valid1], kpts2[valid2]
    back2 = warp_keypoints(k2, np.linalg.inv(np.asarray(H_gt))) if len(k2) else np.zeros((0, 2))
    inb = (back2[:, 0] >= 0) & (back2[:, 0] < Ww) & (back2[:, 1] >= 0) & (back2[:, 1] < Hh)
    denom = len(k1) + int(inb.sum())
    return {"mscore": float(2.0 * n_inl / denom) if denom else 0.0, "mAP": ap,
            "num_matches": int(len(x1)),
            "match_inlier_ratio": float(n_inl / len(x1)) if len(x1) else 0.0}


def evaluate_homography_pair(net, image: np.ndarray, H_gt: np.ndarray, fp: FrontendParams,
                             rep_thresh: float = 3.0) -> Dict[str, float]:
    """The reference's evaluate_frontend metric surface for one (image,
    warped image) pair: repeatability, localization error, homography
    correctness, matching score and mAP (evaluate_frontend.py:26-276). The
    warped view is `warp_perspective(image, H_gt)`; both views go through
    the frontend in one pass on the net's device."""
    device = next(net.parameters()).device
    Hh, Ww = image.shape[:2]
    H_gt = np.asarray(H_gt, np.float64)
    warped = warp_perspective(np.asarray(image, np.float32), H_gt, (Ww, Hh))
    imgs = torch.as_tensor(np.stack([image, warped]).astype(np.float32), device=device)
    with torch.no_grad():
        k = run_superpoint(net, imgs, fp)
    xy_t = k.xy + k.offsets
    xy, valid = _np(xy_t), _np(k.valid)
    # One match serves the matching score and the correctness (the JAX
    # package matches twice, with the same inputs).
    m = _match(k.desc[0], k.desc[1], k.valid[0], k.valid[1], 1.2)
    out: Dict[str, float] = {}
    out.update(compute_repeatability(xy[0][valid[0]], xy[1][valid[1]], H_gt, (Hh, Ww),
                                     distance_thresh=rep_thresh))
    out.update(matching_score_and_map(xy[0], k.desc[0], valid[0], xy[1], k.desc[1], valid[1],
                                      H_gt, (Hh, Ww), nn_thresh=1.2, match=m))
    # Correctness takes the matched pairs as [N, 4].
    matches = _np(gather_matches(xy_t[:1], xy_t[1:], m))[0][_np(m.valid[0])]
    out.update(homography_correctness(matches, H_gt, (Hh, Ww)))
    return out
