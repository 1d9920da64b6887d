"""TUM-RGBD benchmark metrics: ATE (Horn alignment) and RPE.

Counterpart of `deepfepe_tpu/eval/tum.py`, a numpy copy of the reference's
vendored TUM scripts `evaluations/evaluate_ate.py` (Horn's closed-form
alignment and the per-frame translational error) and
`evaluations/evaluate_rpe.py` (the relative pose error over a frame,
time, distance or angle delta), with `evaluations/associate.py`'s
timestamp association.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form rigid alignment of two 3xN point sets.

    Returns (R, t, trans_error) with data ≈ R @ model + t
    (ref: evaluate_ate.align :47-77).
    """
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_zc = model - model_mean
    data_zc = data - data_mean
    W = model_zc @ data_zc.T
    U, d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = data_mean - R @ model_mean
    aligned = R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, err


def ate(
    gt_xyz: np.ndarray, est_xyz: np.ndarray
) -> Dict[str, float]:
    """Absolute trajectory error after Horn alignment. Inputs: [N, 3]."""
    _, _, err = horn_align(est_xyz.T, gt_xyz.T)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
    }


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ominus(a, b) = inv(a) @ b (ref: evaluate_rpe.ominus :138)."""
    return np.linalg.inv(a) @ b


def _rot_angle(T: np.ndarray) -> float:
    return float(
        np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1.0, 1.0))
    )


def _find_closest_index(sorted_vals: np.ndarray, t: float) -> int:
    """Index of the entry closest to t (ref: evaluate_rpe :110)."""
    i = int(np.searchsorted(sorted_vals, t))
    if i <= 0:
        return 0
    if i >= len(sorted_vals):
        return len(sorted_vals) - 1
    return i if sorted_vals[i] - t < t - sorted_vals[i - 1] else i - 1


def evaluate_trajectory(
    gt_poses: np.ndarray,
    est_poses: np.ndarray,
    gt_stamps: Optional[np.ndarray] = None,
    est_stamps: Optional[np.ndarray] = None,
    max_pairs: int = 10000,
    fixed_delta: bool = False,
    delta: float = 1.0,
    delta_unit: str = "s",
    offset: float = 0.0,
    scale: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Full TUM RPE pair evaluation (ref: evaluate_rpe.evaluate_trajectory
    :204-297): all-pairs (subsampled to max_pairs) or fixed_delta pairing
    with the delta measured in seconds ('s'), meters along the estimated
    trajectory ('m'), radians/degrees of accumulated rotation
    ('rad'/'deg'), or frames ('f'); optional gt/est timestamp association
    with `offset` and translation `scale` on the estimate.

    Returns [P, 6]: stamp_est_0, stamp_est_1, stamp_gt_0, stamp_gt_1,
    trans_error (m), rot_error (rad).
    """
    gt_poses = np.asarray(gt_poses, np.float64)
    est_poses = np.asarray(est_poses, np.float64)
    n_est = len(est_poses)
    if gt_stamps is None:
        gt_stamps = np.arange(len(gt_poses), dtype=np.float64)
    if est_stamps is None:
        est_stamps = np.arange(n_est, dtype=np.float64)
    gt_stamps = np.asarray(gt_stamps, np.float64)
    est_stamps = np.asarray(est_stamps, np.float64)

    # Pair index measure per delta_unit (:242-254).
    if delta_unit == "s":
        index_est = est_stamps
    elif delta_unit == "m":
        d = np.linalg.norm(
            np.diff(est_poses[:, :3, 3], axis=0), axis=-1
        )
        index_est = np.concatenate([[0.0], np.cumsum(d)])
    elif delta_unit in ("rad", "deg"):
        angs = [
            _rot_angle(_rel(est_poses[i - 1], est_poses[i]))
            for i in range(1, n_est)
        ]
        index_est = np.concatenate([[0.0], np.cumsum(angs)])
        if delta_unit == "deg":
            index_est = np.degrees(index_est)
    elif delta_unit == "f":
        index_est = np.arange(n_est, dtype=np.float64)
    else:
        raise ValueError(f"unknown delta_unit {delta_unit!r}")

    rng = np.random.RandomState(seed)
    if not fixed_delta:
        if max_pairs == 0 or n_est < np.sqrt(max_pairs):
            pairs = [(i, j) for i in range(n_est) for j in range(n_est)]
        else:
            pairs = list(
                zip(
                    rng.randint(0, n_est, max_pairs),
                    rng.randint(0, n_est, max_pairs),
                )
            )
    else:
        pairs = []
        for i in range(n_est):
            j = _find_closest_index(index_est, index_est[i] + delta)
            if j != n_est - 1:
                pairs.append((i, j))
        if max_pairs != 0 and len(pairs) > max_pairs:
            sel = rng.choice(len(pairs), max_pairs, replace=False)
            pairs = [pairs[k] for k in sel]

    gt_interval = float(np.median(np.diff(gt_stamps))) if len(
        gt_stamps
    ) > 1 else 1.0
    max_dt = 2.0 * gt_interval

    result = []
    for i, j in pairs:
        se0, se1 = est_stamps[i], est_stamps[j]
        gi = _find_closest_index(gt_stamps, se0 + offset)
        gj = _find_closest_index(gt_stamps, se1 + offset)
        sg0, sg1 = gt_stamps[gi], gt_stamps[gj]
        if (
            abs(sg0 - (se0 + offset)) > max_dt
            or abs(sg1 - (se1 + offset)) > max_dt
        ):
            continue
        # NOTE reversed order: the reference evaluates
        # ominus(pose(t1), pose(t0)) = inv(pose_j) @ pose_i (:287-289).
        # The rotation angle is inversion-invariant but the translation
        # norm of the error is not.
        rel_est = _rel(est_poses[j], est_poses[i]).copy()
        rel_est[:3, 3] *= scale
        e = _rel(rel_est, _rel(gt_poses[gj], gt_poses[gi]))
        result.append(
            [se0, se1, sg0, sg1, np.linalg.norm(e[:3, 3]), _rot_angle(e)]
        )
    return np.asarray(result, np.float64)


def rpe(
    gt_poses: np.ndarray,
    est_poses: np.ndarray,
    delta: float = 1,
    delta_unit: str = "f",
    fixed_delta: bool = True,
    max_pairs: int = 10000,
    gt_stamps: Optional[np.ndarray] = None,
    est_stamps: Optional[np.ndarray] = None,
    **kw,
) -> Dict[str, float]:
    """RPE summary statistics (ref: evaluate_rpe __main__ :340-365).

    Defaults reproduce the historical frame-delta behavior; the full
    option surface (seconds/meters/radians/degrees deltas, all-pairs with
    max_pairs subsampling, offset/scale) is exposed via
    `evaluate_trajectory`.
    """
    res = evaluate_trajectory(
        gt_poses, est_poses, gt_stamps=gt_stamps, est_stamps=est_stamps,
        max_pairs=max_pairs, fixed_delta=fixed_delta, delta=delta,
        delta_unit=delta_unit, **kw,
    )
    if len(res) == 0:
        # No comparison pairs (trajectory shorter than delta, or every
        # fixed-delta pair fell off the end) — report emptiness instead of
        # IndexError'ing on res[:, 4] (the reference script raises with a
        # "couldn't find matching timestamp pairs" message here).
        return {
            "trans_rmse": float("nan"), "trans_mean": float("nan"),
            "trans_median": float("nan"), "rot_rmse_deg": float("nan"),
            "rot_mean_deg": float("nan"), "num_pairs": 0,
        }
    t_errs, r_errs = res[:, 4], res[:, 5]
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_errs**2))),
        "trans_mean": float(np.mean(t_errs)),
        "trans_median": float(np.median(t_errs)),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(r_errs**2)))),
        "rot_mean_deg": float(np.degrees(np.mean(r_errs))),
        "num_pairs": int(len(res)),
    }


def associate(
    stamps_a: Sequence[float],
    stamps_b: Sequence[float],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (ref: evaluations/associate.py)."""
    pairs = []
    for ia, ta in enumerate(stamps_a):
        for ib, tb in enumerate(stamps_b):
            if abs(ta - (tb + offset)) < max_difference:
                pairs.append((abs(ta - (tb + offset)), ia, ib))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, ia, ib in pairs:
        if ia not in used_a and ib not in used_b:
            used_a.add(ia)
            used_b.add(ib)
            out.append((ia, ib))
    out.sort()
    return out
