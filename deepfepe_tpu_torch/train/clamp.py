"""Quantile-tied clamp scheduling for the pose (q, t) loss.

The reference tightens its q/t loss clamps on a fixed ITERATION schedule
(Train_model_pipeline.py:467-489: (0.1, 0.5) -> (0.01, 0.3) -> (0.001,
0.1) at clamp_iter1=3k / clamp_iter2=6k of 30k+ total) — which works
only because by iteration 3k/6k the error distribution has already moved
inside the next clamp level. On short runs the same schedule saturates:
round 4 measured the loss pinning at exactly q_clamp + t_clamp with zero
gradients once nearly every item clips, and the few unsaturated items
then drive high-variance updates that regress the solver
(experiments/joint_fullres_train_qt/README.md §bugs #1).

`QuantileClampScheduler` makes the implicit coupling explicit: clamps
tighten exactly when the MEASURED per-item error quantile is inside
them, with bounded shrink per check so the loss surface never changes
abruptly. The train step exposes the per-item unclamped final-layer
errors as `q_l2_final` / `t_l2_final` (train/engine.compute_losses), so
scheduling costs one tiny host transfer per step that training loops
already pay for metric logging.

Rule, per clamp c and error window E (checked every `check_every`
updates over a sliding window of the last `window` per-item errors):

    target = headroom * quantile(E, q)            # clamp sits above the bulk
    c'     = clip(target, max_shrink*c, max_grow*c)  # bounded move per check
    c'     = clip(c', floor, c0)                  # reference curriculum ends

so at most `1 - max_shrink` of the clamp is removed (or `max_grow - 1`
added) per check, and at steady state ~q of the items keep gradient
signal IN BOTH DIRECTIONS.

Bidirectionality is load-bearing, not a nicety (round-5 measured
failure, experiments/r5_frozen_qsched): a monotone tighten-only
scheduler parked q_clamp at 0.0075 while the q errors were ~0, and when
later t-driven updates pushed q errors outside the clamp, every item
saturated — the clamped loss contributes a CONSTANT for saturated
items, so the training loss was blind to a runaway to median err_q 121
deg on held-out pairs (training loss stayed 0.4-0.46 throughout).
Re-opening the clamp when the measured quantile escapes above it
restores the corrective gradient exactly when drift starts; the cap at
the start level (c0, the reference's loosest curriculum stage) keeps
the loss surface inside the reference's own operating envelope.

A copy of `deepfepe_tpu/train/clamp.py` (it imports nothing of JAX).
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np


class QuantileClampScheduler:
    """Error-quantile-driven (q_clamp, t_clamp) schedule.

    Defaults anchor to the reference curriculum's endpoints: start at
    its loosest level (0.1, 0.5), floor at its tightest (0.001, 0.1)
    (configs/kitti_corr_baseline.yaml clamp_q_params/clamp_t_params).
    """

    def __init__(
        self,
        q0: float = 0.1,
        t0: float = 0.5,
        q_floor: float = 0.001,
        t_floor: float = 0.1,
        quantile: float = 0.7,
        headroom: float = 1.5,
        check_every: int = 50,
        window: int = 400,
        max_shrink: float = 0.5,
        max_grow: float = 2.0,
    ):
        self.q_clamp = float(q0)
        self.t_clamp = float(t0)
        self.q_ceil = float(q0)
        self.t_ceil = float(t0)
        self.q_floor = float(q_floor)
        self.t_floor = float(t_floor)
        self.quantile = float(quantile)
        self.headroom = float(headroom)
        self.check_every = int(check_every)
        self.max_shrink = float(max_shrink)
        self.max_grow = float(max_grow)
        self._q_errs: deque = deque(maxlen=int(window))
        self._t_errs: deque = deque(maxlen=int(window))
        self._n_updates = 0
        self.n_tightenings = 0
        self.n_loosenings = 0

    def _retarget(self, clamp: float, floor: float, ceil: float,
                  errs: deque) -> float:
        e = np.asarray(errs, np.float64)
        e = e[np.isfinite(e)]
        if e.size == 0:
            return clamp
        target = self.headroom * float(np.quantile(e, self.quantile))
        # Bounded move toward the target, clipped to [floor, ceil].
        new = min(max(target, self.max_shrink * clamp),
                  self.max_grow * clamp)
        return min(max(new, floor), ceil)

    def update(self, q_errs, t_errs) -> Tuple[float, float]:
        """Feed one step's per-item unclamped errors; returns the clamps
        to use for the NEXT step."""
        self._q_errs.extend(np.ravel(np.asarray(q_errs, np.float64)))
        self._t_errs.extend(np.ravel(np.asarray(t_errs, np.float64)))
        self._n_updates += 1
        if self._n_updates % self.check_every == 0 and len(self._q_errs):
            new_q = self._retarget(self.q_clamp, self.q_floor, self.q_ceil,
                                   self._q_errs)
            new_t = self._retarget(self.t_clamp, self.t_floor, self.t_ceil,
                                   self._t_errs)
            if new_q < self.q_clamp or new_t < self.t_clamp:
                self.n_tightenings += 1
            if new_q > self.q_clamp or new_t > self.t_clamp:
                self.n_loosenings += 1
            self.q_clamp, self.t_clamp = new_q, new_t
        return self.q_clamp, self.t_clamp

    @property
    def clamps(self) -> Tuple[float, float]:
        return self.q_clamp, self.t_clamp
