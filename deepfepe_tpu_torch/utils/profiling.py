"""Profiling on `torch.profiler`.

Counterpart of `deepfepe_tpu/utils/profiling.py`, whose XLA device traces
become `torch.profiler` captures (the CPU, and the card's kernels on a
card) written as a Chrome trace, `<log_dir>/trace.json`, which
chrome://tracing and Perfetto open. `annotate` is a host scope that shows
on the trace's timeline, and `StepTimer` a wall-clock step timer.

    from deepfepe_tpu_torch.utils.profiling import annotate, device_trace

    with device_trace("logs/exp0/trace", device):
        for _ in range(20):
            with annotate("step"):
                train_step(net, opt, batch, cfg)

`train_good --profile_dir` traces the steps [profile_start, profile_start
+ profile_steps) the same way (`train/loop.py`).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import numpy as np
import torch

from ..train.loop import start_profile, stop_profile

annotate = torch.profiler.record_function


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """A `torch.profiler` capture of the block into `log_dir/trace.json`,
    ending after the device's work."""
    device = torch.device(device)
    prof = start_profile(device)
    try:
        yield prof
    finally:
        stop_profile(prof, device, log_dir)


class StepTimer:
    """Wall-clock step timer: `tick()` a step, `summary()` the median and
    mean of the second half of the steps (appended to `path` as a JSON
    line). Ticks time the host's enqueueing: a step that ends in a
    synchronize (or a device-to-host copy) times its device work too."""

    def __init__(self, path: Optional[str] = None):
        self._t = []
        self._last = None
        self._path = path

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._t.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self._t:
            return {"steps": 0}
        arr = np.asarray(self._t[len(self._t) // 2:])
        out = {"steps": len(self._t), "median_step_s": float(np.median(arr)),
               "mean_step_s": float(np.mean(arr))}
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(out) + "\n")
        return out
