"""Time and profile the fused PointNet MLP kernels, K2 (`mlp_forward`) and
K2b (`mlp_backward`), on the card.

    python -m deepfepe_tpu_torch.tools.profile_mlp [--B 8,64] [--c_in 5,8]

For each batch B (N = 1000 points an item) and input width C_in, at the
ErrorEstimator's full width (64-128-1024-512-256, one output), prints one
JSON line a kernel:

  ms            CUDA events around back-to-back calls, over the count
                (host pacing included, as a caller sees it);
  host_ms       the host's time to launch one call (the wrapper's Python,
                ctypes and launches), without waiting for the device;
  device_ms     the device time of one call: the sum of its device
                operations' durations in a torch.profiler trace;
  device_ops    the number of device operations (kernels, copies, sets)
                of that call;
  split         that call's device time by kernel name (the name cut to
                100 characters), with its launches.

Needs a CUDA card; exits 2 without one. The inputs are seeded
(`mlp_inputs`), as `chip_smoke.py` makes them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from deepfepe_tpu_torch.models.error_estimator import FEATURES

N_POINTS = 1000


def mlp_inputs(c_in: int, B: int = 8, N: int = N_POINTS):
    """A full-width ErrorEstimator on the card with non-trivial affines and
    final bias, its parameters as the wrappers take them, x and g."""
    from deepfepe_tpu_torch.models import ErrorEstimator

    gen = torch.Generator().manual_seed(c_in)
    est = ErrorEstimator(c_in, 1, features=FEATURES, dtype=torch.bfloat16)
    est.reset_parameters(gen)
    with torch.no_grad():
        for m in est.fw[1:-1:3]:
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-0.2, 0.2, generator=gen)
        est.fw[-1].bias.fill_(0.1)
    est = est.cuda()
    L = len(FEATURES)
    params = ([est.fw[3 * i].weight.detach() for i in range(L)],
              [est.fw[3 * i + 1].weight.detach() for i in range(L)],
              [est.fw[3 * i + 1].bias.detach() for i in range(L)],
              est.fw[-1].weight.detach(), est.fw[-1].bias.detach())
    x = torch.rand(B, N, c_in, generator=gen).cuda()
    g = (torch.randn(B, N, 1, generator=gen) / (B * N)).cuda()
    return est, params, x, g


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms a call of back-to-back calls, between two CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time to launch a call, the device left to run behind."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    spent = time.perf_counter() - t
    torch.cuda.synchronize()
    return spent / iters * 1e3


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler: its device operations, their
    summed duration and the split by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.mkdtemp(prefix="profile_mlp_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = {}
    for e in dev:
        calls, us = split.get(e["name"][:100], (0, 0.0))
        split[e["name"][:100]] = (calls + 1, us + e["dur"])
    return {"device_ops": len(dev), "device_ms": sum(e["dur"] for e in dev) / 1e3,
            "split": {n: {"launches": c, "ms": us / 1e3}
                      for n, (c, us) in sorted(split.items(), key=lambda kv: -kv[1][1])}}


def profile_point(B: int, c_in: int, iters: int) -> list:
    """K2 and K2b at (B, c_in): event times and one profiled call each."""
    from deepfepe_tpu_torch.ops import mlp

    _, (Ws, gammas, betas, Wf, bf), x, g = mlp_inputs(c_in, B)
    fwd = lambda: mlp.mlp_forward(x, Ws, gammas, betas, Wf, bf)  # noqa: E731
    bwd = lambda: mlp.mlp_backward(x, g, Ws, gammas, betas, Wf)  # noqa: E731
    rows = []
    for name, fn, n in (("mlp_forward", fwd, 5 * iters), ("mlp_backward", bwd, 2 * iters)):
        rows.append({"kernel": name, "B": B, "N": N_POINTS, "c_in": c_in,
                     "ms": cuda_time_ms(fn, n), "host_ms": host_ms(fn, n), **device_profile(fn)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", default="8,64", help="batch sizes, comma-separated")
    ap.add_argument("--c_in", default="5,8", help="input widths, comma-separated")
    ap.add_argument("--iters", type=int, default=10, help="timed calls (x5 forward, x2 backward)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mlp: no CUDA device", file=sys.stderr)
        return 2
    for B in (int(b) for b in args.B.split(",")):
        for c_in in (int(c) for c in args.c_in.split(",")):
            for row in profile_point(B, c_in, args.iters):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
