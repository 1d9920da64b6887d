"""Time and profile K3 (the epipolar residual) and its backward on the card,
at its callers' broadcast patterns, through `compute_epi_residual`.

    python -m deepfepe_tpu_torch.tools.profile_epi [--iters N] [--tag NAME]

The cases (CASES) are the three callers at chip_smoke.py's full width:
DeepFNet's feature (points [8, 1000, 3] against F [8, 3, 3]; its backward
with the points' gradients is the learned offsets'), the F-loss ([1, 8,
100, 3] against [5, 8, 3, 3]) and the sample loss's auxiliary ([1, 8, 1,
100, 3] against [5, 8, 100, 3, 3]; also with the points' gradients, which
no path asks for there, to time that sum at its longest). Each case
prints one JSON line a direction (the forward; the backward through
autograd, the graph kept; `points_gradient` says whether it takes the
points' gradients too):

  ms              CUDA events around back-to-back calls, over the count
                  (host pacing included, as a caller sees it);
  host_ms         the host's time to issue one call, the device left
                  to run behind;
  device_ms       the device time of one call: all its device operations
                  (kernels, copies, sets) in a torch.profiler trace of
                  --iters calls, over the count;
  kernel_ms       the same for the K3 kernels alone (names holding
                  'epi_');
  device_ops      device operations a call, and `split`, by name;
  one_call        the device operations of one call by name, from a trace
                  of that call alone (taken again, up to three traces,
                  while it reads empty: `traces`).

A first line gives the floor: an empty kernel launched through ctypes,
timed as `ms` is. Needs a CUDA card and nvcc; exits 2 without a card.
The tool uses only what every version of the port has, so the same file
measures two checkouts in one call (copied into each, run from its root).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from deepfepe_tpu_torch.tools.profile_mlp import cuda_time_ms, host_ms

# name, points' shape, F's shape, clamp, points' gradient wanted.
CASES = (("deepfnet", (8, 1000, 3), (8, 3, 3), 0.5, False),
         ("offsets", (8, 1000, 3), (8, 3, 3), 0.5, True),
         ("f_loss", (1, 8, 100, 3), (5, 8, 3, 3), 0.02, False),
         ("sample_aux", (1, 8, 1, 100, 3), (5, 8, 100, 3, 3), 0.02, False),
         ("sample_aux_points", (1, 8, 1, 100, 3), (5, 8, 100, 3, 3), 0.02, True))
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def inputs(pts_shape, F_shape, clamp: float, seed: int = 0):
    """Points in the solver's [-1, 1] frame, x2 near x1's epipolar line of
    a sideways translation F0, and F0 + noise: some residuals clamped,
    most not (chip_smoke.py's `epi_inputs` at a caller's shape)."""
    g = torch.Generator().manual_seed(seed)
    x1 = torch.rand(*pts_shape[:-1], 2, generator=g) * 2 - 1
    x2 = torch.stack([torch.rand(*pts_shape[:-1], generator=g) * 2 - 1,
                      x1[..., 1] + 0.5 * clamp * torch.randn(*pts_shape[:-1], generator=g)], -1)
    ones = torch.ones(*pts_shape[:-1], 1)
    F0 = torch.tensor([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    F = F0 + 0.1 * clamp * torch.randn(*F_shape, generator=g)
    return (torch.cat([x1, ones], -1).cuda(), torch.cat([x2, ones], -1).cuda(), F.cuda())


def device_split(fn, calls: int) -> dict:
    """`calls` calls of fn under torch.profiler: device operations a call,
    their device ms a call, the K3 kernels' alone, and the split by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.mkdtemp(prefix="profile_epi_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = {}
    for e in dev:
        n, us = split.get(e["name"][:100], (0, 0.0))
        split[e["name"][:100]] = (n + 1, us + e["dur"])
    return {"device_ops": len(dev) / calls,
            "device_ms": sum(e["dur"] for e in dev) / 1e3 / calls,
            "kernel_ms": sum(e["dur"] for e in dev if "epi_" in e["name"]) / 1e3 / calls,
            "split": {k: {"a_call": n / calls, "ms": us / 1e3 / calls}
                      for k, (n, us) in sorted(split.items(), key=lambda kv: -kv[1][1])}}


def one_call(fn, tries: int = 3) -> tuple:
    """The names of the device operations of one call of fn and the traces
    taken: a trace without any is taken again, up to `tries` (the profiler
    has been seen to drop a call's device events, chip_smoke.py
    `device_ops`)."""
    for n in range(1, tries + 1):
        split = device_split(fn, 1)["split"]
        names = [k for k, v in split.items() for _ in range(round(v["a_call"]))]
        if names:
            break
    return names, n


def empty_launch_ms(iters: int) -> float:
    """An empty kernel launched through ctypes, back to back: the floor of
    a ctypes wrapper's pace."""
    from deepfepe_tpu_torch.utils import build

    tmp = tempfile.mkdtemp(prefix="empty_launch_")
    cu, so = os.path.join(tmp, "empty.cu"), os.path.join(tmp, "empty.so")
    with open(cu, "w") as f:
        f.write(EMPTY_SOURCE)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    return cuda_time_ms(lambda: lib.empty_launch(stream), iters)


def case_fns(name, pts_shape, F_shape, clamp, points: bool) -> dict:
    """The case's calls: {'forward': ..., 'backward': ...}, the backward
    through autograd on one kept graph; a case with the points' gradient
    has only the backward (its forward is the other case's)."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

    pts1, pts2, F = inputs(pts_shape, F_shape, clamp)
    wrt = [pts1.requires_grad_(), pts2.requires_grad_(), F] if points else [F]
    F.requires_grad_()
    fwd = lambda: compute_epi_residual(pts1, pts2, F, clamp_at=clamp)  # noqa: E731
    out = fwd()
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).cuda()
    bwd = lambda: torch.autograd.grad(out, wrt, g, retain_graph=True)  # noqa: E731
    return {"backward": bwd} if points else {"forward": fwd, "backward": bwd}


def timing(fn, iters: int) -> dict:
    """ms, host_ms, the profiled split and one call's operations (the
    module's docstring)."""
    names, traces = one_call(fn)
    return {"ms": cuda_time_ms(fn, iters), "host_ms": host_ms(fn, iters),
            **device_split(fn, iters), "one_call": names, "traces": traces}


def measure(name, pts_shape, F_shape, clamp, points: bool, iters: int) -> list:
    return [{"case": name, "direction": direction, "points": list(pts_shape),
             "F": list(F_shape), "points_gradient": points, **timing(fn, iters)}
            for direction, fn in case_fns(name, pts_shape, F_shape, clamp, points).items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200, help="calls timed and profiled a row")
    ap.add_argument("--tag", default="", help="a label copied into every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_epi: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "nvidia_smi": smi,
                      "empty_launch_ms": empty_launch_ms(args.iters)}), flush=True)
    for case in CASES:
        for row in measure(*case, args.iters):
            print(json.dumps({"tag": args.tag, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
