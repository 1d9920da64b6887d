"""Bundle adjustment and pose-graph fusion at SfM sizes.

    python -m deepfepe_tpu_torch.tools.bench_ba [--points 1000 10000 100000]
        [--cams 100] [--sqrt_cams 32] [--pg_frames 1000 10000] [--iters 8]
        [--device cuda|cpu] [--out DIR]

Runs, on synthetic problems from `ba.make_sfm_problem` (numpy's
RandomState(0), drawn row after row as the JAX package's tool draws them):

- the Schur-complement BA step (`ba_step`, damping 1e-3) at C = `--cams`
  cameras and each P of `--points` landmarks, window 20;
- the square-root BA step (`sqrt_ba_step`) at C = `--sqrt_cams` (its
  landmark system is dense in C) and each P <= 10,000, window 10;
- the two-stage pose graph (8 + 8 Gauss-Newton steps; CG past 512 nodes)
  on drifting odometry chains of each `--pg_frames` frames with (i, i + 2)
  skip edges.

One JSON line a row: 15 steps' costs (first, last, `converged` when the
last is under 5% of the first), `ms_per_iter` (the mean of `--iters`
chained steps after two warm ones: CUDA events on the card, the host clock
on the CPU), observations a second and `peak_mb` (the card's peak
allocation over one step, inputs included; null on the CPU); for the pose
graph the cold and warm wall seconds of the whole solve, its residuals and
the ATE of the fused positions against the ground truth. Then a Markdown
table; with `--out`, results.jsonl and TABLE.md there. Every solve runs
in float32 with TF32 off (`utils.device.no_tf32`).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ba import (ba_step, graph_from_odometry, make_sfm_problem,
                  optimize_pose_graph_two_stage, sqrt_ba_step)
from ..geometry.lie import se3_exp
from ..utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(step, prob, iters: int, device: torch.device) -> float:
    """Mean ms a step over `iters` chained steps, after two warm ones."""
    for _ in range(2):
        prob = step(prob)
    _sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            prob = step(prob)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        prob = step(prob)
    return (time.perf_counter() - t0) * 1e3 / iters


def peak_mb(step, prob, device: torch.device):
    """The card's peak allocation in MB over one step (inputs included)."""
    if device.type != "cuda":
        return None
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    step(prob)
    _sync(device)
    return torch.cuda.max_memory_allocated(device) / 1e6


def ba_row(solver: str, step_fn, rng, C: int, P: int, window: int, iters: int,
           device: torch.device) -> dict:
    prob = make_sfm_problem(rng, C=C, P=P, window=window, device=device)[0]

    def step(p):
        return step_fn(p, damping=1e-3)[0]

    costs, p = [], prob
    for _ in range(15):
        p, info = step_fn(p, damping=1e-3)
        costs.append(float(info["cost"]))
    ms = timed_ms(step, prob, iters, device)
    n_obs = int(prob.vis.sum())
    return {"solver": solver, "C": C, "P": P, "obs": n_obs, "ms_per_iter": ms,
            "obs_per_s": n_obs / (ms / 1e3), "peak_mb": peak_mb(step, prob, device),
            "cost_first": costs[0], "cost_last": costs[-1],
            "converged": costs[-1] < 0.05 * costs[0]}


def drift_graph(rng, N: int, device: torch.device):
    """A straight 1 m/frame chain, odometry edges with 0.005 and skip edges
    with 0.004 se(3) noise (float64 numpy draws, as the JAX tool's); returns
    (graph, gt world -> frame poses)."""
    gt = [np.eye(4)]
    for _ in range(N - 1):
        T = np.eye(4)
        T[:3, 3] = [0, 0, -1.0]
        gt.append(T @ gt[-1])
    gt = np.stack(gt)
    noise = lambda s: se3_exp(torch.as_tensor(rng.randn(6) * s)).numpy()  # noqa: E731
    rels1 = [noise(0.005) @ gt[i + 1] @ np.linalg.inv(gt[i]) for i in range(N - 1)]
    rels2 = [noise(0.004) @ gt[i + 2] @ np.linalg.inv(gt[i]) for i in range(N - 2)]
    graph = graph_from_odometry(
        torch.as_tensor(np.stack(rels1), dtype=torch.float32, device=device),
        loop_edges=torch.as_tensor(np.stack([np.arange(N - 2), np.arange(2, N)], -1),
                                   device=device),
        loop_measurements=torch.as_tensor(np.stack(rels2), dtype=torch.float32, device=device))
    return graph, gt


def pose_graph_row(rng, N: int, device: torch.device) -> dict:
    graph, gt = drift_graph(rng, N, device)

    def run():
        _sync(device)
        t0 = time.perf_counter()
        g2, errs = optimize_pose_graph_two_stage(graph, rot_iters=8, trans_iters=8)
        _sync(device)
        return time.perf_counter() - t0, g2, errs

    cold, _, _ = run()
    warm, g2, errs = run()
    pos = g2.poses[:, :3, 3].double().cpu().numpy()
    return {"solver": "pose_graph_two_stage", "frames": N, "edges": int(graph.edges.shape[0]),
            "wall_s_cold": cold, "wall_s_warm": warm, "resid_first": float(errs[0]),
            "resid_last": float(errs[-1]),
            "ate_vs_gt_m": float(np.sqrt(np.mean(np.sum((pos - gt[:, :3, 3]) ** 2, -1))))}


def table(rows: list) -> str:
    md = ["| solver | C/frames | P | obs/edges | ms/iter | obs/s | peak MB | cost first->last |",
          "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["solver"] == "pose_graph_two_stage":
            md.append(f"| {r['solver']} | {r['frames']} | - | {r['edges']} | warm "
                      f"{r['wall_s_warm'] * 1e3:.0f} ms a solve | - | - | {r['resid_first']:.3g}"
                      f" -> {r['resid_last']:.3g} |")
        else:
            peak = "-" if r["peak_mb"] is None else f"{r['peak_mb']:.0f}"
            md.append(f"| {r['solver']} | {r['C']} | {r['P']} | {r['obs']} | "
                      f"{r['ms_per_iter']:.3f} | {r['obs_per_s']:.0f} | {peak} | "
                      f"{r['cost_first']:.4g} -> {r['cost_last']:.4g} "
                      f"({'ok' if r['converged'] else 'NOT CONVERGED'}) |")
    return "\n".join(md)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, nargs="+", default=[1000, 10000, 100000])
    ap.add_argument("--cams", type=int, default=100)
    ap.add_argument("--sqrt_cams", type=int, default=32)
    ap.add_argument("--pg_frames", type=int, nargs="+", default=[1000, 10000])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    ap.add_argument("--out", default="", help="also write results.jsonl and TABLE.md here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    rows = []

    def log(rec):
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for P in args.points:
        log(ba_row("schur_ba", ba_step, rng, args.cams, P, 20, args.iters, device))
    for P in [p for p in args.points if p <= 10000]:
        log(ba_row("sqrt_ba", sqrt_ba_step, rng, args.sqrt_cams, P, 10,
                   max(args.iters // 2, 3), device))
    for N in args.pg_frames:
        log(pose_graph_row(rng, N, device))
    md = table(rows)
    print(md, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.jsonl"), "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        with open(os.path.join(args.out, "TABLE.md"), "w") as f:
            f.write(md + "\n")
    return rows


if __name__ == "__main__":
    main()
