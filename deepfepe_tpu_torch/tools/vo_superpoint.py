"""Full-pipeline (SuperPoint frontend -> DeepF solver) sequence VO.

    python -m deepfepe_tpu_torch.tools.vo_superpoint --sp SP.msgpack
        [--deepf DEEPF.msgpack] [--n_frames 60] [--out logs/vo_sp]
        [--refine_ba] [--refine_huber PX] [--refine_t_only]
        [--device cuda|cpu | --cpu]

Counterpart of the JAX package's `tools/vo_superpoint.py`, with its flags:
BASELINE.md's "DeepFEPE" row path. Frames of a `SyntheticImageSequence`
go through SuperPoint, mutual-NN matching and the learned solver
(`tools.sp_pipeline`, shared with `vo_pose_graph`); the chained poses are
scored with KITTI-style metrics against the RANSAC 8-point baseline on the
same matches, its draws from a generator seeded 5 (the JAX tool's
PRNGKey(5)). `--refine_ba` polishes each pair's solver pose by two-view
square-root BA (`eval.refine`, under `no_tf32`); `--refine_huber` and
`--refine_t_only` as there. `--cpu` is `--device cpu`.

Writes trajectory_{est,base,gt}.txt and summary.json under `--out` with
the JAX tool's keys and rounding, and prints the summary; `main` returns
it with 'seconds' (host clock over the sweep, ending in a synchronize).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..eval import chain_relative_poses, evaluate_sequence, export_poses_kitti
from ..eval.refine import refine_two_view_batch
from ..geometry.rotations import rotation_angle_error, vector_angle
from ..utils.device import resolve_device
from .sp_pipeline import (frontend_params, load_frontend, load_solver, pair_sweep, sequence,
                          solver_config)

IMG = (120, 160)
NPTS = 200


def refined(m, b, Me: np.ndarray, args):
    """The pairs' solver poses after the polish: ([B, 3, 4] poses, err_q,
    err_t against the ground truth)."""
    dev = m["matches_xy"].device
    R_ref, t_ref, _ = refine_two_view_batch(
        m["matches_xy"].float(), m["weights"].float(), b["Ks"].float(),
        torch.as_tensor(Me[:, :3, :3], device=dev), torch.as_tensor(Me[:, :3, 3], device=dev),
        iters=5, refine_rotation=not args.refine_t_only, huber_px=args.refine_huber)
    gt = b["delta_Rtijs_4_4"].to(R_ref.dtype)
    eq = rotation_angle_error(R_ref, gt[:, :3, :3]).cpu().numpy()
    et = vector_angle(t_ref, gt[:, :3, 3]).cpu().numpy()
    M = torch.cat([R_ref, t_ref[..., None]], -1).cpu().numpy().astype(np.float32)
    return M, eq, np.minimum(et, 180.0 - et)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sp", required=True)
    ap.add_argument("--deepf", default="")
    ap.add_argument("--out", default="logs/vo_sp")
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--conf", type=float, default=0.010)
    ap.add_argument("--nn_thresh", type=float, default=0.9)
    ap.add_argument("--image", type=int, nargs=2, default=list(IMG))
    ap.add_argument("--npts", type=int, default=NPTS)
    ap.add_argument("--step_scale", type=float, default=1.0,
                    help="multiplier on the auto-chosen step_length")
    ap.add_argument("--n_corners", type=int, default=0,
                    help="corner stamps per plane texture (match density)")
    ap.add_argument("--refine_ba", action="store_true",
                    help="two-view sqrt-BA polish of each pair's solver pose (eval/refine.py)")
    ap.add_argument("--refine_huber", type=float, default=0.0,
                    help="Huber IRLS scale in px for the polish (0 = off)")
    ap.add_argument("--refine_t_only", action="store_true",
                    help="freeze rotations during the polish")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    img = tuple(args.image)
    os.makedirs(args.out, exist_ok=True)

    seq = sequence(args.n_frames, img, args.step_scale, args.n_corners, args.seed)
    cfg = solver_config(args.npts, args.batch, img)
    sp_net = load_frontend(args.sp, device)
    deepf_net = load_solver(cfg, args.deepf, device)
    fp = frontend_params(args.npts, args.conf, args.nn_thresh)
    refine = args.refine_ba or args.refine_t_only

    generator = torch.Generator().manual_seed(5)
    rels = {"est": [], "base": [], "gt": []}
    errs = {"q_est": [], "t_est": [], "q_base": [], "t_base": []}
    nmatches = []
    t0 = time.perf_counter()
    for batch, m, rt in pair_sweep(seq, args.batch, deepf_net, sp_net, fp, cfg, device,
                                   ransac=True, generator=generator):
        Me = rt["M_est"].cpu().numpy()
        Mb = rt["M_base"].cpu().numpy()
        eq, et = rt["err_q_est"].cpu().numpy(), rt["err_t_est"].cpu().numpy()
        if refine:
            Me, eq, et = refined(m, {k: torch.as_tensor(v, device=device)
                                     for k, v in batch.items()}, Me, args)
        eqb, etb = rt["err_q_base"].cpu().numpy(), rt["err_t_base"].cpu().numpy()
        for i in range(Me.shape[0]):
            if int(batch["frame_i"][i]) == len(rels["est"]):  # skip padded duplicates
                rels["est"].append(Me[i])
                rels["base"].append(Mb[i])
                rels["gt"].append(np.asarray(batch["delta_Rtijs_4_4"][i]))
                errs["q_est"].append(float(eq[i]))
                errs["t_est"].append(float(et[i]))
                errs["q_base"].append(float(eqb[i]))
                errs["t_base"].append(float(etb[i]))
        nmatches.append(float(m["num_matches"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0

    gt_traj = seq.gt_trajectory()
    total = float(np.linalg.norm(np.diff(gt_traj[:, :3, 3], axis=0), axis=1).sum())
    lengths = tuple(round(total * f, 1) for f in (0.2, 0.4, 0.6))
    summary = {"n_pairs": len(rels["est"]),
               "mean_num_matches": round(float(np.mean(nmatches)), 1) if nmatches else None,
               "traj_len": round(total, 2)}
    for name in ("est", "base"):
        traj = chain_relative_poses(np.stack(rels[name]))
        export_poses_kitti(traj, os.path.join(args.out, f"trajectory_{name}.txt"))
        rep = evaluate_sequence(gt_traj, traj, align="scale", lengths=lengths)
        rep["median_err_q"] = float(np.median(errs[f"q_{name}"]))
        rep["median_err_t"] = float(np.median(errs[f"t_{name}"]))
        summary[name] = {k: round(v, 4) for k, v in rep.items()}
    export_poses_kitti(gt_traj, os.path.join(args.out, "trajectory_gt.txt"))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return {**summary, "seconds": seconds}


if __name__ == "__main__":
    main()
