"""Multi-frame VO: fuse delta-1 and delta-2 solver estimates in a pose graph.

    python -m deepfepe_tpu_torch.tools.vo_pose_graph --sp SP.msgpack
        [--deepf DEEPF.msgpack] [--n_frames 30] [--image 240 320]
        [--n_corners 60] [--two_stage] [--device cuda|cpu] [--out DIR]

The SuperPoint -> DeepF pipeline (`train.joint.joint_eval_step`) estimates
the relative poses of a `SyntheticImageSequence` for frame gaps 1
(odometry edges) and 2 (skip edges); `ba.pose_graph` fuses them by
Gauss-Newton on se(3), jointly or with `--two_stage` (rotation averaging,
then translation with the rotations frozen). Skip edges constrain the
composition of two odometry edges and average down their independent
noise. Each edge's translation takes the pair's gt length (t_scene_scale),
the monocular convention. The checkpoints are the JAX package's flax
files (or the reference's `.pth.tar`): `--sp` a SuperPointNet, `--deepf`
the solver (seeded when absent; depth 5, the quality feature, bf16 MLP, as
the JAX tool builds it). On the card the frontend takes the hand-written
kernels: K5 on its layers of >= 16,384 pixels and K4 for the matching.

Prints one JSON line: n_frames, the trajectory length, the Gauss-Newton
residual before the first and last steps, the KITTI metrics of the chained
and the fused trajectories (segments at 20/40/60% of the length) and
`seconds` (host clock over both sweeps, ending in a synchronize; and over
the fusion); writes trajectory_{chained,pose_graph,gt}.txt and
summary.json under `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ba import graph_from_odometry, optimize_pose_graph, optimize_pose_graph_two_stage
from ..data import SyntheticImageSequence
from ..eval import chain_relative_poses, evaluate_sequence, export_poses_kitti, val_rt_batch
from ..frontend import FrontendParams
from ..loader import model_loader
from ..train import load_checkpoint
from ..train.config import Config
from ..train.joint import joint_eval_step
from ..utils.device import batch_to_device, no_tf32, resolve_device
from ..utils.weights import load_superpoint


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sp", required=True, help="SuperPointNet checkpoint")
    ap.add_argument("--deepf", default="", help="DeepF checkpoint (seeded when absent)")
    ap.add_argument("--out", default="logs/vo_pose_graph")
    ap.add_argument("--n_frames", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--image", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--npts", type=int, default=300)
    ap.add_argument("--n_corners", type=int, default=60)
    ap.add_argument("--step_scale", type=float, default=2.0)
    ap.add_argument("--skip_weight", type=float, default=0.5,
                    help="translation information of skip edges")
    ap.add_argument("--skip_rot_weight", type=float, default=1.0,
                    help="rotation information of skip edges; keep it >= the translation "
                         "weight without --two_stage (weakly held rotations absorb skip-edge "
                         "translation misfit)")
    ap.add_argument("--gn_iters", type=int, default=15)
    ap.add_argument("--two_stage", action="store_true",
                    help="rotation averaging, then translation with the rotations frozen")
    ap.add_argument("--huber", type=float, default=0.05,
                    help="Huber delta on the se(3) edge-residual norm (0: off)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    img = tuple(args.image)

    seq = SyntheticImageSequence(
        n_frames=args.n_frames, image_size=img, focal=140.0 * img[1] / 160.0,
        step_length=args.step_scale * min(0.12, 0.6 * 12.0 / args.n_frames),
        n_corners=args.n_corners, seed=args.seed)
    cfg = Config()
    cfg.model.depth = 5
    cfg.model.if_quality = True
    cfg.model.mlp_dtype = "bfloat16"
    cfg.data.good_num = args.npts
    cfg.data.batch_size = args.batch
    cfg.data.resize = list(img)
    sp_net = load_superpoint(args.sp, device)
    deepf_net = model_loader(cfg, device, torch.Generator().manual_seed(1))
    if args.deepf:
        load_checkpoint(args.deepf, deepf_net)
    fp = FrontendParams(out_num_points=args.npts, conf_thresh=0.010, nn_thresh=0.9,
                        conv_impl="pallas", matcher="pallas")

    def estimate_rels(delta):
        """[n - delta, 4, 4] (i, i + delta) poses, gt-scaled translations."""
        rels = {}
        for batch in seq.pair_batches(args.batch, delta=delta):
            b = batch_to_device(batch, device)
            m = joint_eval_step(deepf_net, sp_net, b, fp, cfg)
            rt = val_rt_batch(m["E_ests"], b["Ks"], m["matches_xy"], b["E_gts"],
                              b["delta_Rtijs_4_4"], ransac=False)
            Me = rt["M_est"].double().cpu().numpy()
            scale = np.asarray(batch["t_scene_scale"]).reshape(len(Me), -1)[:, 0]
            for i in range(len(Me)):
                fidx = int(batch["frame_i"][i])
                if fidx not in rels:
                    M = np.eye(4)
                    M[:3, :3] = Me[i, :3, :3]
                    tn = Me[i, :3, 3]
                    M[:3, 3] = tn / max(np.linalg.norm(tn), 1e-9) * scale[i]
                    rels[fidx] = M
        return np.stack([rels[i] for i in sorted(rels)])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    rel1 = estimate_rels(1)
    rel2 = estimate_rels(2)
    sync()
    t1 = time.perf_counter()
    n = args.n_frames
    sw, srw = args.skip_weight, args.skip_rot_weight
    graph = graph_from_odometry(
        torch.as_tensor(rel1, dtype=torch.float32, device=device),
        loop_edges=torch.as_tensor(np.stack([np.arange(n - 2), np.arange(2, n)], -1),
                                   device=device),
        loop_measurements=torch.as_tensor(rel2, dtype=torch.float32, device=device),
        odo_weight=1.0, loop_weight=torch.tensor([sw, sw, sw, srw, srw, srw]))
    huber = args.huber if args.huber > 0 else None
    if args.two_stage:
        graph_opt, errs = optimize_pose_graph_two_stage(
            graph, rot_iters=args.gn_iters, trans_iters=args.gn_iters, huber_delta=huber)
    else:
        graph_opt, errs = optimize_pose_graph(graph, iters=args.gn_iters, huber_delta=huber)
    with no_tf32():
        fused = torch.linalg.inv(graph_opt.poses).double().cpu().numpy()
    t2 = time.perf_counter()

    gt_traj = seq.gt_trajectory()
    total = float(np.linalg.norm(np.diff(gt_traj[:, :3, 3], axis=0), axis=1).sum())
    lengths = tuple(round(total * f, 1) for f in (0.2, 0.4, 0.6))
    summary = {"n_frames": n, "traj_len": total,
               "gn_residual_first_last": [float(errs[0]), float(errs[-1])]}
    for name, traj in (("chained", chain_relative_poses(rel1[:, :3, :])), ("pose_graph", fused)):
        export_poses_kitti(traj, os.path.join(args.out, f"trajectory_{name}.txt"))
        summary[name] = evaluate_sequence(gt_traj, traj, align="scale", lengths=lengths)
    export_poses_kitti(gt_traj, os.path.join(args.out, "trajectory_gt.txt"))
    summary.update(sweep_seconds=t1 - t0, fusion_seconds=t2 - t1, device=str(device))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
