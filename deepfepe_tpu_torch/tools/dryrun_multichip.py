"""Multi-rank dry run of the port's parallel surface at the flagship shapes.

Counterpart of `__graft_entry__.dryrun_multichip` (`__graft_entry__.py:50-
267`). One world of n ranks runs, in one go:

- the flagship train step (depth 5, N = 1000, if_quality, the qt loss and
  the sample loss) data-parallel, DP x TP at 4 ranks or more (the mesh
  (n/2, 2), the wide MLP layers sharded over the model group);
- the correspondence-parallel fit at N = 1000 over the model group;
- a joint gauss2 SuperPoint + DeepF step with train-mode BatchNorm
  synchronized over the data group (2 pairs a rank at 376 x 1240 by
  default), its running buffers advancing;
- 5 distributed square-root BA steps over all ranks (cost below 0.1x);
- the two-stage edge-sharded pose graph (mean r² falling);

and rank 0 prints the JAX dry run's summary line. Each rank also prints
one JSON line of its kernel launches.

    python -m deepfepe_tpu_torch.tools.dryrun_multichip 4 --backend gloo

starts the 4 ranks itself (on this machine: one card shared under gloo,
or `--device cpu`); under torchrun, or with --rank and --coordinator,
the process is one rank.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from ..ba import BAProblem, edge_residuals, graph_from_odometry, reprojection_residuals
from ..ba.bundle_adjustment import project
from ..ba.distributed import (make_distributed_sqrt_ba_step,
                              optimize_pose_graph_two_stage_distributed, shard_ba_inputs)
from ..data import SyntheticImagePairs, SyntheticPairs
from ..frontend import FrontendParams, SuperPointNetGauss2
from ..frontend.superpoint import reset_superpoint
from ..geometry.basic import homo
from ..geometry.lie import se3_exp
from ..loader import model_loader
from ..parallel.mesh import (BACKENDS, MODEL_AXIS, Mesh, init_distributed, make_mesh, shard,
                             shard_batch, shard_params)
from ..parallel.nshard import make_nsharded_fit
from ..parallel.spawn import python_module, run_world
from ..parallel.tp import shard_params_tp
from ..train import Trainer, load_checkpoint, train_step
from ..train.config import Config, config_from_dict
from ..train.joint import joint_train_step, make_joint_state

FLAGSHIP_N, FLAGSHIP_DEPTH = 1000, 5
IMAGE = (376, 1240)
PAIRS = 2  # joint-step pairs a data rank
WORLD_TIMEOUT = 600.0  # seconds for the world the tool starts
JOINT = {"depth": 2, "K": 1000, "conf_thresh": 1e-4}
MODULE = "deepfepe_tpu_torch.tools.dryrun_multichip"


def flagship_config(good_num: int = FLAGSHIP_N, depth: int = FLAGSHIP_DEPTH) -> Config:
    """The dry run's flagship: if_quality with the qt loss (the whole loss
    surface) and the sample loss, float32 MLPs on the unfused route."""
    return config_from_dict({
        "data": {"good_num": good_num, "image": {"size": [376, 1241, 3]},
                 "preprocessing": {"resize": [376, 1241]}},
        "model": {"depth": depth, "if_quality": True, "if_qt_loss": True,
                  "if_sample_loss": True, "mlp_dtype": "float32"},
        "training": {"seed": 0}})


def dp_tp_step(mesh: Mesh, cfg: Config, batch: dict, q_clamp: float = 0.1,
               t_clamp: float = 0.5, seed: int = 0, pretrained: str = ""):
    """One data-parallel (and, with n_model > 1, tensor-parallel) train step
    of a DeepFNet seeded `seed` (or read from `pretrained`) on the global
    host `batch`; returns (trainer, metrics). The gradients stay in the
    (sharded) parameters."""
    net = model_loader(cfg, mesh.device, torch.Generator().manual_seed(seed), train=True)
    if pretrained:
        load_checkpoint(pretrained, net)
    trainer = Trainer(net, cfg, mesh=mesh)
    shard_params_tp(mesh, net, trainer.opt)
    metrics = train_step(net, trainer.opt, shard_batch(mesh, batch), cfg, q_clamp, t_clamp,
                         trainer.sample_generator, mesh)
    return trainer, metrics


def nshard_inputs(batch: dict):
    """The fit's inputs from a batch: homogeneous pixel points [B, N, 3] of
    both views and uniform weights 1/N."""
    pts = torch.as_tensor(batch["matches_xy_ori"])
    w = torch.full(pts.shape[:-1], 1.0 / pts.shape[-2], dtype=pts.dtype)
    return homo(pts[..., :2]), homo(pts[..., 2:4]), w


def nshard_fit(mesh: Mesh, batch: dict):
    """The correspondence-parallel fit of this rank's data rows, its N
    shard over the model group: (F, residual shard)."""
    p1, p2, w = (shard(mesh, shard(mesh, x.to(mesh.device)), dim=1, axis=MODEL_AXIS)
                 for x in nshard_inputs(batch))
    return make_nsharded_fit(mesh)(p1, p2, w)


def joint_nets(cfg: Config, device, seed: int = 0):
    """Seeded gauss2 SuperPoint and DeepF nets for the joint step."""
    sp = reset_superpoint(SuperPointNetGauss2(), torch.Generator().manual_seed(seed)).to(device)
    deepf = model_loader(cfg, device, torch.Generator().manual_seed(seed + 1), train=True)
    return sp, deepf


def joint_config(depth: int = JOINT["depth"], K: int = JOINT["K"]) -> Config:
    return config_from_dict({
        "data": {"good_num": K},
        "model": {"depth": depth, "if_quality": True, "mlp_dtype": "float32", "if_SP": True},
        "training": {"seed": 0, "min_matches": 0}})


def joint_step(mesh: Mesh, batch: dict, train_sp: bool = True, image=IMAGE, seed: int = 0,
               conv_impl: str | None = None):
    """One data-parallel joint step on the global image `batch` (frozen
    SuperPoint when not `train_sp`: running statistics, the fused forward
    on the card; else train-mode BatchNorm synchronized over the data
    group). Returns (SuperPoint net, BN buffers before, metrics)."""
    cfg = joint_config()
    cfg.data.image_size = list(image)
    sp, deepf = joint_nets(cfg, mesh.device, seed)
    for net in (sp, deepf):
        shard_params(mesh, net)
    state = make_joint_state(deepf, sp, cfg)
    before = {k: v.clone() for k, v in sp.named_buffers() if "running_" in k}
    fp = FrontendParams(out_num_points=JOINT["K"], conf_thresh=JOINT["conf_thresh"],
                        conv_impl=conv_impl, matcher="pallas" if mesh.device.type == "cuda"
                        else None)
    metrics = joint_train_step(state, shard_batch(mesh, batch), fp, cfg, 0.1, 0.5,
                               train_sp=train_sp, mesh=mesh)
    return sp, before, metrics


def sqrt_ba_problem(n_points: int, seed: int = 3, C: int = 4):
    """The dry run's BA problem: C cameras, n_points points, exact
    observations, perturbed initial poses and points (float32)."""
    rng = np.random.RandomState(seed)
    K = torch.tensor([[200.0, 0, 64], [0, 200, 48], [0, 0, 1]])
    points = torch.as_tensor((rng.randn(n_points, 3) * [2.0, 1.5, 1.0] + [0, 0, 8.0])
                             .astype(np.float32))
    tw = np.zeros((C, 6), np.float32)
    tw[:, :3] = rng.randn(C, 3) * 0.3
    tw[:, 3:] = rng.randn(C, 3) * 0.05
    poses_gt = se3_exp(torch.as_tensor(tw))
    obs, _ = project(poses_gt, points, K)
    vis = torch.ones(obs.shape[:2])
    poses0 = se3_exp(torch.as_tensor(rng.randn(C, 6).astype(np.float32) * 0.02)) @ poses_gt
    points0 = points + torch.as_tensor(rng.randn(n_points, 3).astype(np.float32) * 0.05)
    return BAProblem(poses0, points0, obs, vis, K)


def sqrt_ba(mesh: Mesh, prob: BAProblem, iters: int = 5, damping: float = 1e-4):
    """`iters` distributed square-root steps; (cost before, cost after)."""
    prob = BAProblem(*(x.to(mesh.device) for x in prob))
    step = make_distributed_sqrt_ba_step(mesh, damping=damping)
    pts, obs, vis = shard_ba_inputs(mesh, prob.points, prob.obs, prob.vis)
    poses = prob.poses
    for _ in range(iters):
        poses, pts, _ = step(poses, pts, obs, vis, prob.K)
    parts = [torch.empty_like(pts) for _ in range(mesh.n_data)]
    torch.distributed.all_gather(parts, pts.contiguous(), group=mesh.data_group)
    r0, _ = reprojection_residuals(prob)
    r1, _ = reprojection_residuals(prob._replace(poses=poses, points=torch.cat(parts)))
    return float((r0 * r0).sum()), float((r1 * r1).sum())


def pose_graph_problem(n_frames: int = 10, seed: int = 4):
    """A noisy odometry chain with one loop edge (weight 10)."""
    rng = np.random.RandomState(seed)
    tw = np.zeros((n_frames - 1, 6), np.float32)
    tw[:, :3] = rng.randn(n_frames - 1, 3) * 0.5
    tw[:, 3:] = rng.randn(n_frames - 1, 3) * 0.1
    rels = se3_exp(torch.as_tensor(tw))
    acc = [torch.eye(4)]
    for r in rels:
        acc.append(r @ acc[-1])
    noise = se3_exp(torch.as_tensor(rng.randn(n_frames - 1, 6).astype(np.float32) * 0.03))
    return graph_from_odometry(noise @ rels, loop_edges=torch.tensor([[0, n_frames - 1]]),
                               loop_measurements=(acc[-1] @ torch.linalg.inv(acc[0]))[None],
                               loop_weight=10.0)


def pose_graph(mesh: Mesh, graph, iters: int = 5):
    """The two-stage distributed solve; (mean r² before, after)."""
    graph = graph._replace(**{k: v.to(mesh.device) for k, v in graph._asdict().items()})
    poses, _ = optimize_pose_graph_two_stage_distributed(mesh, graph, rot_iters=iters,
                                                         trans_iters=iters)
    r0 = edge_residuals(graph.poses, graph.edges, graph.measurements)
    r1 = edge_residuals(poses, graph.edges, graph.measurements)
    return float((r0 ** 2).mean()), float((r1 ** 2).mean())


def kernel_launches() -> dict:
    """The port's kernel wrappers' launch counts in this process."""
    from ..ops.conv import conv3x3_affine_relu, conv3x3_affine_relu_bwd
    from ..ops.eigh9 import eigh9
    from ..ops.epi_residual import epi_residual, epi_residual_bwd
    from ..ops.matcher import mutual_nn_kernel

    return {"eigh9": eigh9.launches, "epi_residual": epi_residual.launches,
            "epi_residual_bwd": epi_residual_bwd.launches,
            "mutual_nn_kernel": mutual_nn_kernel.launches,
            "conv3x3_affine_relu": conv3x3_affine_relu.launches,
            "conv3x3_affine_relu_bwd": conv3x3_affine_relu_bwd.launches}


def dryrun(n: int, device=None, image=IMAGE) -> str:
    """Every piece on this rank of an initialized world of n; returns the
    summary line."""
    n_model = 2 if n >= 4 else 1
    n_data = n // n_model
    mesh = make_mesh(n_data, n_model, device)
    batch = SyntheticPairs(good_num=FLAGSHIP_N, seed=0).batch(n_data)
    _, metrics = dp_tp_step(mesh, flagship_config(), batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite flagship loss {loss}")

    nshard = "skipped"
    if n_model > 1:
        F, _ = nshard_fit(mesh, batch)
        if not torch.isfinite(F).all():
            raise RuntimeError("the N-sharded fit is not finite")
        nshard = f"N={FLAGSHIP_N} ok"

    jbatch = SyntheticImagePairs(image_size=tuple(image), seed=1).batch(n_data * PAIRS)
    sp, before, jm = joint_step(mesh, jbatch, image=image)
    jloss = float(jm["loss"])
    if not math.isfinite(jloss):
        raise RuntimeError(f"non-finite joint loss {jloss}")
    after = dict(sp.named_buffers())
    if not all(not torch.equal(before[k], after[k]) for k in before):
        raise RuntimeError("train-mode BN buffers did not advance under the mesh")

    ba_mesh = make_mesh(n, 1, device)
    c0, c1 = sqrt_ba(ba_mesh, sqrt_ba_problem(8 * n))
    if not (math.isfinite(c1) and c1 < 0.1 * c0):
        raise RuntimeError(f"distributed sqrt-BA did not converge: {c0} -> {c1}")
    r0, r1 = pose_graph(ba_mesh, pose_graph_problem())
    if not (math.isfinite(r1) and r1 < r0):
        raise RuntimeError(f"distributed pose graph did not improve: {r0} -> {r1}")
    return (f"dryrun_multichip({n}): mesh=({n_data}x{n_model}) "
            f"flagship(depth={FLAGSHIP_DEPTH},N={FLAGSHIP_N},sample_loss,qt) loss={loss:.6f} "
            f"nshard[{nshard}] joint_sp loss={jloss:.6f} "
            f"sqrt_ba ok (cost {c0:.3f}->{c1:.5f}, {n}-shard TSQR) "
            f"pose_graph ok (mean r^2 {r0:.5f}->{r1:.5f}, edge-sharded two-stage) ok")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    ap.add_argument("--image", type=int, nargs=2, default=list(IMAGE))
    ap.add_argument("--rank", type=int, default=None, help="run as this rank (else start "
                    "all n, or take torchrun's environment)")
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    if args.rank is None and "WORLD_SIZE" not in os.environ:
        extra = ["--backend", args.backend, "--image", *map(str, args.image)] + (
            ["--device", args.device] if args.device else [])
        outs = run_world(lambda r, c: python_module(MODULE, str(args.n), *extra, "--rank",
                                                    str(r), "--coordinator", c),
                         args.n, WORLD_TIMEOUT)
        lines = [ln for out in outs for ln in out.splitlines()]
        print("\n".join([ln for ln in lines if ln.startswith('{"rank"')]
                        + [ln for ln in lines if ln.startswith("dryrun_multichip(")]), flush=True)
        return 0
    rank, world = (init_distributed(args.backend, args.coordinator, args.n, args.rank)
                   if args.coordinator else init_distributed(args.backend))
    try:
        summary = dryrun(world, args.device, tuple(args.image))
        print(json.dumps({"rank": rank, "launches": kernel_launches()}), flush=True)
        if rank == 0:
            print(summary, flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
