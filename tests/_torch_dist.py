"""Worlds of CPU ranks (gloo) for the port's parallel tests.

Imported by `tests/test_torch_{parallel,distributed_ba,dist_ckpt}.py` for
the shared inputs, and run as a script, once per rank:

    python tests/_torch_dist.py SUITE OUT_DIR --rank R --world N --coordinator HOST:PORT

Each suite runs its cases in one world and every rank writes its results
to OUT_DIR/rank<R>.pt; the tests hold them against the JAX package (and
the port on one process) in the pytest process. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from deepfepe_tpu_torch.data import SyntheticPairs  # noqa: E402
from deepfepe_tpu_torch.loader import model_loader  # noqa: E402
from deepfepe_tpu_torch.parallel.spawn import run_world  # noqa: E402
from deepfepe_tpu_torch.train.config import config_from_dict  # noqa: E402

SIZE = (376, 1241)
N, B = 128, 4
TIMEOUT = 300.0


# ---- shared inputs (numpy seeds) ----

def solver_cfg_dict(mode: str = "F", depth: int = 3, sample: bool = False) -> dict:
    return {"data": {"good_num": N, "batch_size": B},
            "model": {"depth": depth, "if_quality": True, "if_qt_loss": mode == "qt",
                      "if_sample_loss": sample, "mlp_dtype": "float32"},
            "training": {"seed": 0, "learning_rate": 1e-4}}


def solver_cfg(mode: str = "F", depth: int = 3, sample: bool = False):
    return config_from_dict(solver_cfg_dict(mode, depth, sample))


def solver_batch(seed: int = 2, n: int = B):
    return SyntheticPairs(image_size=SIZE, good_num=N, seed=seed).batch(n)


def solver_net(cfg, device="cpu", seed: int = 0, dtype=torch.float32):
    """Seeded DeepFNet with sign-canonical null vectors (eigh signs differ
    between the packages' solvers), its parameters in `dtype` (the MLPs
    compute in it too)."""
    net = model_loader(cfg, torch.device(device), torch.Generator().manual_seed(seed), train=True)
    net.sign_canonical = True
    if dtype != torch.float32:
        net.to(dtype)
        for est in (net.input_weights, net.update_weights):
            est.dtype = dtype
    return net


def as64(batch: dict) -> dict:
    """The batch's floating arrays in float64."""
    return {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()}


def nshard_inputs(seed: int = 5, b: int = 3, n: int = 256):
    """Homogeneous pixel points [b, n, 3] of both views and softmax weights."""
    batch = SyntheticPairs(image_size=SIZE, good_num=n, seed=seed).batch(b)
    pts = batch["matches_xy_ori"].astype(np.float32)
    ones = np.ones(pts.shape[:-1] + (1,), np.float32)
    rng = np.random.RandomState(seed)
    z = rng.randn(b, n) * 0.5
    w = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return (np.concatenate([pts[..., :2], ones], -1), np.concatenate([pts[..., 2:4], ones], -1),
            w)


def sp_inputs(seed: int = 7, pairs: int = 4, size=(24, 32)):
    """Grey frames [2 pairs, H, W] (frame 1 of every pair, then frame 2, as
    the joint step stacks them) and fixed cotangents for semi and desc."""
    rng = np.random.RandomState(seed)
    H, W = size
    frames = rng.rand(2, pairs, H, W)
    c_semi = rng.randn(2, pairs, H // 8, W // 8, 65)
    c_desc = rng.randn(2, pairs, H // 8, W // 8, 256)
    return frames, c_semi, c_desc


def ba_problem(seed: int = 0, C: int = 3, P: int = 64, perturb: float = 0.2,
               noise_px: float = 0.5):
    """A BA problem as tests/test_ba.py builds it (camera chain, points in
    front, noisy observations, perturbed start), float64 numpy arrays:
    (poses [C, 4, 4], points [P, 3], obs [C, P, 2], vis [C, P], K)."""
    from deepfepe_tpu_torch.geometry.lie import se3_exp

    rng = np.random.RandomState(seed)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    X = np.stack([rng.uniform(-5, 5, P), rng.uniform(-3, 3, P), rng.uniform(8, 20, P)], -1)
    poses = [np.eye(4)]
    for _ in range(C - 1):
        tw = np.concatenate([rng.randn(3) * 0.5, rng.randn(3) * 0.05])
        poses.append(se3_exp(torch.as_tensor(tw)).numpy() @ poses[-1])
    poses = np.stack(poses)
    obs = np.zeros((C, P, 2))
    for c in range(C):
        Xc = X @ poses[c][:3, :3].T + poses[c][:3, 3]
        obs[c] = ((Xc / Xc[:, 2:3]) @ K.T)[:, :2] + rng.randn(P, 2) * noise_px
    X0 = X + rng.randn(P, 3) * perturb
    p0 = poses.copy()
    for c in range(1, C):
        p0[c] = se3_exp(torch.as_tensor(rng.randn(6) * perturb * 0.1)).numpy() @ p0[c]
    return p0, X0, obs, np.ones((C, P)), K


def pose_graph_inputs(seed: int = 1, n: int = 7):
    """Noisy odometry [n-1, 4, 4] and the loop edge's measurement [4, 4]
    (float32), as tests/test_ba.py's pose-graph parity builds them."""
    from deepfepe_tpu_torch.geometry.lie import se3_exp

    rng = np.random.RandomState(seed)
    tw = np.concatenate([rng.randn(n - 1, 3) * 0.5, rng.randn(n - 1, 3) * 0.1], -1)
    rels = se3_exp(torch.as_tensor(tw, dtype=torch.float64)).numpy()
    acc = [np.eye(4)]
    for r in rels:
        acc.append(r @ acc[-1])
    noise = se3_exp(torch.as_tensor(rng.randn(n - 1, 6) * 0.05)).numpy()
    return (noise @ rels).astype(np.float32), (acc[-1] @ np.linalg.inv(acc[0])).astype(np.float32)


# ---- worlds ----

class World:
    """A world of `n` ranks running `suite` in a background thread; `result`
    waits for it and returns every rank's results."""

    def __init__(self, suite: str, n: int, timeout: float = TIMEOUT):
        self.dir = tempfile.mkdtemp(prefix=f"torch_dist_{suite}_")
        self.n = n
        self.error = None
        argv = lambda r, c: [sys.executable, os.path.abspath(__file__), suite, self.dir,  # noqa
                             "--rank", str(r), "--world", str(n), "--coordinator", c]

        def run():
            try:
                run_world(argv, n, timeout, cwd=self.dir)
            except Exception as e:  # noqa: BLE001 - re-raised in result()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self) -> list:
        self.thread.join()
        try:
            if self.error is not None:
                raise self.error
            return [torch.load(os.path.join(self.dir, f"rank{r}.pt"), weights_only=False)
                    for r in range(self.n)]
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def _np(t):
    return t.detach().cpu().numpy()


def _grads(net) -> dict:
    return {k: _np(p.grad) for k, p in net.named_parameters()}


def _full_grads(mesh, net) -> dict:
    from deepfepe_tpu_torch.parallel import tp

    names = tp.sharded_names(net)
    return {k: _np(tp.gather_full(mesh, p.grad) if k in names else p.grad)
            for k, p in net.named_parameters()}


def suite_parallel(rank: int, world: int) -> dict:
    from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
    from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint, sync_batch_norm
    from deepfepe_tpu_torch.parallel import (MODEL_AXIS, make_mesh, make_nsharded_fit, shard,
                                             shard_batch)
    from deepfepe_tpu_torch.parallel.mesh import gather_rows
    from deepfepe_tpu_torch.parallel.tp import full_state_dict, shard_params_tp
    from deepfepe_tpu_torch.tools import dryrun_multichip
    from deepfepe_tpu_torch.train import Trainer, load_checkpoint, make_optimizer, train_step

    out = {}
    dp = make_mesh(4, 1, "cpu")
    for name, mode, sample, f64 in (("dp_F64", "F", False, True), ("dp_qt64", "qt", False, True),
                                    ("dp_sample", "F", True, False)):
        cfg = solver_cfg(mode, depth=2 if sample else 3, sample=sample)
        net = solver_net(cfg, dtype=torch.float64 if f64 else torch.float32)
        trainer = Trainer(net, cfg, mesh=dp)
        batch = as64(solver_batch()) if f64 else solver_batch()
        m = train_step(net, trainer.opt, shard_batch(dp, batch), cfg, 0.1, 0.5,
                       trainer.sample_generator, dp)
        out[name] = {"loss": float(m["loss"]), "grads": _grads(net)}

    tpm = make_mesh(2, 2, "cpu")
    cfg = solver_cfg("F")
    net = solver_net(cfg, dtype=torch.float64)
    trainer = Trainer(net, cfg, mesh=tpm)
    shard_params_tp(tpm, net, trainer.opt)
    losses, tb = [], shard_batch(tpm, as64(solver_batch()))
    for step in range(2):
        m = train_step(net, trainer.opt, tb, cfg, 0.1, 0.5, trainer.sample_generator, tpm)
        losses.append(float(m["loss"]))
        if step == 0:
            grads = _full_grads(tpm, net)
    widths = {k: tuple(p.shape) for k, p in net.named_parameters()}
    full = full_state_dict(tpm, net)
    # A tensor-parallel save: gathered whole, written by rank 0, loaded
    # strictly into a whole net with its Adam state.
    trainer.save_dir = os.getcwd()
    path = trainer.save(2)
    torch.distributed.all_reduce(torch.zeros(1))  # rank 0's file is written
    whole = solver_net(cfg, dtype=torch.float64)
    opt = make_optimizer(whole, cfg)
    load_checkpoint(path, whole, opt)
    loaded = all(torch.equal(v, full[k]) for k, v in whole.state_dict().items()) and all(
        opt.state[p]["exp_avg"].shape == p.shape for p in whole.parameters())
    out["tp"] = {"losses": losses, "grads": grads, "local_shapes": widths,
                 "full_shapes": {k: tuple(v.shape) for k, v in full.items()},
                 "checkpoint_loads_whole": loaded}

    ns = make_mesh(1, 4, "cpu")
    fit = make_nsharded_fit(ns)
    p1, p2, w = (shard(ns, torch.as_tensor(x), dim=1, axis=MODEL_AXIS) for x in nshard_inputs())
    res = {}
    for name, with_res in (("F", False), ("FR", True)):
        wl = w.clone().requires_grad_(True)
        F, r = fit(p1, p2, wl)
        loss = F.abs().sum() + ((r * r).sum() if with_res else 0.0)
        loss.backward()
        res[name] = _np(wl.grad)
    out["nshard"] = {"F": _np(F), "residual": _np(r), "grad_F": res["F"], "grad_FR": res["FR"]}

    frames, c_semi, c_desc = sp_inputs()
    rows = lambda a: shard(dp, torch.as_tensor(a), dim=1).flatten(0, 1)  # noqa: E731
    net = reset_superpoint(SuperPointNetGauss2(), torch.Generator().manual_seed(0)).double()
    net.train()
    with sync_batch_norm(net, dp.data_group):
        o = net(rows(frames)[..., None], bn_groups=2)
        loss = (o["semi"] * rows(c_semi)).sum() + (o["desc"] * rows(c_desc)).sum()
        loss.backward()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=dp.data_group)
    out["sync_bn"] = {"semi": _np(gather_rows(dp, o["semi"].detach().unflatten(0, (2, -1))
                                               .transpose(0, 1).contiguous())),
                      "buffers": {k: _np(v) for k, v in net.named_buffers()},
                      "grads": {k: _np(v) for k, v in grads.items()}}

    out["dryrun"] = dryrun_multichip.dryrun(world, "cpu", (64, 96))
    return out


def suite_ba(rank: int, world: int) -> dict:
    from deepfepe_tpu_torch.ba import graph_from_odometry
    from deepfepe_tpu_torch.ba.distributed import (make_distributed_ba_step,
                                                   make_distributed_pose_graph_step,
                                                   make_distributed_sqrt_ba_step,
                                                   optimize_pose_graph_two_stage_distributed,
                                                   pad_pose_graph_edges, shard_ba_inputs,
                                                   shard_edges)
    from deepfepe_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, 1, "cpu")
    out = {}
    step = make_distributed_ba_step(mesh, damping=1e-4, fix_cameras=1)
    poses, X, obs, vis, K = (torch.as_tensor(a, dtype=torch.float64) for a in ba_problem())
    p1, x1, c1 = step(poses, *shard_ba_inputs(mesh, X, obs, vis), K)
    poses, X, obs, vis, K = (torch.as_tensor(a, dtype=torch.float32) for a in ba_problem())
    pts, o, v = shard_ba_inputs(mesh, X, obs, vis)
    costs, p, x = [], poses, pts
    for _ in range(8):
        p, x, c = step(p, x, o, v, K)
        costs.append(float(c))
    out["schur"] = {"poses": _np(p1), "points": _np(x1), "cost": float(c1), "costs": costs}

    poses, X, obs, vis, K = (torch.as_tensor(a, dtype=torch.float64)
                             for a in ba_problem(seed=1, C=4, P=64))
    step = make_distributed_sqrt_ba_step(mesh, damping=1e-3)
    pts, o, v = shard_ba_inputs(mesh, X, obs, vis)
    p1, x1, c1 = step(poses, pts, o, v, K)
    out["sqrt"] = {"poses": _np(p1), "points": _np(x1), "cost": float(c1)}

    rels, loop = pose_graph_inputs()
    graph = graph_from_odometry(torch.as_tensor(rels), loop_edges=torch.tensor([[0, 6]]),
                                loop_measurements=torch.as_tensor(loop)[None], loop_weight=5.0)
    edges, meas, w6 = shard_edges(mesh, *pad_pose_graph_edges(
        graph.edges, graph.measurements, graph.weights, world))
    pstep = make_distributed_pose_graph_step(mesh, damping=1e-6)
    pg, cost = pstep(graph.poses, edges, meas, w6, torch.ones(6))
    poses2, costs = optimize_pose_graph_two_stage_distributed(mesh, graph, rot_iters=4,
                                                              trans_iters=4, damping=1e-6)
    out["pose_graph"] = {"poses": _np(pg), "cost": float(cost), "two_stage": _np(poses2),
                         "costs": _np(costs), "edges_local": int(edges.shape[0])}
    return out


def suite_ckpt(rank: int, world: int) -> dict:
    from deepfepe_tpu_torch.parallel import make_mesh
    from deepfepe_tpu_torch.parallel.tp import shard_params_tp
    from deepfepe_tpu_torch.train import Trainer
    from deepfepe_tpu_torch.train.dist_ckpt import (CheckpointManagerWrapper,
                                                    load_module_state, module_state,
                                                    restore_sharded, save_sharded)

    root = os.getcwd()
    out = {}
    cfg = solver_cfg("F", depth=2)
    net = solver_net(cfg)
    sp = {"conv": torch.ones(3, 3, 1, 8)}
    comps = {"deepF": {"params": net.state_dict(), "n_iter": 7}, "superPoint": sp}
    save_sharded(os.path.join(root, "c0"), comps)
    tpl = {"deepF": {"params": {k: torch.zeros_like(v) for k, v in net.state_dict().items()},
                     "n_iter": 0}}
    sub = restore_sharded(os.path.join(root, "c0"), tpl)
    both = restore_sharded(os.path.join(root, "c0"), {**tpl, "superPoint": {"conv":
                                                                            torch.zeros(3, 3, 1, 8)}})
    out["components"] = {
        "keys": sorted(sub), "n_iter": sub["deepF"]["n_iter"],
        "equal": all(torch.equal(sub["deepF"]["params"][k], v) for k, v in net.state_dict().items()),
        "sp_equal": torch.equal(both["superPoint"]["conv"], sp["conv"])}

    mesh = make_mesh(1, world, "cpu")
    net = solver_net(cfg)
    whole = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = Trainer(net, cfg, mesh=mesh)
    shard_params_tp(mesh, net, trainer.opt)
    save_sharded(os.path.join(root, "c1"), {"deepF": module_state(net, mesh)})
    files = sorted(os.listdir(os.path.join(root, "c1")))
    fresh = solver_net(cfg)
    shard_params_tp(mesh, fresh)
    state = restore_sharded(os.path.join(root, "c1"), {"deepF": {
        k: torch.zeros_like(v) for k, v in module_state(fresh, mesh).items()}})["deepF"]
    load_module_state(fresh, state, mesh)
    sharded_keys = sorted(k for k in state if "#shard" in k)
    out["tp"] = {"files": files, "sharded_keys": sharded_keys,
                 "equal": all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                                 net.state_dict().values())),
                 "whole": {k: _np(v) for k, v in whole.items()},
                 "local": {k: _np(v) for k, v in fresh.state_dict().items()}}

    mgr = CheckpointManagerWrapper(os.path.join(root, "mgr"), max_to_keep=2)
    for step in (100, 200, 300):
        mgr.save(step, {"solver": {"w": torch.full((4,), float(step))}})
    torch.distributed.all_reduce(torch.zeros(1))  # rank 0's rotation precedes the reads
    best = CheckpointManagerWrapper(os.path.join(root, "best"), max_to_keep=2,
                                    best_fn_metric="loss")
    for step, loss in ((1, 0.5), (2, 0.2), (3, 0.9), (4, 0.1)):
        best.save(step, {"solver": {"w": torch.full((4,), float(step))}}, {"loss": loss})
    torch.distributed.all_reduce(torch.zeros(1))
    out["rotation"] = {"steps": mgr.all_steps(), "latest": _np(mgr.restore_latest(
        {"solver": {"w": torch.zeros(4)}})["solver"]["w"]), "best_steps": best.all_steps()}
    return out


SUITES = {"parallel": suite_parallel, "ba": suite_ba, "ckpt": suite_ckpt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("suite", choices=SUITES)
    ap.add_argument("out")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from deepfepe_tpu_torch.parallel import init_distributed

    init_distributed("gloo", args.coordinator, args.world, args.rank)
    try:
        res = SUITES[args.suite](args.rank, args.world)
        torch.save(res, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
