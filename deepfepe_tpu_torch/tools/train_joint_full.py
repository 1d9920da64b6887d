"""Full-pipeline (SuperPoint frontend + DeepF solver) staged training.

    python -m deepfepe_tpu_torch.tools.train_joint_full --sp SP.msgpack
        [--deepf DEEPF.msgpack] --out logs/joint_full
        [--stage1_iters 2000] [--stage2_iters 2000] [--batch 8] [--gauss2]
        [--image 120 160] [--npts 200] [--qt] [--clamp_quantile 0.7]
        [--bn_mode train|frozen] [--bn_recalib N] [--save_every N]
        [--device cuda|cpu]

Counterpart of the JAX package's `tools/train_joint_full.py`, with its
flags and its `metrics.jsonl` records: the reference's end-to-end recipe.
Stage 1 (`stage1_frozen_sp`) trains the solver with SuperPoint frozen,
stage 2 (`stage2_end_to_end`) both nets (`train.joint.joint_train_step`:
the update guard skips both updates, Adam's state included, and restores
the BatchNorm buffers). Two Adams at `--lr_deepf` and `--lr_sp`, each
clipped to `--grad_clip` by its own global norm (optax's rule); their
state and the global step count carry across the stages. The qt clamps
are the fixed (0.1, 0.5), the curriculum (`--clamp_curriculum`) or one
quantile-tied scheduler over both stages (`--clamp_quantile` with
`--qt`). `--bn_recalib` runs train-mode BatchNorm forwards before stage 2
(a BatchNorm net in `--bn_mode train` only).

Data: textured synthetic pairs with exact geometry (`SyntheticImagePairs`,
the JAX tool's seeds: 0 for the weights' first batch and the
recalibration, 1000-1002 for three host threads that render the training
batches into a queue of 6, 777 for the evaluation). `evaluate` reports
the median err_q / err_t of the solver and of RANSAC on the same
SuperPoint matches, the mean match count and the share of matches within
1 px of the ground-truth epipolar lines; its RANSAC draws come from a
generator seeded 3 at `eval_init` and from seeds split off 3 after each
stage (`split`), the pattern of the JAX tool's PRNGKey(3).

Weights: `--sp` and `--deepf` take a flax `.msgpack` or a `.pth.tar`
(seeded nets without them). Checkpoints deepF_<tag>.pth.tar and
superPoint_<tag>.pth.tar (the reference's layout) at each stage's end and
every `--save_every` steps (tag <stage>_it<N>). On the card the frontend
takes K5 (bf16 with `--gauss2`) and K4; a train-mode BatchNorm step takes
the module forward (no K5).

`main` returns {'records': every record, 'stages': each stage's steps,
seconds (host clock, ending in a synchronize) and pairs/s}; `on_stage(name)`
(after each stage's synchronize and after each evaluation) is a hook for a
caller that reads kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from ..data import SyntheticImagePairs
from ..eval import val_rt_batch
from ..frontend import get_matches_from_sp
from ..geometry import sym_epi_dist
from ..ops.conv import step_convs
from ..train import save_checkpoint
from ..train.clamp import QuantileClampScheduler
from ..train.config import qt_clamps
from ..train.joint import joint_eval_step, joint_train_step, make_joint_state
from ..utils.device import batch_to_device, resolve_device
from ..utils.weights import save_superpoint
from .sp_pipeline import frontend_params, load_frontend, load_solver, solver_config

IMG = (120, 160)
NPTS = 200
EVAL_PAIRS = 8  # pairs an evaluation batch, as in the JAX tool
QUEUE = 6
WORKER_SEEDS = (1000, 1001, 1002)


def split(seed: int) -> tuple:
    """Two seeds drawn from a generator seeded `seed` (jax.random.split's
    place)."""
    a, b = torch.randint(2 ** 62, (2,), generator=torch.Generator().manual_seed(seed)).tolist()
    return a, b


def evaluate(deepf_net, sp_net, fp, cfg, ds_eval, batches: int, generator, device) -> dict:
    """Median err_q / err_t of the solver and of RANSAC on the same
    SuperPoint matches, mean match count and the share of matches with a
    squared symmetric epipolar distance under 1 px², over `batches` batches
    of EVAL_PAIRS pairs of `ds_eval`."""
    eq, et, eqb, etb, nmatch, inl = [], [], [], [], [], []
    for _ in range(batches):
        b = batch_to_device(ds_eval.batch(EVAL_PAIRS), device)
        m = joint_eval_step(deepf_net, sp_net, b, fp, cfg)
        with torch.no_grad():
            rt = val_rt_batch(m["E_ests"], b["Ks"], m["matches_xy"], b["E_gts"],
                              b["delta_Rtijs_4_4"], generator=generator)
            d = sym_epi_dist(b["F_gts"], m["matches_xy"][..., :2], m["matches_xy"][..., 2:])
        for out, k in ((eq, "err_q_est"), (et, "err_t_est"), (eqb, "err_q_base"),
                       (etb, "err_t_base")):
            out.append(rt[k].cpu().numpy())
        nmatch.append(float(m["num_matches"]))
        inl.append(float((d < 1.0).float().mean()))
    return {
        "median_err_q": round(float(np.median(np.concatenate(eq))), 4),
        "median_err_t": round(float(np.median(np.concatenate(et))), 4),
        "median_err_q_ransac": round(float(np.median(np.concatenate(eqb))), 4),
        "median_err_t_ransac": round(float(np.median(np.concatenate(etb))), 4),
        "mean_num_matches": round(float(np.mean(nmatch)), 1),
        "gt_epi_inlier_1px": round(float(np.mean(inl)), 4),
    }


class BatchThreads:
    """Host threads rendering training batches into a bounded queue (the
    JAX tool's prefetch: rendering is numpy, which releases the GIL)."""

    def __init__(self, make_ds, batch: int, depth: int = QUEUE):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()

        def _worker(wseed):
            wds = make_ds(wseed)
            while not self.stop.is_set():
                try:
                    self.q.put(wds.batch(batch), timeout=1.0)
                except queue.Full:
                    continue

        self.workers = [threading.Thread(target=_worker, args=(s,), daemon=True)
                        for s in WORKER_SEEDS]
        for w in self.workers:
            w.start()

    def get(self) -> dict:
        return self.q.get()

    def close(self) -> None:
        self.stop.set()
        for w in self.workers:
            w.join()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sp", default="", help="pretrained SP (.msgpack or .pth.tar; '' = seeded)")
    ap.add_argument("--deepf", default="", help="optional DeepF (.msgpack or .pth.tar)")
    ap.add_argument("--out", default="logs/joint_full")
    ap.add_argument("--stage1_iters", type=int, default=2000)
    ap.add_argument("--stage2_iters", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr_deepf", type=float, default=1e-4)
    ap.add_argument("--lr_sp", type=float, default=1e-6)
    ap.add_argument("--grad_clip", type=float, default=1.0,
                    help="global-norm gradient clip of each net (0 disables)")
    ap.add_argument("--eval_batches", type=int, default=6)
    ap.add_argument("--image", type=int, nargs=2, default=list(IMG))
    ap.add_argument("--npts", type=int, default=NPTS)
    ap.add_argument("--t_scale", type=float, default=0.15)
    ap.add_argument("--depths", type=float, nargs="+", default=[6.0, 12.0])
    ap.add_argument("--depth_jitter", type=float, default=0.0)
    ap.add_argument("--n_blobs", type=int, default=60)
    ap.add_argument("--n_corners", type=int, default=0)
    ap.add_argument("--conf", type=float, default=0.010)
    ap.add_argument("--nn_thresh", type=float, default=0.9)
    ap.add_argument("--clamp_at", type=float, default=0.02, help="F-loss residual clamp")
    ap.add_argument("--qt", action="store_true",
                    help="train with the pose (q, t) loss instead of the F-loss")
    ap.add_argument("--balance_q", type=float, default=1.0)
    ap.add_argument("--balance_t", type=float, default=1.0)
    ap.add_argument("--gauss2", action="store_true",
                    help="SuperPointNetGauss2 bf16 frontend (BN on running stats)")
    ap.add_argument("--clamp_curriculum", action="store_true",
                    help="the reference qt-clamp curriculum (config.qt_clamps) instead of "
                         "fixed (0.1, 0.5)")
    ap.add_argument("--clamp_iter1", type=int, default=3000)
    ap.add_argument("--clamp_iter2", type=int, default=6000)
    ap.add_argument("--clamp_quantile", type=float, default=0.0,
                    help=">0 (with --qt) enables the quantile-tied clamp scheduler "
                         "(train/clamp.py); overrides --clamp_curriculum")
    ap.add_argument("--clamp_headroom", type=float, default=1.5)
    ap.add_argument("--clamp_check_every", type=int, default=50)
    ap.add_argument("--clamp_q0", type=float, default=0.1)
    ap.add_argument("--clamp_t0", type=float, default=0.5)
    ap.add_argument("--save_every", type=int, default=0,
                    help="also checkpoint every N iters inside a stage (tag <stage>_it<N>)")
    ap.add_argument("--bn_recalib", type=int, default=0,
                    help="before the end-to-end stage, N buffer-only train-mode BN forwards")
    ap.add_argument("--bn_mode", default="train", choices=["train", "frozen"],
                    help="BatchNorm while SP trains end-to-end: 'train' (batch statistics, "
                         "momentum buffer updates) or 'frozen' (running statistics)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    return ap


def main(argv=None, on_stage=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    img = tuple(args.image)
    os.makedirs(args.out, exist_ok=True)
    mf = open(os.path.join(args.out, "metrics.jsonl"), "a")
    records = []

    def log(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    cfg = solver_config(args.npts, args.batch, img)
    cfg.model.clamp_at = args.clamp_at
    cfg.training.clamp_iter1 = args.clamp_iter1
    cfg.training.clamp_iter2 = args.clamp_iter2
    if args.qt:
        cfg.model.if_qt_loss = True
        cfg.model.balance_q = args.balance_q
        cfg.model.balance_t = args.balance_t

    mk = dict(image_size=img, focal=140.0 * img[1] / 160.0, t_scale=args.t_scale,
              depths=tuple(args.depths), depth_jitter=args.depth_jitter,
              n_blobs=args.n_blobs, n_corners=args.n_corners)
    ds = SyntheticImagePairs(**mk, seed=0)
    ds_eval = SyntheticImagePairs(**mk, seed=777)
    # The JAX tool draws one batch to initialize its parameters.
    ds.batch(args.batch)
    sp_net = load_frontend(args.sp, device, gauss2=args.gauss2)
    deepf_net = load_solver(cfg, args.deepf, device)
    fp = frontend_params(args.npts, args.conf, args.nn_thresh)
    state = make_joint_state(deepf_net, sp_net, cfg, lr_deepf=args.lr_deepf, lr_sp=args.lr_sp,
                             grad_clip=args.grad_clip)

    def save(tag):
        save_checkpoint(os.path.join(args.out, f"deepF_{tag}.pth.tar"), deepf_net,
                        state.opt_deepf, global_it)
        save_superpoint(os.path.join(args.out, f"superPoint_{tag}.pth.tar"), sp_net, global_it,
                        state.opt_sp)

    def hook_stage(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if on_stage is not None:
            on_stage(name)

    key = 3
    global_it = 0
    # One scheduler across stages: the clamps carry over.
    sched = None
    if args.clamp_quantile > 0 and args.qt:
        sched = QuantileClampScheduler(q0=args.clamp_q0, t0=args.clamp_t0,
                                       quantile=args.clamp_quantile,
                                       headroom=args.clamp_headroom,
                                       check_every=args.clamp_check_every)
    log({"stage": "eval_init",
         **evaluate(deepf_net, sp_net, fp, cfg, ds_eval, args.eval_batches,
                    torch.Generator().manual_seed(key), device)})
    hook_stage("eval_init")

    stages = {}
    has_bn = any(True for _ in sp_net.buffers())
    for stage, iters, train_sp in (("stage1_frozen_sp", args.stage1_iters, False),
                                   ("stage2_end_to_end", args.stage2_iters, True)):
        if iters == 0:
            continue
        if train_sp and args.bn_recalib > 0 and args.bn_mode == "train" and has_bn:
            nm = -1.0
            for _ in range(args.bn_recalib):
                imgs = torch.as_tensor(ds.batch(args.batch)["imgs_grey"], device=device)
                with torch.no_grad(), step_convs(sp_net):
                    out = get_matches_from_sp(sp_net, (imgs[:, 0], imgs[:, 1]), fp,
                                              bn_train=True)
                nm = float(out["valid"].sum()) / imgs.shape[0]
            log({"stage": f"bn_recalib_before_{stage}", "iters": args.bn_recalib,
                 "train_mode_matches": round(nm, 1)})
            hook_stage(f"bn_recalib_before_{stage}")
        threads = BatchThreads(lambda s: SyntheticImagePairs(**mk, seed=s), args.batch)
        t0, perf0 = time.time(), time.perf_counter()
        skipped = 0
        qc, tc = 0.1, 0.5
        try:
            for it in range(iters):
                b = batch_to_device(threads.get(), device)
                if sched is not None:
                    qc, tc = sched.clamps
                elif args.clamp_curriculum:
                    qc, tc = qt_clamps(cfg.training, global_it)
                m = joint_train_step(state, b, fp, cfg, qc, tc, train_deepf=True,
                                     train_sp=train_sp, bn_mode=args.bn_mode)
                global_it += 1
                if args.save_every > 0 and (it + 1) % args.save_every == 0:
                    save(f"{stage}_it{it + 1}")
                skipped += int(float(m["skipped_update"]))
                if sched is not None:
                    sched.update(m["q_l2_final"].cpu().numpy(), m["t_l2_final"].cpu().numpy())
                if it % 100 == 0 or it == iters - 1:
                    log({"stage": stage, "iter": it,
                         "loss": round(float(m["loss"]), 6),
                         "q_clamp": round(qc, 5), "t_clamp": round(tc, 5),
                         "num_matches": round(float(m["num_matches"]), 1),
                         "skipped_total": skipped,
                         **({"clamp_tightenings": sched.n_tightenings,
                             "clamp_loosenings": sched.n_loosenings}
                            if sched is not None else {}),
                         "g_deepf": round(float(m["g_deepf_norm"]), 3),
                         "g_sp": round(float(m["g_sp_norm"]), 3),
                         "elapsed_s": round(time.time() - t0, 1)})
        finally:
            threads.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sec = time.perf_counter() - perf0
        stages[stage] = {"steps": iters, "seconds": sec, "pairs_per_s": iters * args.batch / sec,
                         "skipped": skipped}
        hook_stage(stage)
        save(stage)
        key, sub = split(key)
        log({"stage": f"eval_after_{stage}",
             **evaluate(deepf_net, sp_net, fp, cfg, ds_eval, args.eval_batches,
                        torch.Generator().manual_seed(sub), device)})
        hook_stage(f"eval_after_{stage}")
    mf.close()
    return {"records": records, "stages": stages}


if __name__ == "__main__":
    main()
