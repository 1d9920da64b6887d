"""Full SuperPoint pretraining: the detector stage (MagicPoint recipe), the
joint detector + descriptor stage on homography-warped pairs, optional
homographic adaptation, and a frontend evaluation.

    python -m deepfepe_tpu_torch.tools.train_sp_full --out experiments/sp_full
        [--det_iters 4000] [--joint_iters 16000] [--batch 32] [--pool 3000]
        [--lr 1e-3] [--desc_weight 1e-4] [--ha_iters 0] [--ha_images 256]
        [--ha_homographies 24] [--ha_conf 0.015] [--resume ckpt]
        [--save_every 1000] [--seed 0] [--device cuda|cpu]

Counterpart of the JAX package's `tools/train_sp_full.py`, with its flags,
its numpy draws (the same seeds give the same images, labels and
homographies) and its `metrics.jsonl` records. SuperPointNet at full width
on 120x160 `SyntheticShapes`; one Adam (optax's defaults) through every
stage. The second view of a joint batch is warped on the device inside
the step (`frontend.train_sp.make_warped_joint_train_step`). Stage C
(`--ha_iters` > 0) aggregates the detector over `--ha_homographies`
random views of `--ha_images` textured renders (`SyntheticImagePairs`,
seed 99) into pseudo-labels, then fine-tunes the detector on batches half
pseudo-labelled, half fresh shape renders. `final_eval` scores the
frontend's matches against gt epipolar geometry on 8 synthetic pairs.

Weights start seeded (`--seed`) or from `--resume`: a `.pth.tar` this
tool wrote or a flax `.msgpack`. Checkpoints are the reference's
`.pth.tar` (`utils.weights.save_superpoint`): sp_det_<it>, sp_det_final,
sp_joint_<it>, sp_joint_final, sp_final under `--out`. The train steps
take the module forward; `final_eval` takes the frontend's, whose fused
route launches K5 on the card under DEEPFEPE_SP_CONV_IMPL=pallas.

Prints each record as a JSON line; `main` returns {'stages': each stage's
steps, images, seconds and images/s (host clock, ending in a
synchronize), 'final_eval': the last record, 'checkpoint'}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data import SyntheticImagePairs
from ..eval import frontend_epidist_eval
from ..frontend import FrontendParams, SuperPointNet
from ..frontend.superpoint import reset_superpoint
from ..frontend.train_sp import (SyntheticShapes, adam, heatmap_to_cells, homographic_adaptation,
                                 make_detector_train_step, make_warped_joint_train_step,
                                 sample_homography, warp_labels)
from ..utils.device import resolve_device
from ..utils.weights import save_superpoint, superpoint_state_from_file


def build_pool(ds: SyntheticShapes, n: int):
    t0 = time.time()
    pool = ds.pool(n)
    print(f"rendered pool of {n} images in {time.time() - t0:.1f}s", flush=True)
    return pool


def batch_from_pool(ds, pool, rng, batch_size, with_warp):
    """pool None: fresh renders every batch (no reuse: a 4000-image pool
    reused for 64 epochs overfits the detector to the shapes' rendering)."""
    if pool is None:
        items = [ds.sample() for _ in range(batch_size)]
    else:
        items = [pool[i] for i in rng.randint(0, len(pool), batch_size)]
    out = {"image": np.stack([it[0] for it in items]),
           "cells": np.stack([ds.corners_to_cells(it[1]) for it in items])}
    if with_warp:
        Hs, cells2 = [], []
        for it in items:
            Hm = sample_homography(rng, (ds.H, ds.W))
            Hs.append(Hm)
            cells2.append(ds.corners_to_cells(warp_labels(it[1], Hm, (ds.H, ds.W))))
        out["H"] = np.stack(Hs)
        out["cells2"] = np.stack(cells2)
    return out


def final_eval(net, seed: int = 5, device=None) -> dict:
    """Frontend match quality against gt epipolar geometry: 8 synthetic
    pairs at 120x160, K = 200 (the JAX tool's protocol)."""
    device = device or next(net.parameters()).device
    s = SyntheticImagePairs(image_size=(120, 160), seed=seed).batch(8)
    imgs = torch.as_tensor(s["imgs_grey"], device=device)
    fp = FrontendParams(out_num_points=200, conf_thresh=0.010, nn_thresh=0.8)
    r = frontend_epidist_eval(net, (imgs[:, 0], imgs[:, 1]),
                              torch.as_tensor(s["F_gts"], device=device), fp)
    return {"num_matches": float(np.mean(r["num_matches"])),
            **{k: float(np.mean(v)) for k, v in r.items() if k.startswith("ratio")}}


class _Stage:
    """Host-clock seconds of a stage's steps, ending in a synchronize, and
    the caller's `on_stage(name)` after it."""

    def __init__(self, name: str, device, on_stage=None):
        self.name, self.device, self.on_stage = name, device, on_stage
        self.t0 = time.time()
        self.perf0 = time.perf_counter()

    def elapsed(self) -> float:
        return round(time.time() - self.t0, 1)

    def done(self, steps: int, images: int) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        sec = time.perf_counter() - self.perf0
        if self.on_stage is not None:
            self.on_stage(self.name)
        return {"steps": steps, "images": images, "seconds": sec,
                "images_per_s": images / sec if sec > 0 else None}


def main(argv=None, on_step=None, on_stage=None) -> dict:
    """The tool; `on_step(stage, it, out)` gets each train step's output
    (0-d tensors, left on the device) and `on_stage(name)` runs as each
    stage ends, after its synchronize: hooks for a caller that reads
    per-step losses or kernel launch counts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="experiments/sp_full")
    ap.add_argument("--det_iters", type=int, default=4000)
    ap.add_argument("--joint_iters", type=int, default=16000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--pool", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--desc_weight", type=float, default=1e-4)
    ap.add_argument("--ha_iters", type=int, default=0)
    ap.add_argument("--ha_images", type=int, default=256)
    ap.add_argument("--ha_homographies", type=int, default=24)
    ap.add_argument("--ha_conf", type=float, default=0.015)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    mf = open(os.path.join(args.out, "metrics.jsonl"), "a")

    def log(rec):
        print(json.dumps(rec), flush=True)
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    net = reset_superpoint(SuperPointNet(), torch.Generator().manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    ds = SyntheticShapes(seed=args.seed + 1)
    if args.resume:
        net.load_state_dict(superpoint_state_from_file(args.resume), strict=True)
        print(f"resumed from {args.resume}", flush=True)
    net = net.to(device).eval()
    opt = adam(net, args.lr)
    pool = build_pool(ds, args.pool) if args.pool > 0 else None
    stages = {}
    last = {"loss": 0.0}

    def save(tag, n_iter):
        path = os.path.join(args.out, f"sp_{tag}.pth.tar")
        save_superpoint(path, net, n_iter, opt, last["loss"])
        return path

    def hook(stage, it, out):
        if on_step is not None:
            on_step(stage, it, out)

    det_step = make_detector_train_step(net, opt)
    clock = _Stage("det", device, on_stage)
    for it in range(args.det_iters):
        loss = det_step(batch_from_pool(ds, pool, rng, args.batch, with_warp=False))
        hook("det", it, loss)
        if it % 100 == 0 or it == args.det_iters - 1:
            last["loss"] = float(loss)
            log({"stage": "det", "iter": it, "loss": last["loss"], "elapsed_s": clock.elapsed()})
        if it and it % args.save_every == 0:
            save(f"det_{it}", it)
    stages["det"] = clock.done(args.det_iters, args.det_iters * args.batch)
    if args.det_iters:
        save("det_final", args.det_iters)

    joint_step = make_warped_joint_train_step(net, opt, args.desc_weight)
    clock = _Stage("joint", device, on_stage)
    for it in range(args.joint_iters):
        m = joint_step(batch_from_pool(ds, pool, rng, args.batch, with_warp=True))
        hook("joint", it, m)
        if it % 100 == 0 or it == args.joint_iters - 1:
            rec = {k: float(v) for k, v in m.items()}
            last["loss"] = rec["loss"]
            log({"stage": "joint", "iter": it, **rec, "elapsed_s": clock.elapsed()})
        if it and it % args.save_every == 0:
            save(f"joint_{it}", args.det_iters + it)
    stages["joint"] = clock.done(args.joint_iters, 2 * args.joint_iters * args.batch)
    if args.joint_iters:
        save("joint_final", args.det_iters + args.joint_iters)

    # Stage C: homographic adaptation on unlabeled images (textured
    # synthetic renders stand in for a real-image corpus): the detector
    # aggregated over random views gives pseudo-labels, then the detector
    # is fine-tuned on them.
    if args.ha_iters:
        real_ds = SyntheticImagePairs(image_size=(ds.H, ds.W), seed=99)
        n_imgs = args.ha_images
        clock = _Stage("ha_labels", device, on_stage)
        imgs, labels = [], []
        bsz = 8
        for s0 in range(0, n_imgs, bsz):
            s = real_ds.batch(min(bsz, n_imgs - s0))
            im = s["imgs_grey"][:, 0]
            Hs = np.stack([sample_homography(rng, (ds.H, ds.W))
                           for _ in range(args.ha_homographies)])
            agg = homographic_adaptation(net, torch.as_tensor(im, device=device),
                                         torch.as_tensor(Hs, device=device)).cpu().numpy()
            for k in range(agg.shape[0]):
                imgs.append(im[k])
                labels.append(heatmap_to_cells(agg[k], args.ha_conf))
        log({"stage": "ha_labels", "images": len(imgs), "elapsed_s": clock.elapsed()})
        stages["ha_labels"] = clock.done(len(imgs), len(imgs) * args.ha_homographies)

        det_step = make_detector_train_step(net, opt)
        clock = _Stage("ha_finetune", device, on_stage)
        for it in range(args.ha_iters):
            # Half HA pseudo-labels, half fresh exactly labeled shape
            # renders: a small fixed HA pool alone memorizes (CE -> 5e-6)
            # and forgets the corner prior (the JAX package's first sp_full
            # run: matches 22.6 -> 11.5 after an unmixed stage C).
            k = args.batch // 2
            idx = rng.randint(0, len(imgs), k)
            fresh = [ds.sample() for _ in range(args.batch - k)]
            b = {"image": np.stack([imgs[i] for i in idx] + [f[0] for f in fresh]),
                 "cells": np.stack([labels[i] for i in idx]
                                   + [ds.corners_to_cells(f[1]) for f in fresh])}
            loss = det_step(b)
            hook("ha_finetune", it, loss)
            if it % 100 == 0 or it == args.ha_iters - 1:
                last["loss"] = float(loss)
                log({"stage": "ha_finetune", "iter": it, "loss": last["loss"],
                     "elapsed_s": clock.elapsed()})
        stages["ha_finetune"] = clock.done(args.ha_iters, args.ha_iters * args.batch)
    ckpt = save("final", args.det_iters + args.joint_iters + args.ha_iters)

    clock = _Stage("final_eval", device, on_stage)
    ev = final_eval(net)
    stages["final_eval"] = clock.done(1, 16)
    rec = {"stage": "final_eval", "ckpt": ckpt, **ev}
    log(rec)
    mf.close()
    return {"stages": stages, "final_eval": rec, "checkpoint": ckpt}


if __name__ == "__main__":
    main()
