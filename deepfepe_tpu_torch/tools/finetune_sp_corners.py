"""Fine-tune a pretrained SuperPoint on exactly labeled corner textures.

    python -m deepfepe_tpu_torch.tools.finetune_sp_corners --sp SP
        --out experiments/sp_corners [--iters 2000] [--batch 32] [--lr 5e-5]
        [--eval_corners 60] [--image 120 160] [--n_blobs 40] [--n_rects 14]
        [--gauss2] [--device cuda|cpu]

Counterpart of the JAX package's `tools/finetune_sp_corners.py`, with its
flags, numpy draws and `metrics.jsonl` records. The joint SP + DeepF data
(blob and rectangle textures, `data/synthetic_images.py`) differs from the
polygon shapes SuperPoint was pretrained on; this runs the warped joint
step (detector CE on both views and the descriptor loss) on
`CornerTextures`, the same texture family with exact corner labels, and
scores the frontend's matches against gt epipolar geometry on corner-rich
`SyntheticImagePairs` before (`eval_before`) and after (`eval_after`).

`--sp` is a `.pth.tar` or a flax `.msgpack` (seeded weights when empty);
`--gauss2` trains SuperPointNetGauss2 with BatchNorm on its running
statistics (the buffers stay as loaded). Writes sp_corners.pth.tar (or
sp_corners_gauss2.pth.tar) under `--out`. The train steps take the module
forward; the evaluations take the frontend's, whose fused route launches
K5 on the card under DEEPFEPE_SP_CONV_IMPL=pallas.

`main` returns {'eval_before', 'eval_after' (the records' values),
'train': steps, images, seconds and images/s (host clock, ending in a
synchronize), 'path'}.
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
from ..frontend import FrontendParams, SuperPointNet, SuperPointNetGauss2
from ..frontend.superpoint import reset_superpoint
from ..frontend.train_sp import (CornerTextures, adam, make_warped_joint_train_step,
                                 sample_homography, warp_labels)
from ..utils.device import resolve_device
from ..utils.weights import save_superpoint, superpoint_state_from_file


def make_batch(ds, rng, batch_size):
    imgs, cells, Hs, cells2 = [], [], [], []
    for _ in range(batch_size):
        img, corners = ds.sample()
        Hm = sample_homography(rng, (ds.H, ds.W))
        imgs.append(img)
        cells.append(ds.corners_to_cells(corners))
        Hs.append(Hm)
        cells2.append(ds.corners_to_cells(warp_labels(corners, Hm, (ds.H, ds.W))))
    return {"image": np.stack(imgs), "cells": np.stack(cells), "H": np.stack(Hs),
            "cells2": np.stack(cells2)}


def eval_frontend(net, n_corners: int, image_size=(120, 160), seed: int = 5) -> dict:
    """Match quality on corner-rich pairs: 4 batches of 8 at `image_size`,
    K = 200, nn_thresh 0.9 (train_sp_full.final_eval's protocol on the
    joint data's domain)."""
    device = next(net.parameters()).device
    ds = SyntheticImagePairs(image_size=tuple(image_size), n_corners=n_corners, seed=seed)
    fp = FrontendParams(out_num_points=200, conf_thresh=0.010, nn_thresh=0.9)
    accum = {}
    for _ in range(4):
        s = ds.batch(8)
        imgs = torch.as_tensor(s["imgs_grey"], device=device)
        r = frontend_epidist_eval(net, (imgs[:, 0], imgs[:, 1]),
                                  torch.as_tensor(s["F_gts"], device=device), fp)
        for k, v in r.items():
            if k == "num_matches" or k.startswith("ratio"):
                accum.setdefault(k, []).append(float(np.mean(v)))
    return {k: float(np.mean(v)) for k, v in accum.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sp", default="", help="pretrained checkpoint ('' = seeded weights)")
    ap.add_argument("--out", default="experiments/sp_corners")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--eval_corners", type=int, default=60)
    ap.add_argument("--image", type=int, nargs=2, default=[120, 160])
    ap.add_argument("--n_blobs", type=int, default=40)
    ap.add_argument("--n_rects", type=int, default=14)
    ap.add_argument("--gauss2", action="store_true",
                    help="train SuperPointNetGauss2 (the BatchNorm net the reference runs) "
                         "with BatchNorm on its running statistics")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    img = tuple(args.image)
    os.makedirs(args.out, exist_ok=True)
    mf = open(os.path.join(args.out, "metrics.jsonl"), "a")

    def log(rec):
        print(json.dumps(rec), flush=True)
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    net = reset_superpoint(SuperPointNetGauss2() if args.gauss2 else SuperPointNet(),
                           torch.Generator().manual_seed(0))
    ds = CornerTextures(image_size=img, n_blobs=args.n_blobs, n_rects=args.n_rects, seed=0)
    rng = np.random.RandomState(1)
    make_batch(ds, rng, args.batch)  # the JAX tool's init batch: keeps its draws in step
    if args.sp:
        net.load_state_dict(superpoint_state_from_file(args.sp), strict=True)
    net = net.to(device).eval()

    before = eval_frontend(net, args.eval_corners, img)
    log({"stage": "eval_before", **{k: round(float(v), 4) for k, v in before.items()}})

    opt = adam(net, args.lr)
    step = make_warped_joint_train_step(net, opt)
    t0 = time.time()
    perf0 = time.perf_counter()
    m = {"loss": 0.0}
    for it in range(args.iters):
        m = step(make_batch(ds, rng, args.batch))
        if it % 200 == 0 or it == args.iters - 1:
            log({"stage": "train", "iter": it, "loss": round(float(m["loss"]), 5),
                 "det_ce": round(float(m["det"]), 5),
                 "elapsed_s": round(time.time() - t0, 1)})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sec = time.perf_counter() - perf0
    path = os.path.join(args.out, "sp_corners_gauss2.pth.tar" if args.gauss2
                        else "sp_corners.pth.tar")
    save_superpoint(path, net, args.iters, opt, float(m["loss"]))
    log({"stage": "saved", "path": path})
    after = eval_frontend(net, args.eval_corners, img)
    log({"stage": "eval_after", **{k: round(float(v), 4) for k, v in after.items()}})
    mf.close()
    images = 2 * args.iters * args.batch
    return {"eval_before": before, "eval_after": after, "path": path,
            "train": {"steps": args.iters, "images": images, "seconds": sec,
                      "images_per_s": images / sec if sec > 0 else None}}


if __name__ == "__main__":
    main()
