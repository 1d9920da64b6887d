"""Sweep joint (deepF, superPoint) checkpoint pairs over one fixed eval set.

    python -m deepfepe_tpu_torch.tools.eval_joint_ckpts --dir DIR
        [--gauss2] [--image 376 1240] [--npts 1000] [--tags it500 ...]
        [--eval_batches 6] [--seed 777] [--device cuda|cpu]

Counterpart of the JAX package's `tools/eval_joint_ckpts.py`, with its
flags: the post-hoc selector for `train_joint_full --save_every` runs.
Every deepF_<tag> / superPoint_<tag> pair of `--dir` (`.pth.tar` as the
port writes them, or the JAX package's `.msgpack`), sorted by `it_key`
(the `_it<N>` tags by N, then the rest), goes through `train_joint_full`'s
`evaluate` on the same stream: a fresh `--seed` stream and one RANSAC
generator seeded 99 for every pair, so rows compare with each other and
with the run's own eval lines. A half pair prints {"tag", "error":
"missing pair"}. One JSON line a pair; `main` returns the records.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import torch

from ..data import SyntheticImagePairs
from ..train import load_checkpoint
from ..utils.device import resolve_device
from ..utils.weights import superpoint_state_from_file
from .sp_pipeline import frontend_params, load_frontend, load_solver, solver_config
from .train_joint_full import evaluate

SUFFIXES = (".pth.tar", ".msgpack")
RANSAC_SEED = 99


def it_key(tag: str) -> tuple:
    m = re.search(r"it(\d+)$", tag)
    return (0, int(m.group(1))) if m else (1, 0)


def checkpoint(directory: str, name: str, tag: str) -> str | None:
    for suffix in SUFFIXES:
        path = os.path.join(directory, f"{name}_{tag}{suffix}")
        if os.path.exists(path):
            return path
    return None


def tags_in(directory: str) -> list:
    """Every deepF_<tag> of `directory`, in either format, once."""
    tags = set()
    for suffix in SUFFIXES:
        for p in glob.glob(os.path.join(directory, f"deepF_*{suffix}")):
            tags.add(os.path.basename(p)[len("deepF_"):-len(suffix)])
    return sorted(tags)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True,
                    help="experiment dir holding deepF_*/superPoint_* pairs")
    ap.add_argument("--tags", nargs="*", default=None,
                    help="explicit tag list (default: every deepF_* checkpoint)")
    ap.add_argument("--image", type=int, nargs=2, default=(120, 160))
    ap.add_argument("--npts", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--t_scale", type=float, default=0.15)
    ap.add_argument("--depths", type=float, nargs="+", default=[6.0, 12.0])
    ap.add_argument("--depth_jitter", type=float, default=0.2)
    ap.add_argument("--n_blobs", type=int, default=120)
    ap.add_argument("--n_corners", type=int, default=0)
    ap.add_argument("--conf", type=float, default=0.015)
    ap.add_argument("--nn_thresh", type=float, default=0.7)
    ap.add_argument("--eval_batches", type=int, default=6)
    ap.add_argument("--gauss2", action="store_true")
    ap.add_argument("--seed", type=int, default=777,
                    help="eval-stream seed (777 = train_joint_full's)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    return ap


def eval_stream(args) -> SyntheticImagePairs:
    """The evaluation stream of the parsed flags, from its `--seed`."""
    img = tuple(args.image)
    return SyntheticImagePairs(image_size=img, focal=140.0 * img[1] / 160.0,
                               t_scale=args.t_scale, depths=tuple(args.depths),
                               depth_jitter=args.depth_jitter, n_blobs=args.n_blobs,
                               n_corners=args.n_corners, seed=args.seed)


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = solver_config(args.npts, args.batch, tuple(args.image))
    sp_net = load_frontend("", device, gauss2=args.gauss2)
    deepf_net = load_solver(cfg, "", device)
    fp = frontend_params(args.npts, args.conf, args.nn_thresh)

    records = []
    for tag in sorted(tags_in(args.dir) if args.tags is None else args.tags, key=it_key):
        dp, sp = checkpoint(args.dir, "deepF", tag), checkpoint(args.dir, "superPoint", tag)
        if dp is None or sp is None:
            rec = {"tag": tag, "error": "missing pair"}
        else:
            load_checkpoint(dp, deepf_net)
            sp_net.load_state_dict(superpoint_state_from_file(sp), strict=True)
            # Fresh eval stream and a fixed generator a pair: rows comparable.
            rec = {"tag": tag, **evaluate(deepf_net, sp_net, fp, cfg, eval_stream(args),
                                          args.eval_batches,
                                          torch.Generator().manual_seed(RANSAC_SEED), device)}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
