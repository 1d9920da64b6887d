"""The reference's SIFT-dump workflow end to end, through the port's CLI.

    python -m deepfepe_tpu_torch.tools.dump_workflow --out experiments/dump_workflow
        [--train_frames 120] [--test_frames 60] [--train_iter 800] [--qt_iter 0]
        [--good_num 300] [--image 240 320] [--n_corners 0] [--skip_render]
        [--device cuda|cpu | --cpu]

The port of `tools/dump_workflow.py`, with its flags: render ground-truth
sequences (`SyntheticImageSequence`: three train scenes of
max(train_frames / 3, 4) frames, seeds 0-2, and test scene 09, seed 7) as
JPEG frames, write the SIFT dump tree of each (`data.dump_kitti.
dump_sequence`: SIFT and two-NN matching on the card, S1, S2a, S2b and
S3), then the CLI's `train_good` on the train scenes (F-loss), with
`--qt_iter` a second stage on the qt loss from that checkpoint,
`eval_good` on the test scene, and `eval_vo` on it with the net and with
`--baseline` (RANSAC). It writes `<out>/config.json` (the JAX tool's
config, as JSON: no YAML reader needed), `<out>/config_qt.json` with
`--qt_iter`, and `<out>/summary.json` ({ckpt, [ckpt_qt], eval_good,
vo_net, vo_base}); the runs log under logs/dump_workflow*. This is the
production path of BASELINE.md's "SIFT + deepF" rows on synthetic frames
with exact ground truth. `--cpu` is `--device cpu`.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

from .. import cli
from ..data import SyntheticImageSequence
from ..data.dump_kitti import dump_sequence
from ..utils.device import resolve_device
from ..utils.jpeg import write_jpeg

EXP = "dump_workflow"
TRAIN_SCENES = (("00", 0), ("01", 1), ("02", 2))
TEST_SCENE = ("09", 7)


def config(root: str, good_num: int, h: int, w: int, train_iter: int) -> dict:
    """The JAX tool's CONFIG_TMPL."""
    return {
        "name": "dump_workflow",
        "desc": "SIFT-dump workflow on synthetic persistent-scene sequences",
        "data": {"dataset": "kitti_odo_corr", "dump_root": root,
                 "train_scenes": ["00", "01", "02"], "val_scenes": ["09"],
                 "test_scenes": ["09"], "sequence_length": 2, "delta_ij": 1, "batch_size": 8,
                 "good_num": good_num,
                 "read_what": {"with_quality": True, "with_pose": True},
                 "image": {"size": [h, w, 3]}, "preprocessing": {"resize": [h, w]}},
        "model": {"name": "GoodCorresNet_layers_deepF", "depth": 5, "clamp_at": 0.02,
                  "if_quality": True, "quality_size": 1},
        "exps": {"five_point": False, "base_name": "ransac_8p", "our_name": "DeepF",
                 "filename": "err_ratio.npz"},
        "training": {"learning_rate": 0.0001, "lr_decay_rate": 1, "train_iter": train_iter,
                     "val_interval": -1, "save_interval": train_iter, "seed": 0},
    }


def render_and_dump(out_root: str, scene: str, n_frames: int, seed: int, image_size,
                    n_corners: int = 0, device=None) -> SyntheticImageSequence:
    """One scene's frames as `%06d.jpg` (uint8 of 255 x the frame, as the
    JAX tool casts it) and its SIFT dump, in out_root/scene."""
    seq = SyntheticImageSequence(n_frames=n_frames, image_size=image_size, seed=seed,
                                 n_corners=n_corners)
    img_dir = os.path.join(out_root, scene)
    os.makedirs(img_dir, exist_ok=True)
    files = []
    for k in range(n_frames):
        files.append(os.path.join(img_dir, f"{k:06d}.jpg"))
        write_jpeg(files[-1], (seq.frame(k) * 255).astype(np.uint8))
    dump_sequence(files, seq.cam2world_poses(), seq.K, img_dir, delta_ijs=(1,), device=device)
    return seq


def run_cli(argv: list):
    print(f"\n$ cli {' '.join(argv)}", flush=True)
    return cli.main(argv)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="experiments/dump_workflow")
    ap.add_argument("--train_frames", type=int, default=120)
    ap.add_argument("--test_frames", type=int, default=60)
    ap.add_argument("--train_iter", type=int, default=800)
    ap.add_argument("--qt_iter", type=int, default=0,
                    help="stage-2 qt-loss iterations after the F stage (the reference's "
                         "staged recipe)")
    ap.add_argument("--good_num", type=int, default=300)
    ap.add_argument("--image", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--n_corners", type=int, default=0,
                    help="hard-edged corner stamps per plane texture (sharper SIFT keypoints "
                         "than pure blobs)")
    ap.add_argument("--skip_render", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    dev = ["--device", device.type]

    out = os.path.abspath(args.out)
    root = os.path.join(out, "dump")
    os.makedirs(root, exist_ok=True)
    H, W = args.image
    if not args.skip_render:
        t0 = time.time()
        per_scene = max(args.train_frames // 3, 4)
        for scene, seed in TRAIN_SCENES:
            render_and_dump(root, scene, per_scene, seed, (H, W), args.n_corners, device)
        render_and_dump(root, TEST_SCENE[0], args.test_frames, TEST_SCENE[1], (H, W),
                        args.n_corners, device)
        print(f"rendered+dumped in {time.time() - t0:.1f}s", flush=True)

    cfg = config(root, args.good_num, H, W, args.train_iter)
    cfg_path = os.path.join(out, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    run_cli(["train_good", cfg_path, EXP, "--train_iter", str(args.train_iter), *dev])
    ckpt = os.path.join("logs", EXP, "checkpoints",
                        f"deepFNet_{args.train_iter}_checkpoint.pth.tar")
    summary = {"ckpt": ckpt}
    if args.qt_iter:
        # Stage 2: the pose (q, t) loss from the F-stage checkpoint (balance_t
        # 1.0 as configs/synthetic_qt.yaml). The restored state resumes at
        # n_iter = train_iter, so the budget is the total iteration count.
        qt = copy.deepcopy(cfg)
        qt["model"].update({"if_qt_loss": True, "balance_q": 1, "balance_t": 1.0})
        qt["training"].update({"train_iter": args.qt_iter, "save_interval": args.qt_iter})
        qt_path = os.path.join(out, "config_qt.json")
        with open(qt_path, "w") as f:
            json.dump(qt, f, indent=1)
        total = args.train_iter + args.qt_iter
        run_cli(["train_good", qt_path, EXP + "_qt", "--pretrained", ckpt, "--train_iter",
                 str(total), *dev])
        ckpt = os.path.join("logs", EXP + "_qt", "checkpoints",
                            f"deepFNet_{total}_checkpoint.pth.tar")
        summary["ckpt_qt"] = ckpt
    summary["eval_good"] = run_cli(["eval_good", cfg_path, EXP + "_eval", "--pretrained", ckpt,
                                    *dev])
    # Segment lengths sized to the synthetic trajectory (~0.12 a frame).
    seg = ",".join(str(round(args.test_frames * 0.12 * f, 1)) for f in (0.2, 0.4, 0.6))
    vo = ["--pretrained", ckpt, "--scene", TEST_SCENE[0], "--lengths", seg, *dev]
    summary["vo_net"] = run_cli(["eval_vo", cfg_path, EXP + "_vo_net", *vo])
    summary["vo_base"] = run_cli(["eval_vo", cfg_path, EXP + "_vo_base", *vo, "--baseline"])
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
