"""Command-line entry point of the port.

    python -m deepfepe_tpu_torch.cli train_good <config.yaml> <exper_name>
        [--train_iter k] [--pretrained ckpt.pth.tar] [--profile_dir dir]
        [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli eval_good <config.yaml> <exper_name>
        [--max_batches k] [--pretrained ckpt.pth.tar] [--refine_ba]
        [--refine_min_matches m] [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli val_feature <exper_name> [--config c.yaml]
        [--max_batches k] [--pretrained sp.pth.tar] [--rand_noise s]
        [--homography n] [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli eval_vo <config.yaml> <exper_name>
        [--pretrained ckpt] [--baseline] [--n_frames n] [--scene s]
        [--lengths 5,10] [--pose_graph] [--refine_ba] [--refine_min_matches m]
        [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli infer img1.png img2.png --pretrained ckpt
        --pretrained_SP sp.pth.tar [--K fx,fy,cx,cy] [--config c.yaml]
        [--good_num n] [--out pose.json] [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli export_torch <config.yaml> ckpt.msgpack
        out.pth.tar [--superpoint] [--n_iter n]
    python -m deepfepe_tpu_torch.cli verify_dump <dump_root> [--deltas 1,2]
    python -m deepfepe_tpu_torch.cli tables <table.yaml> [--metrics a,b] [--latex]
    python -m deepfepe_tpu_torch.cli baseline_gate 09=logs/eval09 10=logs/eval10
        --gt_dir <dir> [--baseline deepF|deepFEPE] [--strict]

`train_good` trains the solver (F-loss, or the qt pose loss with
`model.if_qt_loss`) on the config's train data, validates on its val
data, and writes logs/<exper_name>/{config.yml, metrics.jsonl, runs/,
checkpoints/deepFNet_<n>_checkpoint.pth.tar}; it prints the last step's
scalar metrics as one JSON line. A dump tree's train split is walked
epoch after epoch up to `train_iter` steps. With `model.if_SP` it trains
SuperPoint and the solver jointly on image pairs (`train_joint`) and also
writes checkpoints/superPointNet_<n>_checkpoint.pth.tar. Both `train_good`
and `eval_good` run the config's DeepFNet variant (`model.if_sample_loss`,
`if_learn_offsets`, `if_tri_depth`, `if_goodCorresArch`, `if_img_w`).
`eval_good` runs the solver on the config's test data (a dump tree's
whole test split in order, `--max_batches` 0 for all of it), scores each
pair against the ground truth and the RANSAC baseline (8-point, or
five-point with `exps.five_point`), writes the reference's npz dumps
logs/<exper_name>/{our_name,base_name}_<filename> and prints the JAX
package's summary keys as one JSON line; `--refine_ba` polishes each
solver pose by two-view square-root BA first. `val_feature` runs the
SuperPoint frontend on synthetic image pairs, or with `--config` on the
config's test split with its frames, and prints the share of matches
within 0.1, 0.5, 1 and 2 px of their ground-truth epipolar lines and the
match count, also written to logs/<exper_name>/result_dict_all.npz;
`--homography n` adds the detector and descriptor metrics (repeatability,
matching score, mAP, homography correctness) of n homography-warped
pairs as `h_*` keys.
`eval_vo` estimates every consecutive pair of a sequence (the synthetic
sequence, or a dump tree's test split in frame order) with the solver or
`--baseline`, chains them and prints the KITTI metrics (trans %, rot
deg/100 m, ATE, RPE) as one JSON line, with
logs/<exper_name>/{trajectory_est,trajectory_gt,result}.txt;
`--refine_ba` polishes each pair's pose, `--pose_graph` fuses a second
sweep of (i, i + 2) pairs with the first in a pose graph
(trajectory_pose_graph.txt, the report's 'pose_graph'). `infer` is
the serving entry: two PNG frames through SuperPoint and the solver to
one JSON line of R, t_unit and E. `export_torch` writes a flax `.msgpack`
checkpoint as the reference's `.pth.tar`; `verify_dump` checks a dump
tree; `tables` compares experiments' npz dumps; `baseline_gate` holds
eval_good's dumps of KITTI 09/10 to BASELINE.md's targets. Every
`--pretrained` takes a reference `.pth.tar` or a flax `.msgpack`. The
entry points that compute default to the card; without one they raise
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from .ba import graph_from_odometry, optimize_pose_graph_two_stage
from .data import KittiCorrDataset, SyntheticImagePairs, SyntheticSequence
from .data.prefetch import prefetch_batches
from .eval import (chain_relative_poses, export_poses_kitti, frontend_epidist_eval,
                   kitti_odometry, val_rt_batch)
from .eval.frontend_eval import evaluate_homography_pair
from .eval.refine import refine_two_view_batch
from .frontend import (FrontendParams, SuperPointNet, SuperPointNetGauss2,
                       frontend_params_from_config, get_matches_from_sp)
from .frontend.superpoint import reset_superpoint
from .geometry.basic import rt_inverse
from .geometry.rotations import rotation_angle_error, vector_angle
from .loader import data_loader, model_loader
from .train import (MetricLogger, Trainer, eval_step, load_checkpoint, load_config,
                    qt_clamps, save_checkpoint)
from .train.config import Config
from .train.joint import joint_train_step, make_joint_state
from .train.loop import scalars, start_profile, stop_profile
from .utils.device import batch_to_device, no_tf32, resolve_device
from .utils.warp import get_perspective_transform
from .utils.weights import load_superpoint, save_superpoint

SIFT_ITEM = ("needs OpenCV's SIFT detector and matcher, which the port does not use "
             "(ROADMAP Queue 1 item 8); give a SuperPoint checkpoint with --pretrained_SP")
# BASELINE.md's targets: the reference's committed kitti-odom-eval outputs
# (results/{deepF,deepFEPE}_kitti/{09,10}/result.txt:2-6).
BASELINE_TARGETS = {
    "deepF": {
        "09": {"trans_err_pct": 9.706, "rot_err_deg_per_100m": 0.889,
               "ATE_m": 80.157, "RPE_m": 0.211, "RPE_deg": 0.051},
        "10": {"trans_err_pct": 11.206, "rot_err_deg_per_100m": 1.546,
               "ATE_m": 34.342, "RPE_m": 0.253, "RPE_deg": 0.362},
    },
    "deepFEPE": {
        "09": {"trans_err_pct": 8.639, "rot_err_deg_per_100m": 0.664,
               "ATE_m": 52.576, "RPE_m": 0.214, "RPE_deg": 0.054},
        "10": {"trans_err_pct": 11.719, "rot_err_deg_per_100m": 0.945,
               "ATE_m": 35.325, "RPE_m": 0.252, "RPE_deg": 0.212},
    },
}
VO_METRICS = ("trans_err_pct", "rot_err_deg_per_100m", "ATE_m", "RPE_m", "RPE_deg")

PER_PAIR = ("err_q_est", "err_t_est", "err_q_base", "err_t_base", "err_q_gt",
            "err_t_gt", "base_inliers", "M_cam_est", "M_cam_base", "epi_dists_est",
            "epi_dists_base")


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int) -> Dict[str, np.ndarray]:
    """A short batch padded to `batch_size` by repeating its last pair (every
    key with the batch's leading size), as the JAX CLI pads its last eval
    batch; the padded rows are trimmed from the results."""
    n = len(batch["Ks"])
    return {k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)])
            if np.ndim(v) and len(v) == n else v for k, v in batch.items()}


def evaluate(cfg: Config, net, batch_iter: Iterable[Dict[str, np.ndarray]],
             device: torch.device, generator: torch.Generator | None = None,
             ransac_idxs: Sequence[torch.Tensor] | None = None,
             pad_to: int | None = None, refine_min_matches: int | None = None
             ) -> Dict[str, np.ndarray]:
    """Per-pair errors, poses and epipolar distances over `batch_iter`, with
    each batch's `Rt_cam2_gt` (identity where it has none). With `pad_to`,
    a shorter batch is padded to it and its padding trimmed (eval_good's
    tail, as the JAX CLI runs it). The RANSAC hypotheses of batch i are
    `ransac_idxs[i]` when given, else drawn from `generator`. With
    `refine_min_matches` the solver's forward poses are polished
    (`refine_batch`) before their errors and camera poses are taken."""
    per_pair = {k: [] for k in (*PER_PAIR, "Rt_cam2_gt")}
    losses = []
    for i, batch in enumerate(batch_iter):
        n_real = len(batch["Ks"])
        if pad_to and n_real < pad_to:
            batch = pad_batch(batch, pad_to)
        tb = batch_to_device(batch, device)
        metrics = eval_step(net, tb, cfg)
        with torch.no_grad():
            rt = val_rt_batch(
                metrics["E_ests"], tb["Ks"], tb["matches_xy_ori"], tb["E_gts"],
                tb["delta_Rtijs_4_4"],
                ransac_idxs=None if ransac_idxs is None else ransac_idxs[i],
                generator=generator, five_point=cfg.exps.five_point)
            if refine_min_matches is not None:
                # The forward (i -> j) pose is refined; the dumps and errors
                # take the camera convention (its inverse), as val_rt's do.
                R, t, _ = refine_batch(tb, metrics, rt["M_est"], refine_min_matches)
                M_cam = rt_inverse(torch.cat([R, t[..., None]], dim=-1))
                eq, et = refined_errors(M_cam[:, :3, :3], M_cam[:, :3, 3],
                                        np.linalg.inv(np.asarray(batch["delta_Rtijs_4_4"],
                                                                 np.float64)))
                rt = {**rt, "M_cam_est": M_cam, "err_q_est": torch.from_numpy(eq),
                      "err_t_est": torch.from_numpy(et)}
        for k in PER_PAIR:
            per_pair[k].append(rt[k].cpu().numpy()[:n_real])
        per_pair["Rt_cam2_gt"].append(np.asarray(batch.get(
            "Rt_cam2_gt", np.tile(np.eye(4, dtype=np.float32), (len(batch["Ks"]), 1, 1))))[:n_real])
        losses.append(float(metrics["loss_F"]))
    out = {k: np.concatenate(v) for k, v in per_pair.items()}
    out["loss_F"] = np.asarray(losses)
    return out


def to_body(M_cam: np.ndarray, Rt_cam2: np.ndarray) -> np.ndarray:
    """Camera-frame relative poses [B, 3, 4] to the body frame:
    inv(Rt_cam2_gt) @ M @ Rt_cam2_gt."""
    pad = np.tile(np.array([[[0.0, 0, 0, 1]]]), (len(M_cam), 1, 1))
    M44 = np.concatenate([M_cam, pad], axis=1)
    return (np.linalg.inv(Rt_cam2) @ M44 @ Rt_cam2)[:, :3, :]


def save_eval_dumps(cfg: Config, res: Dict[str, np.ndarray], save_dir: str) -> list:
    """The reference's npz dumps ({our_name,base_name}_{filename}): err_q,
    err_t, epi_dists (the first 10 points), relative_poses_cam and
    relative_poses_body. Returns their paths."""
    paths = []
    for name, tag, eq, et in ((cfg.exps.our_name, "est", "err_q_est", "err_t_est"),
                              (cfg.exps.base_name, "base", "err_q_base", "err_t_base")):
        path = os.path.join(save_dir, f"{name}_{cfg.exps.filename}")
        M = res[f"M_cam_{tag}"]
        np.savez(path, err_q=res[eq], err_t=res[et], epi_dists=res[f"epi_dists_{tag}"][:, :10],
                 relative_poses_cam=M, relative_poses_body=to_body(M, res["Rt_cam2_gt"]))
        paths.append(path)
    return paths


def epochs(ds, batch_size: int):
    """Endless batches: a dataset that yields one pass a `.batches` call is
    walked pass after pass; a pass with no batch raises."""
    while True:
        empty = True
        for b in ds.batches(batch_size):
            empty = False
            yield b
        if empty:
            raise RuntimeError("train dataset produced no batches")


def summarize(res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The JAX `cmd_eval` summary keys, plus the mean F-loss."""
    return {
        "median_err_q": float(np.median(res["err_q_est"])),
        "median_err_t": float(np.median(res["err_t_est"])),
        "median_err_q_base": float(np.median(res["err_q_base"])),
        "median_err_t_base": float(np.median(res["err_t_base"])),
        "median_err_q_gt": float(np.median(res["err_q_gt"])),
        "pairs": int(len(res["err_q_est"])),
        "loss_F": float(np.mean(res["loss_F"])),
    }


def _snapshot_config(cfg: Config, exper_name: str) -> str:
    """logs/<exper_name>/config.yml (train_good.py:114; JSON is valid YAML)."""
    save_dir = os.path.join("logs", exper_name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.yml"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    return save_dir


def train_good(cfg: Config, exper_name: str, train_iter: int | None = None,
               pretrained: str = "", profile_dir: str = "", device=None) -> Dict[str, float]:
    """Train from weights seeded by `cfg.training.seed`, or from a
    checkpoint (`pretrained`, else the config's unless `retrain`), for
    `train_iter` (else the config's) steps; returns the last step's scalar
    metrics with `wall_s` and `n_iter`."""
    device = resolve_device(device)
    if cfg.model.if_SP:
        return train_joint(cfg, exper_name, train_iter, pretrained, profile_dir, device)
    t = cfg.training
    if train_iter is not None:
        t.train_iter = train_iter
    if profile_dir:
        t.profile_dir = profile_dir
    save_dir = _snapshot_config(cfg, exper_name)
    net = model_loader(cfg, device, torch.Generator().manual_seed(t.seed), train=True)
    trainer = Trainer(net, cfg, save_dir=save_dir)
    train_ds, val_ds = data_loader(cfg, "train"), data_loader(cfg, "val")
    bs = cfg.data.batch_size
    pre = pretrained or ("" if t.retrain else t.pretrained)
    if pre:
        # The JAX CLI draws one train batch to restore into; drawing it here
        # too keeps both CLIs on the same pairs.
        next(iter(train_ds.batches(bs)))
        trainer.restore(pre)
        if t.reset_iter:
            trainer.n_iter = 0
        print(f"restored from {pre} @ iter {trainer.n_iter}", flush=True)
    try:
        last = trainer.fit(
            # A producer thread stays ahead of the device (the DataLoader
            # workers' role); workers_train bounds its depth.
            prefetch_batches(epochs(train_ds, bs), depth=max(2, min(t.workers_train, 8))),
            val_stream_fn=lambda: val_ds.batches(bs), max_iters=t.train_iter)
        trainer.save(trainer.n_iter)
    finally:
        trainer.logger.close()
    last["n_iter"] = trainer.n_iter
    return last


def train_joint(cfg: Config, exper_name: str, train_iter: int | None = None,
                pretrained: str = "", profile_dir: str = "", device=None) -> Dict[str, float]:
    """Joint SuperPoint + DeepF training (`model.if_SP`), the counterpart of
    the JAX CLI's `_train_joint_from_config` (train_good.py:198-251): a
    SuperPointNetGauss2 frontend seeded by `training.seed`, or read from
    `pretrained_SP` (`.pth.tar` or flax `.msgpack`) unless `retrain_SP`;
    the solver seeded, or read from `pretrained` (else the config's unless
    `retrain`); both Adams at
    `learning_rate`; `train` and `train_SP` gate the two updates;
    training.SP_params sets the frontend (its `remat` included). The
    frontend computes in bf16 when `model.mlp_dtype` is bfloat16, as the
    JAX CLI builds it; its parameters, and so its checkpoints, stay
    float32. The train data is walked epoch after epoch (`epochs`), from a
    `synthetic_images` stream or a dump tree with frames. Checkpoints
    every `save_interval` steps and at the end, under both reference
    names. Returns the last step's scalar metrics with `wall_s` and
    `n_iter`. `profile_dir` traces steps [profile_start, profile_start +
    profile_steps) as `train_good` does."""
    device = resolve_device(device)
    t = cfg.training
    sp_dtype = torch.bfloat16 if cfg.model.mlp_dtype == "bfloat16" else torch.float32
    if train_iter is not None:
        t.train_iter = train_iter
    if profile_dir:
        t.profile_dir = profile_dir
    cfg.data.with_imgs = True  # the SuperPoint path needs the grey frames
    fp = frontend_params_from_config(cfg)
    save_dir = _snapshot_config(cfg, exper_name)
    train_ds = data_loader(cfg, "train")
    bs = cfg.data.batch_size
    # The JAX CLI draws one batch to initialize its parameters before it
    # trains (it advances a dump tree's RandomState); drawing it here too
    # keeps both CLIs on the same pairs.
    batch0 = next(iter(train_ds.batches(bs)), None)
    if batch0 is None:
        raise RuntimeError("train dataset produced no batches")
    if "imgs_grey" not in batch0:
        raise SystemExit("if_SP training needs image batches: a dump tree with frames "
                         "or dataset: synthetic_images")
    if not t.retrain_SP and t.pretrained_SP:
        sp_net = load_superpoint(t.pretrained_SP, device, dtype=sp_dtype)
    else:
        sp_net = reset_superpoint(SuperPointNetGauss2(dtype=sp_dtype),
                                  torch.Generator().manual_seed(t.seed))
        sp_net = sp_net.eval().to(device)
    deepf_net = model_loader(cfg, device, torch.Generator().manual_seed(t.seed), train=True)
    pre = pretrained or ("" if t.retrain else t.pretrained)
    if pre:
        load_checkpoint(pre, deepf_net)
        print(f"restored the solver from {pre}", flush=True)
    state = make_joint_state(deepf_net, sp_net, cfg)
    logger = MetricLogger(os.path.join(save_dir, "metrics.jsonl"),
                          tb_dir=os.path.join(save_dir, "runs") if t.tensorboard else None)

    def save(n: int) -> None:
        ckpt_dir = os.path.join(save_dir, "checkpoints")
        save_checkpoint(os.path.join(ckpt_dir, f"deepFNet_{n}_checkpoint.pth.tar"), deepf_net,
                        state.opt_deepf, n)
        save_superpoint(os.path.join(ckpt_dir, f"superPointNet_{n}_checkpoint.pth.tar"),
                        sp_net, n, state.opt_sp)

    last: Dict = {}
    prof = None
    t0 = time.perf_counter()
    try:
        stream = prefetch_batches(epochs(train_ds, bs), depth=max(2, min(t.workers_train, 8)))
        for it, batch in enumerate(stream):
            if it >= t.train_iter:
                break
            if t.profile_dir and it == t.profile_start:
                prof = start_profile(device)
            if prof is not None and it == t.profile_start + t.profile_steps:
                stop_profile(prof, device, t.profile_dir)
                prof = None
            metrics = joint_train_step(state, batch_to_device(batch, device), fp, cfg,
                                       *qt_clamps(t, it), train_deepf=t.train,
                                       train_sp=t.train_SP)
            logger.log(it, "train", metrics)
            last = metrics
            if t.save_interval > 0 and (it + 1) % t.save_interval == 0:
                save(it + 1)
        if prof is not None:  # the run ended inside the capture window
            stop_profile(prof, device, t.profile_dir)
        save(state.n_iter)
    finally:
        logger.close()
    out = scalars(last)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["wall_s"] = time.perf_counter() - t0
    out["n_iter"] = state.n_iter
    return out


def eval_batches(cfg: Config, ds, max_batches: int) -> list:
    """The eval data of the JAX CLI: first one shuffled batch drawn and
    dropped (it initializes the JAX parameters, and advances a dump
    dataset's RandomState as there), then a dump tree's whole split in
    order with its short tail, or the synthetic stream; `max_batches`
    (0: all of a dump split) bounds it."""
    bs = cfg.data.batch_size
    next(iter(ds.batches(bs)))
    if isinstance(ds, KittiCorrDataset):
        data = ds.batches(bs, shuffle=False, drop_last=False)
        return list(data if not max_batches else itertools.islice(data, max_batches))
    if max_batches <= 0:
        raise ValueError("the synthetic stream is endless: give max_batches > 0")
    return list(ds.batches(bs, max_batches))


def eval_good(cfg: Config, max_batches: int, device=None, pretrained: str = "",
              exper_name: str = "", refine_ba: bool = False,
              refine_min_matches: int = 200) -> Dict[str, float]:
    """Weights seeded from `cfg.training.seed`, or read from a checkpoint
    (`pretrained`), on the config's test data (`eval_batches`). With
    `exper_name`, writes logs/<exper_name>/config.yml and the npz dumps.
    `refine_ba` polishes the solver's poses by two-view square-root BA
    before they are scored and dumped (`evaluate`)."""
    device = resolve_device(device)
    seed = cfg.training.seed
    net = model_loader(cfg, device, torch.Generator().manual_seed(seed))
    if pretrained:
        load_checkpoint(pretrained, net)
    # Data is made up front (host set-up), so `seconds` times the solver
    # and its evaluation alone.
    data = eval_batches(cfg, data_loader(cfg, "test"), max_batches)
    t0 = time.perf_counter()
    res = evaluate(cfg, net, data, device, generator=torch.Generator().manual_seed(seed),
                   pad_to=cfg.data.batch_size,
                   refine_min_matches=refine_min_matches if refine_ba else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    summary = summarize(res)
    summary["seconds"] = seconds
    summary["device"] = str(device)
    if exper_name:
        save_eval_dumps(cfg, res, _snapshot_config(cfg, exper_name))
    return summary


def homography_pairs(n: int) -> list:
    """`val_feature --homography n`'s (image, H_gt) pairs, drawn as the JAX
    CLI draws them: the first frame of `SyntheticImagePairs(seed=100 + j)`
    (120x160), and the homography that moves its corners by up to 8% of the
    image's size (`RandomState(7)`), by `get_perspective_transform` (the
    numpy `cv2.getPerspectiveTransform`)."""
    rng = np.random.RandomState(7)
    out = []
    for j in range(n):
        img = SyntheticImagePairs(seed=100 + j).batch(1)["imgs_grey"][0, 0]
        Hh, Ww = img.shape
        pert = rng.uniform(-0.08, 0.08, (4, 2)) * [Ww, Hh]
        src = np.array([[0, 0], [Ww, 0], [0, Hh], [Ww, Hh]], np.float32)
        out.append((img, get_perspective_transform(src, (src + pert).astype(np.float32))))
    return out


def val_feature(exper_name: str, max_batches: int = 0, pretrained: str = "",
                rand_noise: float = 0.0, config: str | Config = "", homography: int = 0,
                fp: FrontendParams | None = None, image_size=(120, 160), batch_size: int = 2,
                device=None) -> Dict[str, float]:
    """Frontend-only correspondence quality, `max_batches` batches (5 when
    0): on `SyntheticImagePairs(seed=0)` (the JAX CLI's stream) in batches of
    `batch_size` pairs, or with `config` (a YAML path or a Config) on its
    test split with the frames on, in order, in its batches, the last one
    short. SuperPoint from `pretrained` (a reference `.pth` or `.pth.tar`,
    or a flax `.msgpack`; gauss2 when it has BatchNorm keys) or seeded (seed 0); keypoints and
    mutual-NN matches under `fp`, else the config's SP_params, else the JAX
    CLI's FrontendParams(out_num_points=300, conf_thresh=1e-3). Returns the
    mean per batch of `ratio@{0.1,0.5,1.0,2.0}` and `num_matches`; with
    `homography` n, also the means over n homography-warped pairs
    (`homography_pairs`) of `evaluate_homography_pair`'s metrics, each
    under its name with an `h_` prefix; with `pairs`, `seconds` (host clock
    over the frontend and its scoring, ending in a synchronize; data is
    made up front) and `device`."""
    device = resolve_device(device)
    n_batches = max_batches or 5
    if config:
        cfg = load_config(config) if isinstance(config, str) else config
        cfg.data.with_imgs = True
        if fp is None and cfg.training.sp_params:
            fp = frontend_params_from_config(cfg)
        ds = data_loader(cfg, "test")
        data = list(itertools.islice(
            ds.batches(cfg.data.batch_size, shuffle=False, drop_last=False), n_batches))
    else:
        gen = SyntheticImagePairs(image_size=tuple(image_size), seed=0)
        data = [gen.batch(batch_size) for _ in range(n_batches)]
    fp = fp or FrontendParams(out_num_points=300, conf_thresh=1e-3)
    if pretrained:
        net = load_superpoint(pretrained, device)
    else:
        net = reset_superpoint(SuperPointNet(), torch.Generator().manual_seed(0))
        net = net.eval().to(device)
    hpairs = homography_pairs(homography)
    accum: Dict[str, list] = {}
    hp: Dict[str, list] = {}
    t0 = time.perf_counter()
    for i, batch in enumerate(data):
        imgs = torch.as_tensor(batch["imgs_grey"], device=device)
        out = frontend_epidist_eval(
            net, (imgs[:, 0], imgs[:, 1]), torch.as_tensor(batch["F_gts"], device=device), fp,
            noise_std=rand_noise,
            generator=torch.Generator().manual_seed(i) if rand_noise else None)
        for k, v in out.items():
            if k.startswith("ratio") or k == "num_matches":
                accum.setdefault(k, []).append(float(np.mean(v)))
    for img, H_gt in hpairs:
        for k, v in evaluate_homography_pair(net, img, H_gt, fp).items():
            hp.setdefault(k, []).append(float(v))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    summary = {k: float(np.mean(v)) for k, v in accum.items()}
    summary.update({f"h_{k}": float(np.mean(v)) for k, v in hp.items()})
    save_dir = os.path.join("logs", exper_name)
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, "result_dict_all.npz"), **summary)
    summary.update(pairs=sum(len(b["Ks"]) for b in data), seconds=seconds, device=str(device))
    return summary


def vo_batches(cfg: Config, n_frames: int = 0, scene: str = ""):
    """eval_vo's data: (frame-ordered pair batches, gt trajectory or None,
    segment lengths or None, skip_batches). On 'synthetic' the JAX CLI's
    sequence (`n_frames`, else 60, seed 123) with lengths of 5-40 m; on a
    dump tree its test split (one scene or all) in frame order, the gt
    trajectory chained from the pairs' gt poses and KITTI's 100-800 m.
    `skip_batches()` gives the (i, i + 2) pairs in the same order: the
    sequence's, drawn after the consecutive pairs as the JAX CLI draws
    them, or a second loader with `delta_ij` 2 over the tree."""
    d = cfg.data
    if d.dataset == "synthetic":
        seq = SyntheticSequence(n_frames=n_frames or 60, good_num=d.good_num,
                                noise_px=d.noise_px, outlier_frac=d.outlier_frac, seed=123)
        return (seq.pair_batches(d.batch_size), seq.gt_trajectory(), (5.0, 10.0, 20.0, 40.0),
                lambda: seq.pair_batches(d.batch_size, delta=2))

    def skip_batches():
        cfg2 = dataclasses.replace(cfg, data=dataclasses.replace(d, delta_ij=2))
        ds2 = data_loader(cfg2, "test")
        if len(ds2) == 0:
            raise SystemExit(
                f"--pose_graph needs delta-2 pairs but the dump tree {d.dump_root} has no "
                "ij_match_quality_{i}-{i+2}_* files; re-dump with delta_ijs=(1, 2) "
                "(data/dump_kitti.dump_sequence)")
        return ds2.ordered_pair_batches(d.batch_size, scene_name=scene or None)

    ds = data_loader(cfg, "test")
    return ds.ordered_pair_batches(d.batch_size, scene_name=scene or None), None, None, \
        skip_batches


def write_result_txt(path: str, scene: str, report: Dict[str, float]) -> None:
    """result.txt in the reference's format (results/*/result.txt)."""
    with open(path, "w") as f:
        f.write(f"Sequence: \t {scene or 'synthetic'} \n")
        f.write(f"Trans. err. (%): \t {report['trans_err_pct']:.3f} \n")
        f.write(f"Rot. err. (deg/100m): \t {report['rot_err_deg_per_100m']:.3f} \n")
        f.write(f"ATE (m): \t {report['ATE_m']:.3f} \n")
        f.write(f"RPE (m): \t {report['RPE_m']:.3f} \n")
        f.write(f"RPE (deg): \t {report['RPE_deg']:.3f} \n")


def refined_errors(R: torch.Tensor, t: torch.Tensor, gt: np.ndarray):
    """Rotation and sign-free translation angle errors (degrees, numpy) of
    refined forward poses (R [B, 3, 3], unit t [B, 3]) against gt [B, 4, 4]."""
    gt = torch.as_tensor(np.asarray(gt), dtype=R.dtype, device=R.device)
    eq = rotation_angle_error(R, gt[:, :3, :3]).cpu().numpy()
    et = vector_angle(t, gt[:, :3, 3]).cpu().numpy()
    return eq, np.minimum(et, 180.0 - et)


def refine_batch(tb: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor],
                 M: torch.Tensor, min_matches: int):
    """The two-view square-root BA polish of forward poses M [B, 3, 4]
    (`eval.refine`, 5 iterations), in float32 on their device, the
    solver's weights as residual weights; returns (R, t, info)."""
    return refine_two_view_batch(tb["matches_xy_ori"].float(), metrics["weights"].float(),
                                 tb["Ks"].float(), M[:, :3, :3].float(), M[:, :3, 3].float(),
                                 iters=5, min_matches=min_matches)


def scaled_poses(rels: Sequence[np.ndarray], scales: Sequence[float]) -> np.ndarray:
    """[n, 4, 4] float32 relative poses with each unit translation scaled to
    its pair's gt length (the monocular convention)."""
    out = []
    for M, s in zip(rels, scales):
        T = np.eye(4)
        T[:3, :3] = M[:3, :3]
        tn = M[:3, 3]
        T[:3, 3] = tn / max(np.linalg.norm(tn), 1e-9) * s
        out.append(T)
    return np.stack(out).astype(np.float32)


def fuse_pose_graph(rels1, scales1, rels2, scales2, device: torch.device) -> np.ndarray:
    """The JAX CLI's multi-frame fusion: odometry edges (weight 1) and
    (i, i + 2) skip edges weighted on translation only, gt-scaled, solved
    by the two-stage pose graph (Huber 0.05) on `device`; returns the fused
    camera-to-world trajectory [n, 4, 4]."""
    n = len(rels1) + 1
    graph = graph_from_odometry(
        torch.as_tensor(scaled_poses(rels1, scales1), device=device),
        loop_edges=torch.as_tensor(np.stack([np.arange(n - 2), np.arange(2, n)], -1),
                                   device=device),
        loop_measurements=torch.as_tensor(scaled_poses(rels2, scales2), device=device),
        odo_weight=1.0, loop_weight=torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0]))
    graph, _ = optimize_pose_graph_two_stage(graph, huber_delta=0.05)
    with no_tf32():
        return torch.linalg.inv(graph.poses).cpu().numpy()


def eval_vo(cfg: Config, exper_name: str, pretrained: str = "", baseline: bool = False,
            scene: str = "", n_frames: int = 0, lengths: Sequence[float] | None = None,
            pose_graph: bool = False, refine_ba: bool = False, refine_min_matches: int = 200,
            device=None, ransac_idxs: Sequence[torch.Tensor] | None = None) -> Dict[str, float]:
    """Sequence VO, the JAX CLI's `cmd_eval_vo`: every consecutive pair
    estimated in frame order (`vo_batches`) by the solver, or with
    `baseline` by the RANSAC baseline of `val_rt_batch` (the config's
    8-point or five-point; hypotheses `ransac_idxs[i]` for the i-th batch of
    the run, else drawn from a generator seeded 0), padded duplicates
    skipped by `frame_i`, the poses chained and written as KITTI
    trajectories (logs/<exper_name>/trajectory_{est,gt}.txt), scored with
    `evaluate_sequence(align='scale')` (`lengths`, else the source's) and
    written as result.txt. Weights seeded from `training.seed`, or read
    from `pretrained` (`.pth.tar` or flax `.msgpack`).

    `refine_ba` polishes each solver pose by two-view square-root BA
    (`refine_batch`; a pair keeps its pose unless the polish lowers its
    robust cost with >= `refine_min_matches` effective matches) and scores
    the refined poses. `pose_graph` adds a sweep of (i, i + 2) pairs (the
    same polish) and fuses both in the two-stage pose graph
    (`fuse_pose_graph`): trajectory_pose_graph.txt and report['pose_graph'].
    Returns the report with median_err_q/err_t, n_pairs, `seconds` (host
    clock over the consecutive pairs' solver, evaluation and polish, ending
    in a synchronize; data made up front), pairs_per_s, `device`, and with
    `pose_graph` `skip_seconds` (the second sweep) and `pose_graph_seconds`
    (the fusion)."""
    device = resolve_device(device)
    save_dir = _snapshot_config(cfg, exper_name)
    net = model_loader(cfg, device, torch.Generator().manual_seed(cfg.training.seed))
    if pretrained:
        load_checkpoint(pretrained, net)
    batch_iter, gt_traj, default_lengths, skip_batches = vo_batches(cfg, n_frames, scene)
    data = list(batch_iter)
    lengths = tuple(lengths) if lengths else default_lengths
    generator = torch.Generator().manual_seed(0)
    tag = "base" if baseline else "est"
    run_batches = itertools.count()

    def sweep(batches):
        """Per-pair forward poses [3, 4], gt poses, errors and gt scales."""
        rels_est, rels_gt, errqs, errts, scales = [], [], [], [], []
        for batch in batches:
            i = next(run_batches)
            tb = batch_to_device(batch, device)
            metrics = eval_step(net, tb, cfg)
            with torch.no_grad():
                rt = val_rt_batch(metrics["E_ests"], tb["Ks"], tb["matches_xy_ori"], tb["E_gts"],
                                  tb["delta_Rtijs_4_4"], ransac=baseline,
                                  ransac_idxs=None if ransac_idxs is None else ransac_idxs[i],
                                  generator=generator, five_point=cfg.exps.five_point)
                if refine_ba and not baseline:
                    R, t, _ = refine_batch(tb, metrics, rt["M_est"], refine_min_matches)
                    M = torch.cat([R, t[..., None]], dim=-1).cpu().numpy()
                    eq, et = refined_errors(R, t, batch["delta_Rtijs_4_4"])
                else:
                    M, eq, et = (rt[f"{k}_{tag}"].cpu().numpy() for k in ("M", "err_q", "err_t"))
            frames = batch.get("frame_i")
            for j in range(len(M)):
                fidx = int(frames[j]) if frames is not None else len(rels_est)
                if fidx == len(rels_est):  # padded duplicates repeat an earlier frame
                    rels_est.append(M[j])
                    rels_gt.append(batch["delta_Rtijs_4_4"][j])
                    errqs.append(float(eq[j]))
                    errts.append(float(et[j]))
                    scales.append(float(np.asarray(batch["t_scene_scale"][j]).reshape(-1)[0])
                                  if "t_scene_scale" in batch else
                                  float(np.linalg.norm(batch["delta_Rtijs_4_4"][j][:3, 3])))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return rels_est, rels_gt, errqs, errts, scales

    t0 = time.perf_counter()
    rels_est, rels_gt, errqs, errts, scales1 = sweep(data)
    seconds = time.perf_counter() - t0
    traj_est = chain_relative_poses(np.stack(rels_est))
    if gt_traj is None:
        gt_traj = chain_relative_poses(np.stack(rels_gt))
    export_poses_kitti(traj_est, os.path.join(save_dir, "trajectory_est.txt"))
    export_poses_kitti(gt_traj, os.path.join(save_dir, "trajectory_gt.txt"))
    kw = {"lengths": lengths} if lengths else {}
    report = kitti_odometry.evaluate_sequence(gt_traj, traj_est, align="scale", **kw)
    report.update(median_err_q=float(np.median(errqs)), median_err_t=float(np.median(errts)),
                  n_pairs=len(rels_est))
    extra = {}
    if pose_graph:
        skip = list(skip_batches())
        t0 = time.perf_counter()
        rels2, _, _, _, scales2 = sweep(skip)
        extra["skip_seconds"] = time.perf_counter() - t0
        if len(rels2) != len(rels_est) - 1:
            raise SystemExit(
                f"pose graph needs a delta-2 edge per frame triple: got {len(rels2)} skip edges "
                f"for {len(rels_est)} odometry edges (incomplete delta-2 dump?)")
        t0 = time.perf_counter()
        traj_fused = fuse_pose_graph(rels_est, scales1, rels2, scales2, device)
        extra["pose_graph_seconds"] = time.perf_counter() - t0
        export_poses_kitti(traj_fused, os.path.join(save_dir, "trajectory_pose_graph.txt"))
        fused = kitti_odometry.evaluate_sequence(gt_traj, traj_fused, align="scale", **kw)
        report["pose_graph"] = {k: round(float(v), 4) for k, v in fused.items()}
    write_result_txt(os.path.join(save_dir, "result.txt"), scene, report)
    report.update(seconds=seconds, pairs_per_s=len(rels_est) / seconds, device=str(device),
                  **extra)
    return report


def read_intrinsics(K: str, H: int, W: int) -> np.ndarray:
    """'fx,fy,cx,cy' as a 3x3 K; empty: a focal of 1.2 max(H, W) and the
    image centre."""
    if K:
        fx, fy, cx, cy = (float(v) for v in K.split(","))
    else:
        fx = fy = 1.2 * max(H, W)
        cx, cy = W / 2.0, H / 2.0
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float64)


def infer(img1: str, img2: str, pretrained: str, pretrained_SP: str = "", K: str = "",
          config: str = "", good_num: int = 1000, out: str = "", device=None) -> Dict:
    """The serving entry, the JAX CLI's `cmd_infer`: two frames (PNG) ->
    the relative pose. SuperPoint from `pretrained_SP` (`.pth`, `.pth.tar`
    or flax `.msgpack`; gauss2 when it has BatchNorm statistics) gives up
    to `good_num` mutual-NN matches (conf_thresh 1e-3); the solver from
    `pretrained` (`.pth.tar` or `.msgpack`), built from `config` at the
    frames' size, else DeepFNet(depth 5, if_quality); E = KᵀF̂K
    decomposed in float64 by cheirality voting (`recover_pose`), and the
    matches' epipolar distances to F̂. Returns (and writes to `out` as
    JSON) {R, t_unit, E, num_matches, epi_inlier_ratio_1px, epi_median_px,
    frontend}."""
    from .geometry.basic import homo
    from .geometry.decompose import recover_pose
    from .geometry.epipolar import F_to_E, epi_distance
    from .models import DeepFNet
    from .utils.image_io import read_grey

    if not pretrained_SP:
        raise NotImplementedError(f"infer without --pretrained_SP (the SIFT frontend) {SIFT_ITEM}")
    device = resolve_device(device)
    g1, g2 = read_grey(img1), read_grey(img2)
    H, W = g1.shape[:2]
    Kmat = read_intrinsics(K, H, W)
    sp_net = load_superpoint(pretrained_SP, device)
    imgs = torch.as_tensor(np.stack([g1, g2]).astype(np.float32) / 255.0, device=device)
    fp = FrontendParams(out_num_points=good_num, conf_thresh=1e-3)
    with torch.no_grad():
        sp_out = get_matches_from_sp(sp_net, (imgs[:1], imgs[1:]), fp)
    n_real = int(sp_out["valid"][0].sum())
    if n_real < 8:
        raise SystemExit(f"only {n_real} SuperPoint matches: the image pair does not suit this "
                         "frontend (try a lower conf threshold)")
    matches = sp_out["matches_xy_ori"][0].cpu().numpy()
    db = {"matches_xy_ori": sp_out["matches_xy_ori"][:1],
          "quality": sp_out["quality"][:1],
          "matches_good_unique_nums": torch.tensor([min(n_real, good_num)], device=device),
          "Ks": torch.as_tensor(Kmat, dtype=torch.float32, device=device)[None],
          "t_scene_scale": torch.ones((1, 1), device=device)}
    if config:
        cfg = load_config(config)
        cfg.data.resize = [H, W]
        net = model_loader(cfg, device)
    else:
        net = DeepFNet(depth=5, image_size=(H, W), if_quality=True).to(device).eval()
    load_checkpoint(pretrained, net)
    with torch.no_grad():
        outs = net(db)
        F_pix = outs["T2"].transpose(-1, -2) @ outs["F_est"] @ outs["T1"]
        E = F_to_E(F_pix, db["Ks"])
        K_inv_t = torch.as_tensor(np.linalg.inv(Kmat).T, device=device)
        m64 = torch.as_tensor(matches, dtype=torch.float64, device=device)
        rec = recover_pose(E.double(), (homo(m64[:, :2]) @ K_inv_t)[None],
                           (homo(m64[:, 2:4]) @ K_inv_t)[None])
        d = epi_distance(F_pix[0].double(), m64[:, :2], m64[:, 2:4])[0].cpu().numpy()
    result = {"R": rec.R[0].cpu().numpy().tolist(), "t_unit": rec.t[0].cpu().numpy().tolist(),
              "E": E[0].cpu().numpy().tolist(), "num_matches": n_real,
              "epi_inlier_ratio_1px": float(np.mean(d < 1.0)),
              "epi_median_px": float(np.median(d)), "frontend": "superpoint"}
    if out:
        with open(out, "w") as f:
            f.write(json.dumps(result))
    return result


def export_torch(config: str, checkpoint: str, out: str, n_iter: int = 0,
                 superpoint: bool = False) -> Dict:
    """A flax `.msgpack` checkpoint of the JAX package as the reference's
    `.pth.tar`: the solver of `config`'s architecture (loaded strictly), or
    with `superpoint` a SuperPointNetGauss2 with its BatchNorm statistics."""
    if superpoint:
        net = load_superpoint(checkpoint, "cpu")
        if not isinstance(net, SuperPointNetGauss2):
            raise ValueError(f"{checkpoint} holds no SuperPointNetGauss2 (no batch statistics)")
        save_superpoint(out, net, n_iter)
        return {"out": out, "n_iter": n_iter, "kind": "superpoint_gauss2"}
    net = model_loader(load_config(config), torch.device("cpu"))
    load_checkpoint(checkpoint, net)
    save_checkpoint(out, net, None, n_iter)
    return {"out": out, "n_iter": n_iter}


def verify_dump(dump_root: str, deltas: str = "1", min_matches: int = 8) -> Dict:
    """A dump tree's integrity check: per scene, the shapes of cam.npy,
    poses.npy and Rt_cam2_gt.npy, the match files of each delta, their
    match counts and missing frames. Exits 1 on a malformed tree."""
    root = Path(dump_root)
    scenes = sorted(d for d in root.iterdir() if d.is_dir())
    if not scenes:
        raise SystemExit(f"no scene directories under {root}")
    report = {"root": str(root), "scenes": {}}
    ok = True
    for scene in scenes:
        s = {"errors": []}
        report["scenes"][scene.name] = s
        try:
            K = np.load(scene / "cam.npy")
            s["K_shape"] = list(K.shape)
            if K.reshape(-1).shape[0] != 9:
                s["errors"].append("cam.npy is not 3x3")
            poses = np.load(scene / "poses.npy").reshape(-1, 3, 4)
            s["n_frames"] = int(len(poses))
            if not np.all(np.isfinite(poses)):
                s["errors"].append("poses.npy has non-finite entries")
            Rt2 = np.load(scene / "Rt_cam2_gt.npy")
            if Rt2.shape != (4, 4):
                s["errors"].append(f"Rt_cam2_gt shape {Rt2.shape}")
        except FileNotFoundError as e:
            s["errors"].append(f"missing: {e.filename}")
            ok = False
            continue
        for delta in (int(d) for d in deltas.split(",")):
            counts, missing = [], []
            for i in range(len(poses) - delta):
                base = scene / f"ij_match_quality_{i}-{i + delta}_good"
                if base.with_suffix(".npy").is_file():
                    counts.append(int(len(np.load(base.with_suffix(".npy")))))
                elif base.with_suffix(".h5").is_file():
                    counts.append(-1)  # present, not parsed here
                else:
                    missing.append(i)
            key = f"delta_{delta}"
            s[key] = {"pairs": len(counts), "missing": missing[:10], "n_missing": len(missing)}
            if counts and min(counts) >= 0:
                s[key]["matches_min"] = int(np.min(counts))
                s[key]["matches_median"] = float(np.median(counts))
                if np.min(counts) < min_matches:
                    s["errors"].append(f"delta {delta}: a pair has only {np.min(counts)} "
                                       f"matches (< {min_matches})")
            if delta == 1 and missing:
                s["errors"].append(f"delta 1: {len(missing)} missing pair files")
        ok = ok and not s["errors"]
    report["ok"] = ok
    print(json.dumps(report), flush=True)
    if not ok:
        raise SystemExit(1)
    return report


def tables(config: str, metrics: str = "", top_k: int = 1, latex: bool = False,
           plot: str = "") -> str:
    """Experiments side by side from their eval npz dumps (a table config
    YAML: data.base_path and data.seq_dict), as Markdown (and LaTeX, and
    a bar figure where matplotlib is installed); printed and returned."""
    import yaml

    from .eval.results import ExpTableProcessor

    with open(config) as f:
        tp = ExpTableProcessor.from_config(yaml.safe_load(f))
    names = tuple(metrics.split(",")) if metrics else ("err_q_median", "err_t_median")
    md = tp.to_markdown(names, top_k=top_k)
    print(md)
    if latex:
        print()
        print(tp.to_latex(names))
    if plot and tp.plot_metrics(names, save_path=plot) is not None:
        print(f"# wrote {plot}")
    return md


def baseline_gate(seq_dirs: Sequence[str], gt_dir: str, baseline: str = "deepF",
                  exp: str = "DeepF", filename: str = "err_ratio.npz", tol: float = 0.05,
                  lengths: str = "", strict: bool = False) -> Dict:
    """BASELINE.md's KITTI seq 09/10 verdict from eval_good output dirs
    (`seq=dir` each, holding `<exp>_<filename>` with relative_poses_body)
    and KITTI gt files `<gt_dir>/<seq>.txt`: each sequence chained and
    scored (`evaluate_sequence`), each metric passing at <= target * (1 +
    tol); a non-finite metric fails. Prints the table and the JSON report;
    with `strict` exits 1 on a failure."""
    targets_all = BASELINE_TARGETS[baseline]
    report = {"baseline": baseline, "tol": tol, "sequences": {}, "ok": True}
    rows = []
    kw = {"lengths": tuple(float(x) for x in lengths.split(","))} if lengths else {}
    for spec in seq_dirs:
        seq, _, d = spec.partition("=")
        if not d:
            raise SystemExit(f"seq_dirs entries are seq=dir, got {spec!r}")
        est = chain_relative_poses(np.load(Path(d) / f"{exp}_{filename}")["relative_poses_body"])
        gt = kitti_odometry.load_poses_txt(str(Path(gt_dir) / f"{seq}.txt"))
        n = min(len(gt), len(est))
        res = kitti_odometry.evaluate_sequence(gt[:n], est[:n], **kw)
        target = targets_all.get(seq, {})
        seq_rep = {"measured": res, "target": target, "deltas": {}, "pass": {}}
        for m in VO_METRICS:
            if m not in target:
                continue
            finite = bool(np.isfinite(res[m]))
            delta = res[m] - target[m] if finite else float("nan")
            ok = bool(finite and res[m] <= target[m] * (1.0 + tol))
            seq_rep["deltas"][m] = round(float(delta), 4)
            seq_rep["pass"][m] = ok
            report["ok"] = report["ok"] and ok
            rows.append((seq, m, res[m], target[m], delta, ok))
        report["sequences"][seq] = seq_rep
    print(f"# BASELINE gate vs {baseline} (tol {tol:+.0%} relative)")
    print("| seq | metric | ours | baseline | delta | verdict |")
    print("|---|---|---|---|---|---|")
    for seq, m, v, t, delta, ok in rows:
        print(f"| {seq} | {m} | {v:.3f} | {t:.3f} | {delta:+.3f} | {'PASS' if ok else 'FAIL'} |")
    print(json.dumps(report), flush=True)
    if strict and not report["ok"]:
        raise SystemExit(1)
    return report


def cmd_train(args) -> Dict[str, float]:
    cfg = load_config(args.config)
    last = train_good(cfg, args.exper_name, args.train_iter, args.pretrained,
                      args.profile_dir, args.device)
    print(json.dumps(last))
    return last


def cmd_eval(args) -> Dict[str, float]:
    cfg = load_config(args.config)
    summary = eval_good(cfg, args.max_batches, args.device, args.pretrained, args.exper_name,
                        args.refine_ba, args.refine_min_matches)
    summary["exper_name"] = args.exper_name
    print(json.dumps(summary))
    return summary


def cmd_val_feature(args) -> Dict[str, float]:
    summary = val_feature(args.exper_name, args.max_batches, args.pretrained, args.rand_noise,
                          args.config, args.homography, device=args.device)
    print(json.dumps(summary))
    return summary


def cmd_eval_vo(args) -> Dict[str, float]:
    report = eval_vo(load_config(args.config), args.exper_name, args.pretrained, args.baseline,
                     args.scene, args.n_frames,
                     [float(x) for x in args.lengths.split(",")] if args.lengths else None,
                     args.pose_graph, args.refine_ba, args.refine_min_matches, args.device)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in report.items()}))
    return report


def cmd_infer(args) -> Dict:
    out = infer(args.img1, args.img2, args.pretrained, args.pretrained_SP, args.K, args.config,
                args.good_num, args.out, args.device)
    print(json.dumps(out))
    return out


def cmd_export_torch(args) -> Dict:
    out = export_torch(args.config, args.checkpoint, args.out, args.n_iter, args.superpoint)
    print(json.dumps(out))
    return out


def cmd_verify_dump(args) -> Dict:
    return verify_dump(args.dump_root, args.deltas, args.min_matches)


def cmd_tables(args) -> str:
    return tables(args.config, args.metrics, args.top_k, args.latex, args.plot)


def cmd_baseline_gate(args) -> Dict:
    return baseline_gate(args.seq_dirs, args.gt_dir, args.baseline, args.exp, args.filename,
                         args.tol, args.lengths, args.strict)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepfepe_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train_good", help="train the solver (F-loss or qt-loss)")
    p.add_argument("config")
    p.add_argument("exper_name")
    p.add_argument("--train_iter", type=int, default=None)
    p.add_argument("--pretrained", default="")
    p.add_argument("--profile_dir", default="")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("eval_good", help="solver eval against gt and RANSAC")
    p.add_argument("config")
    p.add_argument("exper_name")
    p.add_argument("--max_batches", type=int, default=5,
                   help="batches to evaluate; 0 walks a dump tree's whole test split")
    p.add_argument("--pretrained", default="")
    p.add_argument("--refine_ba", action="store_true",
                   help="polish each pair's pose by two-view square-root BA before scoring")
    p.add_argument("--refine_min_matches", type=int, default=200,
                   help="polish only pairs with at least this many effective matches")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_eval)
    p = sub.add_parser("val_feature", help="frontend matches against gt epipolar geometry")
    p.add_argument("exper_name")
    p.add_argument("--config", default="")
    p.add_argument("--pretrained", default="")
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--rand_noise", type=float, default=0.0)
    p.add_argument("--homography", type=int, default=0)
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_val_feature)
    p = sub.add_parser("eval_vo", help="sequence VO: chain every pair, KITTI metrics")
    p.add_argument("config")
    p.add_argument("exper_name")
    p.add_argument("--pretrained", default="")
    p.add_argument("--scene", default="")
    p.add_argument("--n_frames", type=int, default=0)
    p.add_argument("--lengths", default="",
                   help="comma list of segment lengths (default: KITTI 100..800 m; 5..40 m on "
                        "the synthetic sequence)")
    p.add_argument("--baseline", action="store_true",
                   help="the RANSAC baseline in place of the net")
    p.add_argument("--pose_graph", action="store_true",
                   help="fuse a second sweep of (i, i + 2) pairs in the two-stage pose graph")
    p.add_argument("--refine_ba", action="store_true",
                   help="polish each pair's pose by two-view square-root BA (a pair keeps its "
                        "pose unless the polish lowers its robust cost)")
    p.add_argument("--refine_min_matches", type=int, default=200,
                   help="polish only pairs with at least this many effective matches")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_eval_vo)
    p = sub.add_parser("infer", help="two images -> relative pose JSON")
    p.add_argument("img1")
    p.add_argument("img2")
    p.add_argument("--pretrained", required=True,
                   help="DeepF checkpoint (reference .pth.tar or flax .msgpack)")
    p.add_argument("--pretrained_SP", default="", help="SuperPoint checkpoint")
    p.add_argument("--K", default="", help="fx,fy,cx,cy (default: 1.2 max(H, W), the centre)")
    p.add_argument("--config", default="", help="model config YAML (default: depth 5)")
    p.add_argument("--good_num", type=int, default=1000)
    p.add_argument("--out", default="", help="also write the JSON here")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_infer)
    p = sub.add_parser("export_torch", help="a flax .msgpack checkpoint as the reference "
                                            ".pth.tar")
    p.add_argument("config", help="model config YAML (ignored with --superpoint)")
    p.add_argument("checkpoint", help="the .msgpack checkpoint")
    p.add_argument("out", help="output .pth.tar path")
    p.add_argument("--n_iter", type=int, default=0)
    p.add_argument("--superpoint", action="store_true",
                   help="the checkpoint is a SuperPointNetGauss2 frontend")
    p.set_defaults(fn=cmd_export_torch)
    p = sub.add_parser("verify_dump", help="dump-tree integrity check")
    p.add_argument("dump_root")
    p.add_argument("--deltas", default="1", help="comma list of delta_ij gaps")
    p.add_argument("--min_matches", type=int, default=8)
    p.set_defaults(fn=cmd_verify_dump)
    p = sub.add_parser("tables", help="multi-experiment result tables")
    p.add_argument("config", help="table config YAML (data.base_path + data.seq_dict)")
    p.add_argument("--metrics", default="", help="comma list (default err_q_median,"
                                                 "err_t_median)")
    p.add_argument("--top_k", type=int, default=1)
    p.add_argument("--latex", action="store_true")
    p.add_argument("--plot", default="", help="save a bar figure here")
    p.set_defaults(fn=cmd_tables)
    p = sub.add_parser("baseline_gate", help="BASELINE.md's seq 09/10 verdict from eval_good "
                                             "output dirs")
    p.add_argument("seq_dirs", nargs="+", help="seq=dir pairs, e.g. 09=logs/eval09")
    p.add_argument("--gt_dir", required=True, help="dir with <seq>.txt KITTI gt trajectories")
    p.add_argument("--baseline", default="deepF", choices=sorted(BASELINE_TARGETS))
    p.add_argument("--exp", default="DeepF", help="npz prefix (exps.our_name)")
    p.add_argument("--filename", default="err_ratio.npz")
    p.add_argument("--tol", type=float, default=0.05)
    p.add_argument("--lengths", default="")
    p.add_argument("--strict", action="store_true")
    p.set_defaults(fn=cmd_baseline_gate)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
