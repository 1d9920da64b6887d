"""Command-line entry point of the port.

    python -m deepfepe_tpu_torch.cli train_good <config.yaml> <exper_name>
        [--train_iter k] [--pretrained ckpt.pth.tar] [--profile_dir dir]
        [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli eval_good <config.yaml> <exper_name>
        [--max_batches k] [--pretrained ckpt.pth.tar] [--device cpu|cuda]
    python -m deepfepe_tpu_torch.cli val_feature <exper_name> [--config c.yaml]
        [--max_batches k] [--pretrained sp.pth.tar] [--rand_noise s]
        [--device cpu|cuda]

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
package's summary keys as one JSON line. `val_feature` runs the
SuperPoint frontend on synthetic image pairs, or with `--config` on the
config's test split with its frames, and prints the share of matches
within 0.1, 0.5, 1 and 2 px of their ground-truth epipolar lines and the
match count, also written to logs/<exper_name>/result_dict_all.npz. All
default to the card; without one they raise unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from .data import KittiCorrDataset, SyntheticImagePairs
from .data.prefetch import prefetch_batches
from .eval import frontend_epidist_eval, val_rt_batch
from .frontend import (FrontendParams, SuperPointNet, SuperPointNetGauss2,
                       frontend_params_from_config)
from .frontend.superpoint import reset_superpoint
from .loader import data_loader, model_loader
from .train import (MetricLogger, Trainer, eval_step, load_checkpoint, load_config,
                    qt_clamps, save_checkpoint)
from .train.config import Config
from .train.joint import joint_train_step, make_joint_state
from .train.loop import scalars, start_profile, stop_profile
from .utils.device import batch_to_device, resolve_device
from .utils.weights import load_superpoint, save_superpoint

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
             pad_to: int | None = None) -> Dict[str, np.ndarray]:
    """Per-pair errors, poses and epipolar distances over `batch_iter`, with
    each batch's `Rt_cam2_gt` (identity where it has none). With `pad_to`,
    a shorter batch is padded to it and its padding trimmed (eval_good's
    tail, as the JAX CLI runs it). The RANSAC hypotheses of batch i are
    `ransac_idxs[i]` when given, else drawn from `generator`."""
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
    `pretrained_SP` unless `retrain_SP`; the solver seeded, or read from
    `pretrained` (else the config's unless `retrain`); both Adams at
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
    if not t.retrain_SP and t.pretrained_SP \
            and not t.pretrained_SP.endswith((".pth", ".pth.tar")):
        raise NotImplementedError("only reference .pth/.pth.tar SuperPoint checkpoints load; "
                                  ".msgpack files need flax (ROADMAP Queue 1 item 3)")
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
              exper_name: str = "") -> Dict[str, float]:
    """Weights seeded from `cfg.training.seed`, or read from a checkpoint
    (`pretrained`), on the config's test data (`eval_batches`). With
    `exper_name`, writes logs/<exper_name>/config.yml and the npz dumps."""
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
                   pad_to=cfg.data.batch_size)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    summary = summarize(res)
    summary["seconds"] = seconds
    summary["device"] = str(device)
    if exper_name:
        save_eval_dumps(cfg, res, _snapshot_config(cfg, exper_name))
    return summary


def val_feature(exper_name: str, max_batches: int = 0, pretrained: str = "",
                rand_noise: float = 0.0, config: str | Config = "", homography: int = 0,
                fp: FrontendParams | None = None, image_size=(120, 160), batch_size: int = 2,
                device=None) -> Dict[str, float]:
    """Frontend-only correspondence quality, `max_batches` batches (5 when
    0): on `SyntheticImagePairs(seed=0)` (the JAX CLI's stream) in batches of
    `batch_size` pairs, or with `config` (a YAML path or a Config) on its
    test split with the frames on, in order, in its batches, the last one
    short. SuperPoint from `pretrained` (a reference `.pth` or `.pth.tar`;
    gauss2 when it has BatchNorm keys) or seeded (seed 0); keypoints and
    mutual-NN matches under `fp`, else the config's SP_params, else the JAX
    CLI's FrontendParams(out_num_points=300, conf_thresh=1e-3). Returns the
    mean per batch of `ratio@{0.1,0.5,1.0,2.0}` and `num_matches`, with
    `pairs`, `seconds` (host clock over the frontend and its scoring, ending
    in a synchronize; data is made up front) and `device`."""
    device = resolve_device(device)
    if homography:
        raise NotImplementedError("val_feature --homography needs a numpy perspective warp in "
                                  "place of cv2, not ported yet (ROADMAP Queue 1 item 3)")
    if pretrained and not pretrained.endswith((".pth", ".pth.tar")):
        raise NotImplementedError("only reference .pth/.pth.tar SuperPoint checkpoints load; "
                                  ".msgpack files need flax (ROADMAP Queue 1 item 3)")
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
    accum: Dict[str, list] = {}
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
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    summary = {k: float(np.mean(v)) for k, v in accum.items()}
    save_dir = os.path.join("logs", exper_name)
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, "result_dict_all.npz"), **summary)
    summary.update(pairs=sum(len(b["Ks"]) for b in data), seconds=seconds, device=str(device))
    return summary


def cmd_train(args) -> Dict[str, float]:
    cfg = load_config(args.config)
    last = train_good(cfg, args.exper_name, args.train_iter, args.pretrained,
                      args.profile_dir, args.device)
    print(json.dumps(last))
    return last


def cmd_eval(args) -> Dict[str, float]:
    cfg = load_config(args.config)
    summary = eval_good(cfg, args.max_batches, args.device, args.pretrained, args.exper_name)
    summary["exper_name"] = args.exper_name
    print(json.dumps(summary))
    return summary


def cmd_val_feature(args) -> Dict[str, float]:
    summary = val_feature(args.exper_name, args.max_batches, args.pretrained, args.rand_noise,
                          args.config, args.homography, device=args.device)
    print(json.dumps(summary))
    return summary


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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
