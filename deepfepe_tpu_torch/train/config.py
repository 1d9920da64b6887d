"""Typed configuration mirroring the reference YAML schema.

A copy of the dataclasses of `deepfepe_tpu/train/config.py` (the port
imports nothing of the JAX package). `yaml` is imported only inside
`load_config`. Some fields (the TPU loader's, the Pallas MLP switch) are
read by the JAX package only; they are kept so that one YAML file serves
both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class DataConfig:
    dataset: str = "synthetic"
    dump_root: str = ""
    sequence_length: int = 2
    delta_ij: int = 1
    batch_size: int = 4
    good_num: int = 1000
    image_size: Tuple[int, int] = (376, 1241)  # (H, W)
    resize: Optional[Tuple[int, int]] = (376, 1240)
    with_quality: bool = True
    with_pose: bool = True
    # read_what.with_imgs / with_imgs_gamma (kitti_odo_corr.py:240-262):
    # grayscale frames for the SP path; gamma != None perturbs them
    # (robustness studies, kitti_corr_baselineEval.yaml:22-23).
    with_imgs: bool = False
    with_imgs_gamma: Optional[float] = None
    # The un-ratio-tested 2000-match set (kitti_odo_corr.py:452-480).
    with_matches_all: bool = False
    all_num: int = 2000
    # Per-match SIFT descriptor pairs for the if_des fusion variants
    # (read_what.with_sift_des, kitti_odo_corr.py:513-521).
    with_sift_des: bool = False
    # read_params.use_h5 (kitti_odo_corr.py:80): .h5 payload files.
    use_h5: bool = False
    # read_what.with_X (kitti_odo_corr.py:155-176): lidar point clouds.
    with_X: bool = False
    # read_what.with_sift / with_qt (kitti_odo_corr.py:74-79): the TPU
    # loader always emits the match tensors and the q/t ground truth
    # (static-shape batches want the full schema); turning either OFF is
    # rejected loudly in loader.data_loader rather than silently no-oped.
    with_sift: bool = True
    with_qt: bool = True
    # read_what.with_SP (kitti_odo_corr.py:76): SuperPoint-frontend dump
    # trees. Our SP dump creator (data/dump_kitti.dump_sequence_sp)
    # writes the SAME per-pair ij file layout as the SIFT dumps, so the
    # one reader serves both; the flag only documents the tree's origin.
    with_SP: bool = False
    # data.cache_in_memory (kitti_odo_corr.py:40): memoize per-pair npy
    # payloads after first read (the reference caches decoded samples in
    # the torch Dataset). Default False: the native C++ prefetch loader
    # usually hides read latency without the RSS cost.
    cache_in_memory: bool = False
    # data.base_path (table configs): result-tree root for the
    # Exp_table_processor equivalent (cli tables / eval/results.py).
    base_path: str = ""
    # Per-task scene lists for dump datasets (ref: per-task {train,val}.txt
    # frame lists + eval configs pinning seqs 09/10, kitti_odo_corr.py:100).
    # None -> crawl every scene directory under dump_root.
    train_scenes: Optional[Sequence[str]] = None
    val_scenes: Optional[Sequence[str]] = None
    test_scenes: Optional[Sequence[str]] = None
    # synthetic-only knobs
    noise_px: float = 0.5
    outlier_frac: float = 0.15


@dataclass
class ModelConfig:
    name: str = "DeepFNet"
    depth: int = 5
    clamp_at: float = 0.02
    if_quality: bool = False
    quality_size: int = 1
    if_img_w: bool = False
    if_goodCorresArch: bool = False
    if_learn_offsets: bool = False
    if_tri_depth: bool = False
    if_qt_loss: bool = False
    if_sample_loss: bool = False
    # if_cpu_svd (DeepFNet.py:219-230): the reference's CPU round-trip
    # workaround for MAGMA SVD instability. Accepted and intentionally a
    # no-op here: the TPU solver is a batched 9x9 Gram eigensolve with a
    # degenerate-safe custom VJP (ops/eigh.py) — there is no GPU/CPU SVD
    # split to choose between.
    if_cpu_svd: bool = True
    if_des: bool = False
    des_size: int = 0
    if_SP: bool = False
    balance_q: float = 1.0
    balance_t: float = 0.1
    balance_F: float = 100.0
    balance_select_F: float = 0.1
    # MLP matmul compute dtype: 'bfloat16' (full-rate MXU) or 'float32'.
    mlp_dtype: str = "bfloat16"
    # Fused Pallas MLP kernel (TPU; needs bfloat16). Wins MLP
    # microbenchmarks; full-step parity with XLA at bench shapes — see
    # ops/pallas/mlp_pallas.py docstring for the measured analysis.
    use_pallas_mlp: bool = False


@dataclass
class ExpsConfig:
    five_point: bool = False
    base_name: str = "opencv_8p"
    our_name: str = "DeepF"
    filename: str = "err_ratio.npz"


@dataclass
class TrainingConfig:
    learning_rate: float = 1e-4
    lr_decay_step: int = 10
    lr_decay_rate: float = 1.0
    train_iter: int = 100_000
    val_interval: int = 200
    # Val-in-train telemetry (Train_model_pipeline.py:197-233 +
    # configs/kitti_corr_baseline.yaml:81): every N training steps,
    # run the full val-metric computation on the next `val_batches`
    # TRAINING batches and flush under the 'training' task — pose-error
    # telemetry on the training distribution. 0 disables (reference
    # default 1000).
    val_interval_in_train: int = 0
    val_batches: int = 10
    save_interval: int = 200
    # First-party tfevents scalars under <save_dir>/runs (the reference's
    # `tensorboard --logdir runs/train_good` workflow, README.md:244-247).
    tensorboard: bool = True
    # Profiling (SURVEY.md §5.1 — new subsystem, absent in the reference):
    # if profile_dir is set, Trainer.fit captures an xprof device trace of
    # iterations [profile_start, profile_start + profile_steps).
    profile_dir: str = ""
    profile_start: int = 5
    profile_steps: int = 10
    seed: int = 0
    reproduce: bool = False
    retrain: bool = True
    train: bool = True
    pretrained: str = ""
    # SP-side checkpoint/flag set (train_good.py:230-251 prepare_model
    # net_postfix='_SP'; consumed by the cli joint path when
    # model.if_SP): pretrained_SP loads the frontend (msgpack or
    # reference .pth.tar), retrain_SP=True starts it fresh, train_SP
    # gates its optimizer (stage-1 frozen vs stage-2 end-to-end).
    pretrained_SP: str = ""
    retrain_SP: bool = True
    train_SP: bool = False
    # reset_iter[_SP] (train_good.py:331-334): zero the restored
    # iteration counter after loading a checkpoint.
    reset_iter: bool = False
    reset_iter_SP: bool = False
    # SP_params (train_good.py:199-206): the frontend post-processing
    # knobs, mapped to frontend.FrontendParams by the joint path.
    sp_params: dict = field(default_factory=dict)
    # val_show_interval (Train_model_pipeline TB image cadence): gate the
    # val-inspection images to validations whose window crosses a
    # multiple of this many training steps.
    val_show_interval: int = 100
    # workers_train/val (utils/loader.py:81-102 DataLoader workers): the
    # TPU input pipeline is a threaded/native prefetch; the knob bounds
    # its queue depth.
    workers_train: int = 16
    workers_val: int = 2
    # qt-loss clamp curriculum (Train_model_pipeline.py:467-489)
    clamp_iter1: int = 3000
    clamp_iter2: int = 6000
    clamp_q_params: Sequence[float] = (0.1, 0.01, 0.001)
    clamp_t_params: Sequence[float] = (0.5, 0.3, 0.1)
    # skip-optimizer quirk (Train_model_pipeline.py:598-639)
    skip_optimizer_enable: bool = False
    skip_optimizer_epi_min: float = 0.001
    # Joint-step match-count floor (check_num_of_matches thd=100,
    # Train_model_pipeline.py:113-115). 0 disables (default: the synthetic
    # recipes tolerate sparse early frontends).
    min_matches: float = 0.0


@dataclass
class Config:
    name: str = "kitti_odo_good_corr"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    exps: ExpsConfig = field(default_factory=ExpsConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def config_from_dict(raw: dict) -> Config:
    """Build a Config from a reference-layout YAML dict (lenient)."""
    data_raw = dict(raw.get("data", {}))
    if "image" in data_raw and isinstance(data_raw["image"], dict):
        size = data_raw["image"].get("size")
        if size:
            data_raw["image_size"] = tuple(size[:2])
    if "preprocessing" in data_raw and isinstance(data_raw["preprocessing"], dict):
        rs = data_raw["preprocessing"].get("resize")
        if rs:
            data_raw["resize"] = tuple(rs[:2])
    rp = data_raw.get("read_params", {})
    if isinstance(rp, dict):
        data_raw.setdefault("use_h5", rp.get("use_h5", False))
    rw = data_raw.get("read_what", {})
    if isinstance(rw, dict):
        data_raw.setdefault("with_quality", rw.get("with_quality", True))
        data_raw.setdefault("with_pose", rw.get("with_pose", True))
        data_raw.setdefault("with_imgs", rw.get("with_imgs", False))
        data_raw.setdefault(
            "with_matches_all", rw.get("with_matches_all", False)
        )
        data_raw.setdefault(
            "with_sift_des", rw.get("with_sift_des", False)
        )
        data_raw.setdefault("with_X", rw.get("with_X", False))
        data_raw.setdefault("with_sift", rw.get("with_sift", True))
        data_raw.setdefault("with_qt", rw.get("with_qt", True))
        data_raw.setdefault("with_SP", rw.get("with_SP", False))
        gamma = rw.get("with_imgs_gamma")
        # The reference treats gamma 1 as a no-op perturbation.
        data_raw.setdefault(
            "with_imgs_gamma", None if gamma in (None, 1, 1.0) else gamma
        )

    model_raw = dict(raw.get("model", {}))
    # Reference aliases (train_good.py:182-184): if_img_feat feeds
    # per-point image features to the weight net (our if_img_w),
    # if_img_des_to_pointnet is the descriptor-fusion switch (if_des).
    if "if_img_feat" in model_raw:
        model_raw.setdefault("if_img_w", model_raw["if_img_feat"])
    if "if_img_des_to_pointnet" in model_raw:
        model_raw.setdefault("if_des", model_raw["if_img_des_to_pointnet"])
    # if_lidar_corres is broken in the reference itself (the loader logs
    # 'Not loading if_lidar_corres!' and continues,
    # kitti_odo_corr.py:374); reject it loudly instead of no-oping.
    if model_raw.get("if_lidar_corres"):
        raise ValueError(
            "model.if_lidar_corres is not supported (the reference's own "
            "loader cannot load it — kitti_odo_corr.py:374); use "
            "data.read_what.with_X for lidar point clouds"
        )

    train_raw = dict(raw.get("training", {}))
    skip = train_raw.get("skip_optimizer")
    if isinstance(skip, dict):
        train_raw["skip_optimizer_enable"] = skip.get("enable", False)
        train_raw["skip_optimizer_epi_min"] = skip.get("params", {}).get(
            "epi_min", 0.001
        )
    if "SP_params" in train_raw and isinstance(train_raw["SP_params"], dict):
        train_raw["sp_params"] = dict(train_raw["SP_params"])

    return Config(
        name=raw.get("name", "exp"),
        data=DataConfig(**_filter_kwargs(DataConfig, data_raw)),
        model=ModelConfig(**_filter_kwargs(ModelConfig, model_raw)),
        exps=ExpsConfig(**_filter_kwargs(ExpsConfig, dict(raw.get("exps", {})))),
        training=TrainingConfig(**_filter_kwargs(TrainingConfig, train_raw)),
    )


def load_config(path: str) -> Config:
    """A YAML config, or a JSON one (`.json`: no YAML reader needed)."""
    with open(path) as f:
        if str(path).endswith(".json"):
            return config_from_dict(json.load(f))
        import yaml

        return config_from_dict(yaml.safe_load(f))



def qt_clamps(cfg: TrainingConfig, n_iter: int) -> Tuple[float, float]:
    """The qt-loss clamp curriculum (Train_model_pipeline.py:475-489)."""
    if n_iter < cfg.clamp_iter1:
        i = 0
    elif n_iter < cfg.clamp_iter2:
        i = 1
    else:
        i = 2
    return float(cfg.clamp_q_params[i]), float(cfg.clamp_t_params[i])
