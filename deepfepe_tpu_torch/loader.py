"""Dataset and model factories from a config.

Counterpart of `deepfepe_tpu/loader.py`: 'synthetic' (correspondences),
'synthetic_images' (image pairs, the joint SuperPoint path's data) and
the dump trees 'kitti_odo_corr', 'apollo', 'tum' and 'euroc'
(`data.kitti.KittiCorrDataset`, one pass per `.batches` call).
"""

from __future__ import annotations

import torch

from .data import KittiCorrDataset, SyntheticImagePairs, SyntheticPairs
from .models import DeepFNet
from .train.config import Config

TASK_SEEDS = {"train": 0, "val": 1, "test": 2}
DUMP_DATASETS = ("kitti_odo_corr", "apollo", "tum", "euroc")


def data_loader(cfg: Config, task: str = "train"
                ) -> SyntheticPairs | SyntheticImagePairs | KittiCorrDataset:
    """The dataset for `task`, seeded as in the JAX package: a synthetic
    stream (`.batches(batch_size)` is endless) or a dump tree's split of
    `data.dump_root` (one pass a call)."""
    d = cfg.data
    # Batches always carry the match tensors and the pose ground truth: a
    # config that turns them off is refused, not ignored.
    if not d.with_sift:
        raise ValueError("read_what.with_sift=false is not supported: the loader always "
                         "emits the match tensors (static-shape batches)")
    if not d.with_qt:
        raise ValueError("read_what.with_qt=false is not supported: q_cam/t_cam are always "
                         "derived from the pose tensors")
    if d.dataset in DUMP_DATASETS:
        scenes = {"train": d.train_scenes, "val": d.val_scenes, "test": d.test_scenes}.get(task)
        return KittiCorrDataset(
            d.dump_root, scenes=list(scenes) if scenes else None, delta_ij=d.delta_ij,
            good_num=d.good_num, image_size=tuple(d.image_size),
            resize=tuple(d.resize) if d.resize else None, seed=cfg.training.seed,
            with_imgs=d.with_imgs, img_gamma=d.with_imgs_gamma,
            with_matches_all=d.with_matches_all, all_num=d.all_num,
            with_sift_des=d.with_sift_des, use_h5=d.use_h5, with_X=d.with_X,
            cache_in_memory=d.cache_in_memory)
    seed = cfg.training.seed * 10 + TASK_SEEDS.get(task, 3)
    if d.dataset == "synthetic":
        return SyntheticPairs(image_size=tuple(d.image_size), good_num=d.good_num,
                              noise_px=d.noise_px, outlier_frac=d.outlier_frac, seed=seed)
    if d.dataset == "synthetic_images":
        return SyntheticImagePairs(image_size=tuple(d.resize or d.image_size), seed=seed)
    raise ValueError(f"unknown dataset {d.dataset!r}")


def model_loader(cfg: Config, device: torch.device,
                 generator: torch.Generator | None = None, train: bool = False) -> DeepFNet:
    """Build the solver net from the config with seeded parameters, in
    train or eval mode."""
    m = cfg.model
    net = DeepFNet(
        depth=m.depth, image_size=tuple(cfg.data.resize or cfg.data.image_size),
        if_quality=m.if_quality, quality_size=m.quality_size,
        mlp_dtype=torch.bfloat16 if m.mlp_dtype == "bfloat16" else torch.float32,
        if_learn_offsets=m.if_learn_offsets, if_img_w=m.if_img_w, if_des=m.if_des,
        des_size=m.des_size,
        if_tri_depth=m.if_tri_depth, if_sample_loss=m.if_sample_loss,
        if_goodCorresArch=m.if_goodCorresArch, use_pallas_mlp=m.use_pallas_mlp,
    )
    net.reset_parameters(generator)
    return net.to(device).train(train)
