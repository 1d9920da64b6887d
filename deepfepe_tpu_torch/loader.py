"""Dataset and model factories from a config.

Counterpart of `deepfepe_tpu/loader.py` for the synthetic datasets:
'synthetic' (correspondences) and 'synthetic_images' (image pairs, the
joint SuperPoint path's data).
"""

from __future__ import annotations

import torch

from .data import SyntheticImagePairs, SyntheticPairs
from .models import DeepFNet
from .train.config import Config

TASK_SEEDS = {"train": 0, "val": 1, "test": 2}


def data_loader(cfg: Config, task: str = "train") -> SyntheticPairs | SyntheticImagePairs:
    """The synthetic stream for `task`, seeded as in the JAX package;
    `.batches(batch_size)` is endless."""
    d = cfg.data
    seed = cfg.training.seed * 10 + TASK_SEEDS.get(task, 3)
    if d.dataset == "synthetic":
        return SyntheticPairs(image_size=tuple(d.image_size), good_num=d.good_num,
                              noise_px=d.noise_px, outlier_frac=d.outlier_frac, seed=seed)
    if d.dataset == "synthetic_images":
        return SyntheticImagePairs(image_size=tuple(d.resize or d.image_size), seed=seed)
    raise NotImplementedError(f"dataset {d.dataset!r} is not ported yet")


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
        if_tri_depth=m.if_tri_depth, if_sample_loss=m.if_sample_loss,
        if_goodCorresArch=m.if_goodCorresArch, use_pallas_mlp=m.use_pallas_mlp,
    )
    net.reset_parameters(generator)
    return net.to(device).train(train)
