"""The SuperPoint -> DeepF pipeline as the joint and VO tools build it.

Shared by `train_joint_full`, `eval_joint_ckpts`, `vo_superpoint` and
`vo_pose_graph`, as the JAX package's tools build it: the solver at depth
5 with the quality feature and a bf16 weight MLP, sized to the frames; the
frontend's K (`npts`), detector threshold and matcher threshold; on the
card the frontend takes the hand-written kernels (K5 on its layers of >=
16,384 pixels, K4 for every match). Checkpoints are the reference's
`.pth.tar` or the JAX package's flax `.msgpack`.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ..data import SyntheticImageSequence
from ..eval import val_rt_batch
from ..frontend import FrontendParams, SuperPointNet, SuperPointNetGauss2
from ..frontend.superpoint import reset_superpoint
from ..loader import model_loader
from ..train import load_checkpoint
from ..train.config import Config
from ..train.joint import joint_eval_step
from ..utils.device import batch_to_device
from ..utils.weights import load_superpoint


def solver_config(npts: int, batch: int, image: Tuple[int, int]) -> Config:
    """The tools' solver: depth 5, the quality feature, a bf16 weight MLP,
    N = `npts`, frames of size `image`."""
    cfg = Config()
    cfg.model.depth = 5
    cfg.model.if_quality = True
    cfg.model.mlp_dtype = "bfloat16"
    cfg.data.good_num = npts
    cfg.data.batch_size = batch
    cfg.data.resize = list(image)
    return cfg


def frontend_params(npts: int, conf: float, nn_thresh: float) -> FrontendParams:
    return FrontendParams(out_num_points=npts, conf_thresh=conf, nn_thresh=nn_thresh,
                          conv_impl="pallas", matcher="pallas")


def load_solver(cfg: Config, path: str, device) -> torch.nn.Module:
    """The solver from `path`, or seeded (generator seed 1, the JAX tools'
    PRNGKey(1) place) when `path` is empty; in eval mode."""
    net = model_loader(cfg, device, torch.Generator().manual_seed(1))
    if path:
        load_checkpoint(path, net)
    return net


def load_frontend(path: str, device, gauss2: bool = False) -> torch.nn.Module:
    """A SuperPointNet, or with `gauss2` the bf16 SuperPointNetGauss2 (the
    JAX tools' production frontend), from `path`, or seeded (generator seed
    0) when `path` is empty; in eval mode. A file of the other kind raises."""
    dtype = torch.bfloat16 if gauss2 else torch.float32
    if not path:
        net = SuperPointNetGauss2(dtype=dtype) if gauss2 else SuperPointNet()
        return reset_superpoint(net, torch.Generator().manual_seed(0)).to(device).eval()
    net = load_superpoint(path, device, dtype=dtype)
    if isinstance(net, SuperPointNetGauss2) != gauss2:
        raise ValueError(f"{path} holds a {type(net).__name__}; "
                         f"{'pass --gauss2' if not gauss2 else 'drop --gauss2'}")
    return net


def sequence(n_frames: int, image: Tuple[int, int], step_scale: float, n_corners: int,
             seed: int) -> SyntheticImageSequence:
    """The tools' sequence: focal 140 px per 160 of width, a step sized so
    the trajectory stays within the scene depth."""
    return SyntheticImageSequence(
        n_frames=n_frames, image_size=image, focal=140.0 * image[1] / 160.0,
        step_length=step_scale * min(0.12, 0.6 * 12.0 / n_frames),
        n_corners=n_corners, seed=seed)


def pair_sweep(seq: SyntheticImageSequence, batch_size: int, deepf_net, sp_net,
               fp: FrontendParams, cfg: Config, device, delta: int = 1, ransac: bool = False,
               generator: torch.Generator | None = None) -> Iterator[tuple]:
    """(numpy batch, eval-step metrics, val_rt outputs) for each batch of
    (i, i + delta) pairs; with `ransac` the RANSAC baseline on the same
    matches, its draws from `generator`."""
    for batch in seq.pair_batches(batch_size, delta=delta):
        b = batch_to_device(batch, device)
        m = joint_eval_step(deepf_net, sp_net, b, fp, cfg)
        with torch.no_grad():
            rt = val_rt_batch(m["E_ests"], b["Ks"], m["matches_xy"], b["E_gts"],
                              b["delta_Rtijs_4_4"], ransac=ransac, generator=generator)
        yield batch, m, rt
