"""Joint SuperPoint + DeepF training: one step through both nets.

Counterpart of `deepfepe_tpu/train/joint.py` (the reference's if_SP path,
Train_model_pipeline.train_val_batch :367-386, with its two optimizers and
the train / train_SP flags). The frontend runs in the same autograd graph
as the solver, so the loss reaches the SuperPoint weights through the
correspondences' soft-argmax offsets and the match quality.

Batches add 'imgs_grey' [B, 2, H, W] in [0, 1] to the solver batch keys.

A step differentiates both nets in both stages, as the JAX step does:
with `train_sp=False` (stage 1) the SuperPoint gradient still feeds
`g_sp_norm` and the update guard, and on the card its fused convs run K5
forward and K5b backward. BatchNorm (`bn_mode`, BatchNorm frontends only):

- 'train' (default, the reference's): while SuperPoint trains, its forward
  runs BatchNorm on batch statistics, one group a frame, and the running
  buffers take the momentum updates (in place, during the forward);
- 'frozen': BatchNorm on the running statistics, buffers untouched.

Stage 1 (`train_sp=False`) always runs BatchNorm on the running
statistics, as the reference puts the frozen net in eval mode.

The update guard skips both updates, and restores the BatchNorm buffers,
when the loss or a gradient norm is not finite or when the pair with the
fewest matches has fewer than `training.min_matches`. The optimizers never
see the buffers. With `JointState.grad_clip` > 0 each net's gradient is
clipped to that global norm before its Adam steps, as optax's
`clip_by_global_norm` chained before each Adam: g * max_norm / norm where
norm >= max_norm (torch's `clip_grad_norm_` adds 1e-6 to the norm and
would not give the same update).

Convolutions outside the K5 kernels: a float32 SuperPoint's step runs
under `exact_convs` (no TF32, no oneDNN, and on the card no cuDNN, whose
float32 weight gradient takes Winograd), so its plain convs are float32
without Winograd. A bf16 SuperPoint (`net.dtype`, the JAX package's
production point) takes the library's bf16 conv for its plain and module
convs, the counterpart of the JAX package's XLA convs: cuDNN on the card
(PyTorch's own CUDA conv, which `exact_convs` would fall back to, is an
im2col and a GEMM a layer), PyTorch's CPU conv on the CPU. Its step runs
under `full_f32` (TF32 and oneDNN off), which leaves cuDNN on
(`ops.conv.step_convs` picks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..frontend import FrontendParams, get_matches_from_sp
from ..ops.conv import step_convs
from .config import Config
from .engine import compute_losses, make_optimizer

BN_MODES = ("train", "frozen")


@dataclass
class JointState:
    """Both nets, their Adams, the per-net global-norm clip (0: none) and
    the step count."""

    deepf_net: torch.nn.Module
    sp_net: torch.nn.Module
    opt_deepf: torch.optim.Adam
    opt_sp: torch.optim.Adam
    n_iter: int = 0
    grad_clip: float = 0.0


def make_joint_state(deepf_net, sp_net, cfg: Config, lr_deepf: float | None = None,
                     lr_sp: float | None = None, grad_clip: float = 0.0) -> JointState:
    """Two Adams with optax's defaults at constant rates: `lr_deepf` and
    `lr_sp`, each `training.learning_rate` where not given (the JAX CLI's),
    each net clipped to `grad_clip` (the JAX `train_joint_full`'s
    `optax.chain(clip_by_global_norm, adam)` a net)."""
    opt_deepf, opt_sp = make_optimizer(deepf_net, cfg), make_optimizer(sp_net, cfg)
    for opt, lr in ((opt_deepf, lr_deepf), (opt_sp, lr_sp)):
        if lr is not None:
            for group in opt.param_groups:
                group["lr"] = lr
    return JointState(deepf_net, sp_net, opt_deepf, opt_sp, grad_clip=grad_clip)


def build_solver_batch(sp_out: Dict, batch: Dict) -> Dict:
    """The solver's batch: the frontend's correspondences and quality with
    the ground-truth tensors of `batch`."""
    db = dict(batch)
    db["matches_xy_ori"] = sp_out["matches_xy_ori"]
    db["quality"] = sp_out["quality"]
    db["matches_good_unique_nums"] = sp_out["valid"].sum(-1)
    return db


def global_norm(params) -> torch.Tensor:
    """optax.global_norm of the parameters' gradients."""
    return torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))


@torch.no_grad()
def clip_by_global_norm_(params, norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients in place: g / norm *
    max_norm where norm >= max_norm (`norm` their global norm)."""
    scale = norm >= max_norm
    for p in params:
        p.grad.copy_(torch.where(scale, p.grad / norm.to(p.grad.dtype) * max_norm, p.grad))


def _frames(batch):
    imgs = batch["imgs_grey"]
    return imgs[:, 0], imgs[:, 1]


def joint_train_step(state: JointState, batch: Dict[str, torch.Tensor], fp: FrontendParams,
                     cfg: Config, q_clamp: float, t_clamp: float, train_deepf: bool = True,
                     train_sp: bool = True, bn_mode: str = "train") -> Dict[str, torch.Tensor]:
    """One joint update of `state` in place; returns detached metrics with
    'num_matches', 'min_matches_item', 'g_deepf_norm', 'g_sp_norm' and
    'skipped_update'. Gradients stay in the parameters' `.grad`."""
    if bn_mode not in BN_MODES:
        raise ValueError(f"bn_mode must be one of {BN_MODES}, got {bn_mode!r}")
    deepf_net, sp_net = state.deepf_net, state.sp_net
    # The SuperPoint nets' only buffers are BatchNorm's.
    buffers = dict(sp_net.named_buffers())
    bn_train = bn_mode == "train" and train_sp and bool(buffers)
    saved = {k: v.clone() for k, v in buffers.items()} if bn_train else None
    deepf_net.train()
    sp_net.eval()
    deepf_params = [p for p in deepf_net.parameters() if p.requires_grad]
    sp_params = [p for p in sp_net.parameters() if p.requires_grad]
    for p in (*deepf_params, *sp_params):
        p.grad = None
    with step_convs(sp_net):
        sp_out = get_matches_from_sp(sp_net, _frames(batch), fp, bn_train=bn_train)
        loss, metrics = compute_losses(deepf_net, build_solver_batch(sp_out, batch), cfg,
                                       q_clamp, t_clamp)
        loss.backward()
    for p in (*deepf_params, *sp_params):
        # Parameters off the graph get a zero gradient, so every parameter
        # steps together, as optax steps every leaf.
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    per_item = sp_out["valid"].sum(-1).float()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["num_matches"] = per_item.mean()
    metrics["min_matches_item"] = per_item.min()
    metrics["g_deepf_norm"] = global_norm(deepf_params)
    metrics["g_sp_norm"] = global_norm(sp_params)
    ok = (torch.isfinite(loss) & torch.isfinite(metrics["g_deepf_norm"])
          & torch.isfinite(metrics["g_sp_norm"])
          & (metrics["min_matches_item"] >= float(cfg.training.min_matches)))
    metrics["skipped_update"] = (~ok).float()
    # One host read of one flag per step decides the updates.
    if bool(ok):
        for train, opt, params, norm in ((train_deepf, state.opt_deepf, deepf_params,
                                          metrics["g_deepf_norm"]),
                                         (train_sp, state.opt_sp, sp_params, metrics["g_sp_norm"])):
            if train:
                if state.grad_clip > 0:
                    clip_by_global_norm_(params, norm, state.grad_clip)
                opt.step()
    elif bn_train:
        with torch.no_grad():
            for k, v in saved.items():
                buffers[k].copy_(v)
    state.n_iter += 1
    return metrics


@torch.no_grad()
def joint_eval_step(deepf_net, sp_net, batch: Dict[str, torch.Tensor], fp: FrontendParams,
                    cfg: Config) -> Dict[str, torch.Tensor]:
    """Frontend (BatchNorm on running statistics) and solver with the final
    clamps of the curriculum; metrics with 'matches_xy' and 'num_matches'."""
    sp_net.eval()
    deepf_net.eval()
    sp_out = get_matches_from_sp(sp_net, _frames(batch), fp)
    t = cfg.training
    _, metrics = compute_losses(deepf_net, build_solver_batch(sp_out, batch), cfg,
                                float(t.clamp_q_params[-1]), float(t.clamp_t_params[-1]))
    metrics["matches_xy"] = sp_out["matches_xy_ori"]
    metrics["num_matches"] = sp_out["valid"].sum(-1).float().mean()
    return metrics
