"""Training and evaluation steps: loss composition, Adam, NaN guard.

Counterpart of `deepfepe_tpu/train/engine.py`:

  F-mode:  loss = loss_F (mean robust epi residual on virtual points)
           (+ loss_selected_F * balance_select_F with the sample loss)
  qt-mode: loss = loss_q * balance_q + loss_t * balance_t (replaces the
           F-loss, per Train_model_pipeline.py:575-589)

The optimizer is `torch.optim.Adam` with optax's defaults and the
reference's staircase decay. A non-finite loss or gradient skips the
whole update (parameters and Adam state, step count included, keep their
values), as does the skip-optimizer on an already solved batch. The
sample loss draws its subsets from the caller's generator.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..losses import f_loss, rt_loss
from .config import Config


def make_optimizer(net: torch.nn.Module, cfg: Config) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8); its rate is
    set before each update by `learning_rate`."""
    return torch.optim.Adam(net.parameters(), lr=cfg.training.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def learning_rate(cfg: Config, count: int) -> float:
    """The reference's step decay (Train_model_pipeline.adjust_learning_rate
    :118-139) as optax's staircase exponential decay over `count`, the
    number of updates applied so far."""
    t = cfg.training
    if t.lr_decay_rate == 1.0:
        return t.learning_rate
    return t.learning_rate * t.lr_decay_rate ** (count // (t.lr_decay_step * 1000))


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates applied so far: Adam's step count (every parameter steps
    together, see `train_step`)."""
    state = opt.state.get(opt.param_groups[0]["params"][0], {})
    return int(state["step"]) if "step" in state else 0


def compute_losses(net, batch: Dict[str, torch.Tensor], cfg: Config, q_clamp: float,
                   t_clamp: float, generator: torch.Generator | None = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and loss composition; returns (scalar loss, metrics).
    `generator` draws the sample loss's subsets (DeepFNet's seed-0
    generator when None, as the JAX package's PRNGKey(0))."""
    mcfg = cfg.model
    outs = net(batch, generator)
    ld = f_loss(outs, batch["pts1_virt"], batch["pts2_virt"], batch["Ks"], mcfg.clamp_at)
    metrics = {k: ld[k] for k in ("loss_F", "loss_layers", "loss_min_batch", "loss_epi_res")}
    loss = ld["loss_F"]
    if "loss_selected_F" in ld:
        loss = loss + ld["loss_selected_F"] * mcfg.balance_select_F
        metrics["loss_selected_F"] = ld["loss_selected_F"]
    if mcfg.if_qt_loss:
        R_gt = torch.linalg.inv(batch["delta_Rtijs_4_4"])[..., :3, :3]
        rd = rt_loss(ld["E_ests_layers"], batch["q_cam"], batch["t_cam"], R_gt,
                     loss_q_clamp=q_clamp, loss_t_clamp=t_clamp)
        loss = rd["loss_q"] * mcfg.balance_q + rd["loss_t"] * mcfg.balance_t
        metrics.update({
            "loss_q": rd["loss_q"],
            "loss_t": rd["loss_t"],
            "R_angle_error_mean": rd["R_angle_error_mean"],
            "t_angle_error_mean": rd["t_angle_error_mean"],
            # Per-item unclamped final-layer errors [B], for quantile-tied
            # clamp scheduling (train/clamp.py).
            "q_l2_final": rd["q_l2_layers"][-1],
            "t_l2_final": rd["t_l2_layers"][-1],
        })
    metrics["loss"] = loss
    metrics["E_ests"] = ld["E_ests"]
    metrics["F_ests"] = ld["F_ests"]
    metrics["weights"] = outs["weights"]
    return loss, metrics


def train_step(net, opt: torch.optim.Optimizer, batch: Dict[str, torch.Tensor], cfg: Config,
               q_clamp: float, t_clamp: float, generator: torch.Generator | None = None
               ) -> Dict[str, torch.Tensor]:
    """One update of `net` and `opt` in place; returns detached metrics with
    'nonfinite' (and 'skipped' when the skip-optimizer is on). `generator`
    draws the step's sample-loss subsets."""
    net.train()
    opt.zero_grad(set_to_none=True)
    loss, metrics = compute_losses(net, batch, cfg, q_clamp, t_clamp, generator)
    loss.backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        # Parameters off the graph (the hidden biases on the fused MLP
        # route) get a zero gradient, so every parameter steps together and
        # Adam's state matches optax's, which steps every leaf.
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ok = torch.isfinite(loss) & torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
    apply = ok
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["nonfinite"] = (~ok).float()
    if cfg.training.skip_optimizer_enable:
        # The batch is already solved (Train_model_pipeline.py:598-639).
        skip = metrics["loss_min_batch"].min() <= cfg.training.skip_optimizer_epi_min
        apply = apply & ~skip
        metrics["skipped"] = skip
    # One host read of one flag per step decides whether Adam steps.
    if bool(apply):
        for group in opt.param_groups:
            group["lr"] = learning_rate(cfg, update_count(opt))
        opt.step()
    return metrics


@torch.no_grad()
def eval_step(net, batch: Dict[str, torch.Tensor], cfg: Config) -> Dict[str, torch.Tensor]:
    """Forward and losses with the final clamps of the curriculum (the sample
    loss's subsets drawn from DeepFNet's seed-0 generator)."""
    t = cfg.training
    return compute_losses(net, batch, cfg, float(t.clamp_q_params[-1]),
                          float(t.clamp_t_params[-1]))[1]
