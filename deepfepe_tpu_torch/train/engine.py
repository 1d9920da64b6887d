"""The evaluation step: forward and F-loss composition.

Counterpart of `compute_losses` / `make_eval_step` in
`deepfepe_tpu/train/engine.py`, F-mode only. The qt-loss and sample-loss
modes, and the training step, come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..losses import f_loss
from .config import Config


def compute_losses(net, batch: Dict[str, torch.Tensor], cfg: Config
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + F-loss; returns (loss, metrics)."""
    mcfg = cfg.model
    if mcfg.if_qt_loss or mcfg.if_sample_loss:
        raise NotImplementedError("the qt and sample losses are not ported yet")
    outs = net(batch)
    ld = f_loss(outs, batch["pts1_virt"], batch["pts2_virt"], batch["Ks"], mcfg.clamp_at)
    metrics = {k: ld[k] for k in ("loss_F", "loss_layers", "loss_min_batch",
                                  "loss_epi_res", "E_ests", "F_ests")}
    metrics["loss"] = ld["loss_F"]
    metrics["weights"] = outs["weights"]
    return ld["loss_F"], metrics


@torch.no_grad()
def eval_step(net, batch: Dict[str, torch.Tensor], cfg: Config) -> Dict[str, torch.Tensor]:
    return compute_losses(net, batch, cfg)[1]
