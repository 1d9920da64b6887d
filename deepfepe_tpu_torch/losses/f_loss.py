"""F-loss over the solver layers, and the residual/weight summaries.

Counterpart of `deepfepe_tpu/losses/f_loss.py`: per layer, the robust
epipolar residual of the virtual gt-consistent points (moved into the
solver's normalized frame) against that layer's F; plus the per-layer
essential matrices E = Kᵀ T2ᵀ F_l T1 K, the weighted epi-res auxiliary
and, for the sample-loss variant, the residual of every sampled
hypothesis at clamp 0.02.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..geometry.epipolar import compute_epi_residual


def f_loss(outs: Dict[str, Any], pts1_virt, pts2_virt, Ks, clamp_at: float) -> Dict[str, Any]:
    """Returns loss_F, loss_layers, losses_layers, loss_min_layers,
    loss_min_batch, E_ests_layers, E_ests, F_ests and loss_epi_res; with
    the sample loss's outputs also loss_selected_layers [L] and
    loss_selected_F."""
    T1, T2 = outs["T1"], outs["T2"]
    out_layers = outs["out_layers"]  # [L, B, 3, 3]
    pts1_eval = pts1_virt @ T1.transpose(-1, -2)
    pts2_eval = pts2_virt @ T2.transpose(-1, -2)
    losses = compute_epi_residual(pts1_eval[None], pts2_eval[None], out_layers,
                                  clamp_at=clamp_at)  # [L, B, V]
    loss_layers = losses.mean(dim=(-1, -2))
    loss_min_batch_lb = losses.mean(dim=-1)  # [L, B]

    Kt = Ks.transpose(-1, -2)
    T2t = T2.transpose(-1, -2)
    E_ests_layers = Kt[None] @ T2t[None] @ out_layers @ T1[None] @ Ks[None]
    F_ests = T2t @ outs["F_est"] @ T1
    E_ests = Kt @ F_ests @ Ks

    L = out_layers.shape[0]
    if L > 1:
        loss_epi_res = (outs["epi_res_layers"] * outs["weights_layers"][: L - 1]).mean(
            dim=(-1, -2)).mean()
    else:
        loss_epi_res = torch.zeros((), dtype=out_layers.dtype, device=out_layers.device)
    out = {
        "loss_F": loss_layers.mean(),
        "loss_layers": loss_layers,
        "losses_layers": losses,
        "loss_min_layers": loss_min_batch_lb.min(dim=1).values,
        "loss_min_batch": loss_min_batch_lb.min(dim=0).values,
        "E_ests_layers": E_ests_layers,
        "E_ests": E_ests,
        "F_ests": F_ests,
        "loss_epi_res": loss_epi_res,
    }
    if "out_sample_selected_layers" in outs:
        # The sample loss's auxiliary: the mean clamped residual of every
        # sampled hypothesis on the virtual points, [L, B, S, V] (K3's
        # largest call on the card).
        sel = compute_epi_residual(pts1_eval[None, :, None], pts2_eval[None, :, None],
                                   outs["out_sample_selected_layers"], clamp_at=0.02)
        out["loss_selected_layers"] = sel.mean(dim=(-1, -2, -3))
        out["loss_selected_F"] = out["loss_selected_layers"].mean()
    return out


def unique_topk(xs: torch.Tensor, topk: int, unique_nums: torch.Tensor) -> torch.Tensor:
    """Top-k over the first `unique_nums[b]` entries of each row of [B, N]."""
    idx = torch.arange(xs.shape[-1], device=xs.device)
    mask = idx[None, :] < unique_nums[..., None]
    masked = torch.where(mask, xs, torch.full_like(xs, -torch.inf))
    return torch.topk(masked, topk, dim=-1).values


def residual_summaries(outs: Dict[str, Any], topk: int, unique_nums: torch.Tensor,
                       regw_thres: float = 0.01) -> Dict[str, torch.Tensor]:
    """Residual-norm and weight regularizer summaries."""
    residual_layers = outs["residual_layers"]  # [L, B, N]
    weights_layers = outs["weights_layers"]    # [L, B, N]
    L, N = residual_layers.shape[0], residual_layers.shape[-1]
    res_norms = torch.linalg.vector_norm(residual_layers, dim=-1)
    res_topk = unique_topk(residual_layers.abs().reshape(-1, N), topk, unique_nums.repeat(L))
    loss_regw_clip = torch.clamp(weights_layers - regw_thres, min=0.0).mean() * 100.0
    p = weights_layers / (weights_layers.sum(dim=-1, keepdim=True) + 1e-12)
    entropy = -(p * torch.log(p + 1e-12)).sum(dim=-1)
    w_topk = unique_topk(weights_layers.reshape(-1, N), topk, unique_nums.repeat(L))
    p_topk = w_topk / (w_topk.sum(dim=-1, keepdim=True) + 1e-12)
    entropy_topk = -(p_topk * torch.log(p_topk + 1e-12)).sum(dim=-1)
    return {
        "loss_residual": res_norms.mean(),
        "loss_residual_max": res_norms.max(),
        "loss_residual_topK": res_topk.mean(),
        "loss_regW_clip": loss_regw_clip,
        "loss_regW_entro": entropy.mean(),
        "loss_regW_entro_topK": entropy_topk.mean(),
    }
