"""DeepFNet: the iterative weighted 8-point network.

Counterpart of the base recurrence of `deepfepe_tpu/models/deepfnet.py`:

  weight_in = [(pts1+1)/2, (pts2+1)/2 (, quality)]
  logits    = input_weights(weight_in); w = softmax_N
  repeat depth-1 times:
      F_l, residual = weighted_eight_point(pts1, pts2, w)
      epi_res       = compute_epi_residual(pts1, pts2, F_l)
      logits        = update_weights([weight_in, w, epi_res, residual])
      w             = softmax_N(logits)
  final fit

Each fit is one 9x9 eigh, so a forward of depth d launches the eigh9
kernel d times on the card. With `use_pallas_mlp` (and bfloat16 MLPs)
both weight MLPs take the fused route, so a forward also calls the K2
kernel d times, and a backward K2b d times. The variant flags (learned offsets, image
weights, descriptors, triangulated depth, sample loss, GoodCorresNet)
raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..geometry.epipolar import compute_epi_residual, normalize_hw
from ..ops.fmatrix import weighted_eight_point
from .error_estimator import ErrorEstimator

_UNPORTED = ("if_learn_offsets", "if_img_w", "if_des", "if_tri_depth",
             "if_sample_loss", "if_goodCorresArch")


class DeepFNet(nn.Module):
    """Input dict: 'matches_xy_ori' [B, N, 4] pixel correspondences and,
    with `if_quality`, 'quality' [B, N, >=quality_size]. Returns the
    per-layer outputs stacked as in the JAX package."""

    def __init__(self, depth: int = 5, image_size=(376, 1241), if_quality: bool = False,
                 quality_size: int = 1, feature_clamp_at: float = 0.5,
                 normalize_svd: bool = True, mlp_dtype: torch.dtype = torch.float32,
                 sign_canonical: bool = False, use_pallas_mlp: bool = False, **flags):
        super().__init__()
        for name, value in flags.items():
            if name not in _UNPORTED:
                raise TypeError(f"unknown DeepFNet option {name!r}")
            if value:
                raise NotImplementedError(f"DeepFNet {name} is not ported yet")
        self.depth = depth
        self.image_size = tuple(image_size)
        self.if_quality = if_quality
        self.quality_size = quality_size
        self.feature_clamp_at = feature_clamp_at
        self.normalize_svd = normalize_svd
        self.sign_canonical = sign_canonical
        in_ch = 4 + (quality_size if if_quality else 0)
        self.input_weights = ErrorEstimator(in_ch, 1, dtype=mlp_dtype,
                                            use_fused=use_pallas_mlp)
        self.update_weights = ErrorEstimator(in_ch + 3, 1, dtype=mlp_dtype,
                                             use_fused=use_pallas_mlp)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.input_weights.reset_parameters(generator)
        self.update_weights.reset_parameters(generator)

    def _get_input(self, data_batch):
        pts = data_batch["matches_xy_ori"]
        pts1_h, T1 = normalize_hw(pts[..., :2], self.image_size)
        pts2_h, T2 = normalize_hw(pts[..., 2:4], self.image_size)
        feats = [(pts1_h[..., :2] + 1.0) / 2.0, (pts2_h[..., :2] + 1.0) / 2.0]
        if self.if_quality:
            feats.append(data_batch["quality"][..., : self.quality_size].to(pts.dtype))
        return torch.cat(feats, dim=-1), pts1_h, pts2_h, T1, T2

    def _fit(self, pts1, pts2, weights):
        return weighted_eight_point(pts1, pts2, weights, normalize_svd=self.normalize_svd,
                                    sign_canonical=self.sign_canonical)

    def forward(self, data_batch: Dict[str, Any]) -> Dict[str, Any]:
        weight_in, pts1, pts2, T1, T2 = self._get_input(data_batch)
        logits = self.input_weights(weight_in)[..., 0]
        weights = torch.softmax(logits, dim=-1)

        out_layers, residual_layers, epi_res_layers = [], [], []
        weights_layers, logits_layers = [weights], [logits]
        for _ in range(self.depth - 1):
            fit = self._fit(pts1, pts2, weights)
            out_layers.append(fit.F)
            residual_layers.append(fit.residual)
            epi_res = compute_epi_residual(pts1, pts2, fit.F, clamp_at=self.feature_clamp_at)
            epi_res_layers.append(epi_res)
            net_in = torch.cat([weight_in, weights[..., None].to(weight_in.dtype),
                                epi_res[..., None], fit.residual[..., None]], dim=-1)
            logits = self.update_weights(net_in)[..., 0]
            weights = torch.softmax(logits, dim=-1)
            weights_layers.append(weights)
            logits_layers.append(logits)

        fit = self._fit(pts1, pts2, weights)
        out_layers.append(fit.F)
        residual_layers.append(fit.residual)
        return {
            "logits": logits,                               # [B, N]
            "logits_layers": torch.stack(logits_layers),    # [depth, B, N]
            "F_est": fit.F,                                 # [B, 3, 3]
            "T1": T1,
            "T2": T2,
            "out_layers": torch.stack(out_layers),          # [depth, B, 3, 3]
            "epi_res_layers": torch.stack(epi_res_layers),  # [depth-1, B, N]
            "residual_layers": torch.stack(residual_layers),  # [depth, B, N]
            "weights_layers": torch.stack(weights_layers),  # [depth, B, N]
            "pts1": pts1,
            "pts2": pts2,
            "weights": weights,
        }
