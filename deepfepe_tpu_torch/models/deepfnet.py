"""DeepFNet: the iterative weighted 8-point network.

Counterpart of `deepfepe_tpu/models/deepfnet.py`:

  weight_in = [(pts1+1)/2, (pts2+1)/2 (, quality)]
  logits    = input_weights(weight_in); w = softmax_N (x weights_im)
  repeat depth-1 times:
      F_l, residual = weighted_eight_point(pts1, pts2, w)
      epi_res       = compute_epi_residual(pts1, pts2, F_l)
      net_in        = [weight_in, w, epi_res, residual (, tri_depth)]
      (learned offsets: offsets = update_offsets(net_in); pts, weight_in
       re-derived from the offset matches, net_in rebuilt)
      logits        = update_weights(net_in); w = softmax_N (x weights_im)
  final fit

Variants, as in the JAX package: `if_learn_offsets` (a 4-output
ErrorEstimator moves the matches), `if_tri_depth` (each layer's
triangulated depth of the matches as one more feature), `if_img_w`
(weights times the batch's 'weights_im'), `if_goodCorresArch`
(GoodCorresNet for both weight nets), `if_sample_loss` (after every
fit, the sampled minimal-subset fits of `models.sample_fit`, drawn from
the forward's `generator`), `if_des` (the batch's per-match descriptors
'des' [B, N, des_size] join the weight nets' input, as the JAX DeepFNet
concatenates them: C_in = 4 + quality + des_size, so the dump loader's
256-wide SIFT pairs give 261 and 264, past the fused MLP's 128) and
`if_bn` (BatchNorm in both weight MLPs, run on its running statistics as
the JAX DeepFNet calls them: build it so to load a reference checkpoint
whose weight nets have BatchNorm).

Launches on the card, per forward of depth d: eigh9 d times (2d with the
sample loss: each layer's subset fits are one more batch); K3 (the
epipolar residual) d - 1 times, and its backward as often in a backward;
with `use_pallas_mlp` (and bfloat16 MLPs, no BatchNorm, C_in <= 128: not
with `if_des`) K2 once per weight-MLP call (d, plus d - 1 for the learned
offsets) and K2b as often in a backward.

`data_mesh` (None on one device; the data-parallel trainers set it) makes
the sample loss draw over the global batch (`sample_fit.draw_subsets`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..geometry.decompose import recover_pose, two_view_depths
from ..geometry.epipolar import F_to_E, compute_epi_residual, normalize_hw
from ..ops.fmatrix import weighted_eight_point
from . import sample_fit
from .error_estimator import ErrorEstimator, GoodCorresNet


class DeepFNet(nn.Module):
    """Input dict: 'matches_xy_ori' [B, N, 4] pixel correspondences; with
    `if_quality` 'quality' [B, N, >=quality_size]; with `if_tri_depth` 'Ks'
    [B, 3, 3] and 't_scene_scale' [B, 1]; with `if_img_w` 'weights_im' [B,
    N]; with `if_sample_loss` 'matches_good_unique_nums' [B]. Returns the
    per-layer outputs stacked as in the JAX package."""

    # The JAX module's defaults, which no config changes: the triangulated
    # depth's clamp, and the sample loss's subset size and subsets a fit.
    DEPTH_CLAMP, SAMPLE_TOPK, SAMPLE_SELECTS = 200.0, 20, 100
    # The descriptor width `if_des` takes when `des_size` is 0: the dump
    # loader's 'des', two 128-wide SIFT descriptors a match (the JAX module
    # sizes its layers from the batch; the port's are built up front).
    DES_SIZE = 256

    def __init__(self, depth: int = 5, image_size=(376, 1241), if_quality: bool = False,
                 quality_size: int = 1, feature_clamp_at: float = 0.5,
                 normalize_svd: bool = True, mlp_dtype: torch.dtype = torch.float32,
                 sign_canonical: bool = False, use_pallas_mlp: bool = False,
                 if_learn_offsets: bool = False, if_img_w: bool = False,
                 if_tri_depth: bool = False, if_sample_loss: bool = False,
                 if_goodCorresArch: bool = False, if_des: bool = False, des_size: int = 0,
                 if_bn: bool = False):
        super().__init__()
        self.depth = depth
        self.image_size = tuple(image_size)
        self.if_quality = if_quality
        self.quality_size = quality_size
        self.feature_clamp_at = feature_clamp_at
        self.normalize_svd = normalize_svd
        self.sign_canonical = sign_canonical
        self.if_learn_offsets = if_learn_offsets
        self.if_img_w = if_img_w
        self.if_tri_depth = if_tri_depth
        self.if_sample_loss = if_sample_loss
        self.if_des = if_des
        self.des_size = (des_size or self.DES_SIZE) if if_des else 0
        in_ch = 4 + (quality_size if if_quality else 0) + self.des_size
        update_ch = in_ch + 3 + (1 if if_tri_depth else 0)
        if if_goodCorresArch:
            self.input_weights = GoodCorresNet(in_ch, 1)
            self.update_weights = GoodCorresNet(update_ch, 1)
        else:
            self.input_weights = ErrorEstimator(in_ch, 1, dtype=mlp_dtype,
                                                use_fused=use_pallas_mlp, if_bn=if_bn)
            self.update_weights = ErrorEstimator(update_ch, 1, dtype=mlp_dtype,
                                                 use_fused=use_pallas_mlp, if_bn=if_bn)
        if if_learn_offsets:
            self.update_offsets = ErrorEstimator(update_ch, 4, dtype=mlp_dtype,
                                                 use_fused=use_pallas_mlp)
        self.data_mesh = None

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.input_weights, self.update_weights,
                  *([self.update_offsets] if self.if_learn_offsets else [])):
            m.reset_parameters(generator)

    def _get_input(self, data_batch, offsets=None):
        pts = data_batch["matches_xy_ori"]
        if offsets is not None:
            pts = pts + offsets.to(pts.dtype)
        pts1_h, T1 = normalize_hw(pts[..., :2], self.image_size)
        pts2_h, T2 = normalize_hw(pts[..., 2:4], self.image_size)
        feats = [(pts1_h[..., :2] + 1.0) / 2.0, (pts2_h[..., :2] + 1.0) / 2.0]
        if self.if_quality:
            feats.append(data_batch["quality"][..., : self.quality_size].to(pts.dtype))
        if self.if_des:
            feats.append(data_batch["des"].to(pts.dtype))
        return torch.cat(feats, dim=-1), pts1_h, pts2_h, T1, T2

    def _fit(self, pts1, pts2, weights):
        return weighted_eight_point(pts1, pts2, weights, normalize_svd=self.normalize_svd,
                                    sign_canonical=self.sign_canonical)

    def _weights(self, net, x, data_batch):
        logits = net(x)[..., 0]
        weights = torch.softmax(logits, dim=-1)
        if self.if_img_w:
            weights = weights * data_batch["weights_im"]
        return logits, weights

    def _tri_depth_feature(self, data_batch, F_out, T1, T2):
        """Each match's depth in the first view, triangulated from the
        layer's F (E = Kᵀ F K, the cheirality-voted pose) and scaled by the
        scene scale, clamped at DEPTH_CLAMP: [B, N, 1]."""
        Ks = data_batch["Ks"].to(F_out.dtype)
        E = F_to_E(T2.transpose(-1, -2) @ F_out @ T1, Ks)
        pts = data_batch["matches_xy_ori"].to(F_out.dtype)
        K_inv_t = torch.linalg.inv(Ks).transpose(-1, -2)
        ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype, device=pts.device)
        x1n = torch.cat([pts[..., :2], ones], -1) @ K_inv_t
        x2n = torch.cat([pts[..., 2:4], ones], -1) @ K_inv_t
        rec = recover_pose(E, x1n, x2n)
        z1, _ = two_view_depths(rec.R, rec.t, x1n, x2n)
        scale = data_batch["t_scene_scale"].to(z1.dtype).reshape(-1, 1)
        return torch.clamp(z1 * scale, -self.DEPTH_CLAMP, self.DEPTH_CLAMP)[..., None]

    def forward(self, data_batch: Dict[str, Any],
                generator: torch.Generator | None = None) -> Dict[str, Any]:
        """`generator` draws the sample loss's subsets; without one a
        generator seeded 0 on the batch's device draws them (the JAX
        package's callers pass PRNGKey(0) where they have no step key)."""
        weight_in, pts1, pts2, T1, T2 = self._get_input(data_batch)
        logits, weights = self._weights(self.input_weights, weight_in, data_batch)
        if self.if_sample_loss and generator is None:
            generator = torch.Generator(device=weights.device).manual_seed(0)

        out_layers, residual_layers, epi_res_layers = [], [], []
        weights_layers, logits_layers = [weights], [logits]
        sample_F_layers, sample_score_layers = [], []
        offsets, tri_depths = None, None

        def sample_fits(pts1, pts2, weights):
            if self.if_sample_loss:
                sf = sample_fit.sample_loss_fits(
                    pts1, pts2, weights, data_batch["matches_good_unique_nums"], generator,
                    topk=self.SAMPLE_TOPK, selects=self.SAMPLE_SELECTS, mesh=self.data_mesh)
                sample_F_layers.append(sf["F_samples"])
                sample_score_layers.append(sf["sample_scores"])

        for _ in range(self.depth - 1):
            fit = self._fit(pts1, pts2, weights)
            out_layers.append(fit.F)
            residual_layers.append(fit.residual)
            sample_fits(pts1, pts2, weights)
            epi_res = compute_epi_residual(pts1, pts2, fit.F, clamp_at=self.feature_clamp_at)
            epi_res_layers.append(epi_res)
            if self.if_tri_depth:
                tri_depths = self._tri_depth_feature(data_batch, fit.F, T1, T2)
            extra = [weights[..., None].to(weight_in.dtype), epi_res[..., None],
                     fit.residual[..., None]] + ([tri_depths] if self.if_tri_depth else [])
            net_in = torch.cat([weight_in, *extra], dim=-1)
            if self.if_learn_offsets:
                offsets = self.update_offsets(net_in)
                weight_in, pts1, pts2, T1, T2 = self._get_input(data_batch, offsets)
                net_in = torch.cat([weight_in, *extra], dim=-1)
            logits, weights = self._weights(self.update_weights, net_in, data_batch)
            weights_layers.append(weights)
            logits_layers.append(logits)

        fit = self._fit(pts1, pts2, weights)
        out_layers.append(fit.F)
        residual_layers.append(fit.residual)
        sample_fits(pts1, pts2, weights)
        preds = {
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
        if self.if_learn_offsets:
            preds["offsets"] = offsets
        if self.if_tri_depth:
            preds["tri_depths"] = tri_depths
        if self.if_sample_loss:
            # [depth, B, S, 3, 3] and [depth, B, S]
            preds["out_sample_selected_layers"] = torch.stack(sample_F_layers)
            preds["weights_sample_selected_layers"] = torch.stack(sample_score_layers)
        return preds
