"""Qualitative single-sample evaluation: frontend, solver, pose validation
and plots.

Counterpart of `deepfepe_tpu/eval/val_pipeline.py` (the reference's
`Val_pipeline_frontend`, utils/eval_tools.py:587-2100): load a trained
DeepF solver and, optionally, a SuperPoint frontend from the JAX package's
`.msgpack` checkpoints; run one batch from images (or precomputed
matches) to F̂ and Ê, recover the pose and hold it against the ground truth
and the RANSAC baseline (`val_rt_batch`); plot the correspondences, the
estimated and true epipolar lines and the solver's weights.

The nets run on their own device (the frontend takes K5 and K4 on the card
where its FrontendParams say so; the solver eigh9 and K3). The RANSAC
baseline draws from `generator` (a seed-0 torch.Generator by default), or
takes `ransac_idxs` [B, 512, 8], where the JAX package draws from a
`jax.random` key. Plotting needs matplotlib, imported only by
`plot_one_sample`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..frontend.pipeline import FrontendParams, get_matches_from_sp
from ..frontend.superpoint import SuperPointNet, SuperPointNetGauss2
from ..geometry.epipolar import F_to_E
from ..utils import msgpack_io
from ..utils.weights import (deepfnet_params_from_tree, deepfnet_state_from_flax,
                             superpoint_state_from_flax)
from .val_rt import inlier_ratios, val_rt_batch


def load_params_msgpack(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load a flax `.msgpack` checkpoint into `net` (a DeepFNet or a
    SuperPoint net) with strict=True and return it. The file holds either
    bare parameters (variables, for SuperPoint) or a whole state with a
    'params' or 'deepf_params' entry (a TrainState, a joint state): as the
    JAX package's loader, each entry is tried before the whole tree."""
    tree = msgpack_io.load_params_msgpack(path)
    sp = isinstance(net, (SuperPointNet, SuperPointNetGauss2))
    errors = []
    entries = [tree[k] for k in ("params", "deepf_params") if isinstance(tree.get(k), dict)]
    for cand in entries + [tree]:
        try:
            sd = (superpoint_state_from_flax(cand) if sp
                  else deepfnet_state_from_flax(deepfnet_params_from_tree(cand)))
            net.load_state_dict(sd, strict=True)
            return net
        except (KeyError, RuntimeError, ValueError, AttributeError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    raise ValueError(f"{path}: no layout of the file loads into {type(net).__name__} "
                     f"({'; '.join(errors)})")


class ValPipelineFrontend:
    """Single-sample qualitative evaluation (ref eval_tools.py:587).

    deepf_net: a constructed DeepFNet (its flags match the checkpoint), on
    the device to run on; deepf_params_path: its `.msgpack` checkpoint.
    sp_net / sp_params_path: an optional SuperPoint frontend and its
    `.msgpack`; without one, samples carry `matches_xy_ori` (and
    `quality`), as the SIFT dumps do. fp: the frontend's FrontendParams.
    `example_batch` is taken for the JAX signature's sake (flax needs a
    template batch; torch nets need none)."""

    def __init__(self, deepf_net, deepf_params_path: str, example_batch: Optional[Dict] = None,
                 sp_net=None, sp_params_path: Optional[str] = None,
                 fp: Optional[FrontendParams] = None):
        self.net = load_params_msgpack(deepf_params_path, deepf_net).eval()
        self.device = next(deepf_net.parameters()).device
        self.sp_net = sp_net
        self.fp = fp
        if sp_net is not None:
            if not sp_params_path:
                raise ValueError("sp_net given without sp_params_path")
            self.fp = fp or FrontendParams()
            self.sp_net = load_params_msgpack(sp_params_path, sp_net).eval()

    @staticmethod
    def _with_matches(batch: Dict, sp_out: Dict) -> Dict:
        db = dict(batch)
        db["matches_xy_ori"] = sp_out["matches_xy_ori"]
        db["quality"] = sp_out["quality"]
        db["matches_good_unique_nums"] = sp_out["valid"].to(torch.int32).sum(-1)
        return db

    def _batch(self, sample: Dict) -> Dict:
        batch = {k: torch.as_tensor(np.array(v), device=self.device) for k, v in sample.items()
                 if not isinstance(v, (str, list))}
        if self.sp_net is not None:
            imgs = batch["imgs_grey"]
            with torch.no_grad():
                sp_out = get_matches_from_sp(self.sp_net, (imgs[:, 0], imgs[:, 1]), self.fp)
            batch = self._with_matches(batch, sp_out)
        return batch

    def run_net(self, data_batch: Dict) -> Dict:
        """The solver on a prepared batch, with the pixel-frame F̂ (T2ᵀ F T1)
        and Ê = KᵀF̂K (ref run_net :1831)."""
        with torch.no_grad():
            outs = dict(self.net(data_batch))
        F_pix = outs["T2"].transpose(-1, -2) @ outs["F_est"] @ outs["T1"]
        outs["F_est_pix"] = F_pix
        outs["E_est"] = F_to_E(F_pix, data_batch["Ks"])
        return outs

    def eval_one_sample(self, sample: Dict, ransac_idxs: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Dict:
        """Frontend (if any), solver and pose validation on one batch:
        {'batch', 'preds', 'val' (err_q/err_t/epi_dists of est, gt and the
        baseline), 'ratios' (epipolar inlier fractions)}, all numpy (ref
        eval_one_sample :691)."""
        batch = self._batch(sample)
        outs = self.run_net(batch)
        if ransac_idxs is None and generator is None:
            generator = torch.Generator(device="cpu").manual_seed(0)
        with torch.no_grad():
            val = val_rt_batch(outs["E_est"], batch["Ks"], batch["matches_xy_ori"],
                               batch["E_gts"], batch["delta_Rtijs_4_4"],
                               ransac_idxs=ransac_idxs, generator=generator)
        def host(d):
            return {k: v.detach().cpu().numpy() for k, v in d.items()
                    if isinstance(v, torch.Tensor)}

        return {"batch": host(batch), "preds": host(outs), "val": host(val),
                "ratios": {name: host(inlier_ratios(val[f"epi_dists_{name}"]))
                           for name in ("est", "gt", "base")}}

    def plot_one_sample(self, result: Dict, item: int = 0, save_dir: Optional[str] = None):
        """Correspondences, estimated and true epipolar lines, the solver's
        weights (ref eval_tools.py:1899-2100): the figures, saved as PNG
        under `save_dir` when it is given. Needs matplotlib."""
        from ..utils.vis import draw_corr, show_epipolar, weight_heatmap

        b, p = result["batch"], result["preds"]
        imgs = b.get("imgs_grey")
        if imgs is None:
            H, W = self.net.image_size
            img1 = img2 = np.zeros((int(H), int(W)), np.float32)
        else:
            img1, img2 = imgs[item, 0], imgs[item, 1]
        x1 = b["matches_xy_ori"][item, :, :2]
        x2 = b["matches_xy_ori"][item, :, 2:4]
        epi_est = result["val"]["epi_dists_est"][item]
        figs = {}
        ax = draw_corr(img1, img2, x1, x2, mask=epi_est < 1.0,
                       title="matches (green: epi<1px under F̂)")
        figs["corr"] = ax.figure
        axes = show_epipolar(img1, img2, x1, x2, F=p["F_est_pix"][item],
                             F_gt=b["F_gts"][item] if "F_gts" in b else None)
        figs["epipolar"] = axes[0].figure
        ax = weight_heatmap(img1, x1, p["weights"][item])
        ax.set_title("final solver weights")
        figs["weights"] = ax.figure
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            for name, fig in figs.items():
                fig.savefig(os.path.join(save_dir, f"{name}_{item}.png"), bbox_inches="tight",
                            dpi=130)
        return figs
