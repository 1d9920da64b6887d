"""End-to-end frontend: grey frames -> keypoints -> correspondences.

Counterpart of `deepfepe_tpu/frontend/pipeline.py` (the reference's
`get_matches_from_SP`, train_good_utils.py:649-756): both frames go through
SuperPoint in one [2B] pass, are post-processed into keypoints with
subpixel offsets and sparse descriptors, matched mutually, and assembled
into [B, N, 4] correspondences padded by cyclic resampling of the real
matches. It is differentiable where the JAX package's is: the
correspondences through the soft-argmax offsets, the descriptors through
their two-hot sampling, and `quality` through the recomputed match
distances, back to the SuperPoint weights; keypoint positions and match
indices are discrete.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .matching import gather_matches, mutual_nn_match
from .process import Keypoints, extract_keypoints
from .sp_fused import REMATS, superpoint_forward_fused
from .superpoint import SuperPointNet, flatten_detection

SP_PARAMS = ("out_num_points", "patch_size", "nms_dist", "conf_thresh", "nn_thresh",
             "conv_backend", "remat")
CONV_BACKENDS = ("auto", "fused", "flax")


class FrontendParams:
    """The reference's SP_params knob set (configs: training.SP_params).

    `conv_backend` routes the CNN forward: 'auto' is the fused forward
    (`frontend/sp_fused.py`) for images on the card, as it is on the TPU in
    the JAX package, and the module forward elsewhere; 'fused' and 'flax'
    (the JAX name, kept: the nn.Module forward) force a side. `conv_impl`
    picks the fused forward's conv implementation ('xla', 'pallas' or
    's2d'; None reads DEEPFEPE_SP_CONV_IMPL); it is not an SP_params key, nor is
    `matcher`, the route of the mutual-NN matching (`matching.route`:
    'auto', 'xla' or 'pallas'; None reads DEEPFEPE_MATCHER_IMPL). `remat`
    ('none', 'block' or 'full') reruns the SuperPoint forward, or each of
    its encoder blocks, in the backward (`run_superpoint`)."""

    def __init__(self, out_num_points: int = 1000, patch_size: int = 5, nms_dist: int = 4,
                 conf_thresh: float = 0.015, nn_thresh: float = 1.0,
                 conv_backend: str = "auto", remat: str = "none",
                 conv_impl: str | None = None, matcher: str | None = None):
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"conv_backend {conv_backend!r} is not one of {CONV_BACKENDS}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} is not one of {REMATS}")
        self.out_num_points = out_num_points
        self.patch_size = patch_size
        self.nms_dist = nms_dist
        self.conf_thresh = conf_thresh
        self.nn_thresh = nn_thresh
        self.conv_backend = conv_backend
        self.remat = remat
        self.conv_impl = conv_impl
        self.matcher = matcher


def frontend_params_from_config(cfg) -> FrontendParams:
    """training.SP_params -> FrontendParams; unknown keys are rejected."""
    sp = dict(getattr(cfg.training, "sp_params", None) or {})
    unknown = set(sp) - set(SP_PARAMS)
    if unknown:
        raise ValueError(f"unknown SP_params keys: {sorted(unknown)}")
    return FrontendParams(**sp)


def _use_fused_convs(fp: FrontendParams, images: torch.Tensor) -> bool:
    return fp.conv_backend == "fused" or (fp.conv_backend == "auto" and images.is_cuda)


def _rerun(fn, x):
    """fn(x, first) with its activations recomputed in the backward: the
    first call (the forward) gets first=True, the recompute first=False."""
    calls = []

    def once(v):
        calls.append(v)
        return fn(v, len(calls) == 1)

    return checkpoint(once, x, use_reentrant=False, preserve_rng_state=False)


def run_superpoint(net, images: torch.Tensor, fp: FrontendParams, bn_train: bool = False,
                   bn_groups: int = 1):
    """images [B, H, W] grey in [0, 1] -> Keypoints with descriptors.

    `bn_train=True` (BatchNorm nets only) runs the module forward with
    BatchNorm on batch statistics, `bn_groups` groups of the batch, which
    updates the running buffers in place. It never takes the fused
    forward, whose BatchNorm is folded from the running statistics.

    `fp.remat` 'block' or 'full' reruns the forward in the backward, as the
    JAX package's `jax.checkpoint` does: the fused forward per encoder
    block or whole (`superpoint_forward_fused`); the module forward whole
    ('block' degrades to 'full' there, as in the JAX package). The rerun of
    a train-mode forward leaves the running buffers alone
    (`update_stats=False`), so they take one update a step, as the JAX
    step's functional write-back does."""
    x = images[..., None].contiguous()
    remat = fp.remat != "none"
    if bn_train:
        if not any(True for _ in net.buffers()):
            raise ValueError("train-mode BatchNorm needs a net with BatchNorm")

        def train_forward(v, first):
            # In train mode also when rerun in the backward, after this
            # function has put the net back.
            was_training = net.training
            net.train()
            try:
                return net(v, bn_groups=bn_groups, update_stats=first)
            finally:
                net.train(was_training)

        outs = _rerun(train_forward, x) if remat else train_forward(x, True)
    elif _use_fused_convs(fp, images):
        outs = superpoint_forward_fused(net, x, fp.conv_impl, fp.remat)
    elif remat:
        outs = _rerun(lambda v, first: net(v), x)
    else:
        outs = net(x)
    return extract_keypoints(flatten_detection(outs["semi"]), outs["desc"],
                             out_num_points=fp.out_num_points, nms_dist=fp.nms_dist,
                             conf_thresh=fp.conf_thresh, patch_size=fp.patch_size)


def get_matches_from_sp(net, imgs_grey: Tuple[torch.Tensor, torch.Tensor], fp: FrontendParams,
                        bn_train: bool = False) -> Dict:
    """Two frames [B, H, W] each -> {'matches_xy_ori' [B, N, 4], 'quality'
    [B, N, 1], 'valid' [B, N], 'kpts1', 'kpts2', 'matches'}. `bn_train`
    runs BatchNorm on batch statistics, each frame a group (the reference's
    per-frame passes), and updates the net's running buffers in place."""
    B = imgs_grey[0].shape[0]
    both = torch.cat([imgs_grey[0], imgs_grey[1]], dim=0)
    kk = run_superpoint(net, both, fp, bn_train=bn_train, bn_groups=2 if bn_train else 1)
    k1, k2 = kk.split(B)
    m = mutual_nn_match(k1.desc, k2.desc, k1.valid, k2.valid, nn_thresh=fp.nn_thresh,
                        num_matches=fp.out_num_points, backend=fp.matcher)
    matches_xy = gather_matches(k1.xy + k1.offsets, k2.xy + k2.offsets, m)
    quality = torch.where(m.valid, 1.0 - m.scores / fp.nn_thresh,
                          torch.zeros_like(m.scores))[..., None]
    # Empty slots resample the real matches cyclically, as the reference's
    # crop_or_pad_choice does: matches are sorted valid-first, so slot
    # i >= n_valid takes match i mod n_valid.
    n = matches_xy.shape[-2]
    ar = torch.arange(n, device=matches_xy.device)[None, :]
    n_valid = m.valid.sum(-1, keepdim=True)
    idx = torch.where(m.valid, ar, ar % torch.clamp(n_valid, min=1))
    matches_xy = torch.gather(matches_xy, 1, idx[..., None].expand(-1, -1, 4))
    quality = torch.gather(quality, 1, idx[..., None])
    return {"matches_xy_ori": matches_xy, "quality": quality, "valid": m.valid,
            "kpts1": k1, "kpts2": k2, "matches": m}


class ValModelHeatmap:
    """Inference wrapper in the reference's `Val_model_heatmap` shape:
    SuperPoint forward -> NMS points -> subpixel offsets -> sparse
    descriptors, from a config dict."""

    def __init__(self, net=None, config: Dict | None = None):
        c = config or {}
        self.net = net if net is not None else SuperPointNet().eval()
        self.fp = FrontendParams(out_num_points=c.get("top_k", c.get("out_num_points", 1000)),
                                 patch_size=c.get("patch_size", 5),
                                 nms_dist=c.get("nms_dist", 4),
                                 conf_thresh=c.get("conf_thresh", 0.015),
                                 nn_thresh=c.get("nn_thresh", 1.0))
        self._last = None

    def run(self, images: torch.Tensor) -> Keypoints:
        """images [B, H, W] grey in [0, 1] -> Keypoints with descriptors."""
        with torch.no_grad():
            self._last = run_superpoint(self.net, images, self.fp)
        return self._last

    def heatmap_to_pts(self) -> torch.Tensor:
        """[B, K, 3] (x, y, score) of the last run."""
        k = self._last
        return torch.cat([k.xy + k.offsets, k.scores[..., None]], dim=-1)

    def desc_to_sparse_desc(self) -> torch.Tensor:
        """[B, K, D] sparse descriptors of the last run."""
        return self._last.desc
