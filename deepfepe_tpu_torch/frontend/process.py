"""Heatmap post-processing: NMS, top-k keypoints, soft-argmax, descriptor
sampling.

Counterpart of `deepfepe_tpu/frontend/process.py`. Every image gets exactly
`out_num_points` keypoints, sorted by score and padded with a validity
mask. Orders follow the JAX package's: top-k and the match sort are stable
(lower index first on equal values), as `lax.top_k` and `jnp.argsort` are;
`torch.topk` and an unstable `torch.argsort` promise no such order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..geometry.basic import safe_norm


class Keypoints(NamedTuple):
    xy: torch.Tensor       # [B, K, 2] integer NMS positions (x, y), float
    offsets: torch.Tensor  # [B, K, 2] subpixel offsets
    scores: torch.Tensor   # [B, K]
    valid: torch.Tensor    # [B, K] bool
    desc: Optional[torch.Tensor] = None  # [B, K, D] unit descriptors

    def split(self, n: int):
        """(items [:n], items [n:]) of every field."""
        head = Keypoints(*(None if t is None else t[:n] for t in self))
        tail = Keypoints(*(None if t is None else t[n:] for t in self))
        return head, tail


def nms_heatmap(heatmap: torch.Tensor, nms_dist: int = 4) -> torch.Tensor:
    """Keep p where p >= the max of its (2 nms_dist + 1)^2 window, else 0.
    Ties are kept. `F.max_pool2d` pads with -inf, as the JAX reduce-window
    does, so a border maximum survives."""
    k = 2 * nms_dist + 1
    m = F.max_pool2d(heatmap[:, None], k, stride=1, padding=nms_dist)[:, 0]
    return torch.where(heatmap >= m, heatmap, torch.zeros_like(heatmap))


def topk_keypoints(nms_map: torch.Tensor, k: int, conf_thresh: float = 0.015) -> Keypoints:
    """The k highest NMS survivors, lower index first on equal scores."""
    B, H, W = nms_map.shape
    scores, idx = torch.sort(nms_map.reshape(B, H * W), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    xy = torch.stack([idx % W, idx // W], dim=-1).to(nms_map.dtype)
    valid = scores > conf_thresh
    zero = torch.zeros((), dtype=nms_map.dtype, device=nms_map.device)
    xy = torch.where(valid[..., None], xy, zero)
    return Keypoints(xy=xy, offsets=torch.zeros_like(xy),
                     scores=torch.where(valid, scores, zero), valid=valid)


def soft_argmax_refine(heatmap: torch.Tensor, kpts: Keypoints, patch_size: int = 5,
                       temperature: float | None = None, eps: float = 1e-10,
                       impl: str = "auto") -> Keypoints:
    """Subpixel offsets: the centre of mass of the (patch_size)^2 window
    around each keypoint, zero-padded at the border. `impl` 'auto' is
    'matmul' (the JAX default): window-hot row and column selectors
    contracted against the heatmap, two batched [K, H] x [H, W] products.
    The 'gather' and 'conv' forms and the softmax (`temperature`) variant
    are not ported."""
    if impl == "auto" and temperature is None:
        impl = "matmul"
    if impl != "matmul" or temperature is not None:
        raise NotImplementedError(
            f"soft_argmax_refine(impl={impl!r}, temperature={temperature}) is not ported; "
            "the port has the centre-of-mass 'matmul' form")
    hm = heatmap.to(torch.promote_types(heatmap.dtype, torch.float32))
    B, H, W = hm.shape
    r = patch_size // 2
    ih = torch.arange(H, dtype=hm.dtype, device=hm.device)
    iw = torch.arange(W, dtype=hm.dtype, device=hm.device)
    ys = kpts.xy[..., 1].to(hm.dtype)[..., None]  # [B, K, 1]
    xs = kpts.xy[..., 0].to(hm.dtype)[..., None]
    wy = ((ih - ys).abs() <= r).to(hm.dtype)  # [B, K, H]
    wyd = (ih - ys) * wy
    wx = ((iw - xs).abs() <= r).to(hm.dtype)  # [B, K, W]
    wxd = (iw - xs) * wx
    t0 = torch.bmm(wy, hm)
    t1 = torch.bmm(wyd, hm)
    s = (t0 * wx).sum(-1)
    sx = (t0 * wxd).sum(-1)
    sy = (t1 * wx).sum(-1)
    offsets = torch.stack([sx / (s + eps), sy / (s + eps)], dim=-1).to(heatmap.dtype)
    offsets = torch.where(kpts.valid[..., None], offsets, torch.zeros_like(offsets))
    return kpts._replace(offsets=offsets)


def _two_hot(idx0: torch.Tensor, frac: torch.Tensor, size: int) -> torch.Tensor:
    """[..., K] index and fraction -> [..., K, size] rows with (1 - frac) at
    idx0 and frac at idx0 + 1: linear interpolation as a contraction."""
    iota = torch.arange(size, device=idx0.device)
    oh0 = (iota == idx0[..., None]).to(frac.dtype)
    oh1 = (iota == (idx0 + 1)[..., None]).to(frac.dtype)
    return oh0 * (1.0 - frac[..., None]) + oh1 * frac[..., None]


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor, cell: int = 8,
                       eps: float = 1e-10) -> torch.Tensor:
    """Bilinear samples of desc_map [B, Hc, Wc, D] at pixel coordinates xy
    [B, K, 2] (cell centres at half a cell), unit-normalized, as the
    separable two-hot double contraction of the JAX package."""
    B, Hc, Wc, D = desc_map.shape
    gx = xy[..., 0] / cell - 0.5
    gy = xy[..., 1] / cell - 0.5
    x0 = torch.clamp(torch.floor(gx), 0, Wc - 2).long()
    y0 = torch.clamp(torch.floor(gy), 0, Hc - 2).long()
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    ox = _two_hot(x0, fx, Wc)  # [B, K, Wc]
    oy = _two_hot(y0, fy, Hc)  # [B, K, Hc]
    t = torch.einsum("bkw,bhwd->bkhd", ox,
                     desc_map.to(torch.promote_types(desc_map.dtype, torch.float32)))
    d = torch.einsum("bkh,bkhd->bkd", oy, t).to(desc_map.dtype)
    return d / (safe_norm(d, dim=-1, keepdim=True) + eps)


def extract_keypoints(heatmap: torch.Tensor, desc_map: torch.Tensor,
                      out_num_points: int = 1000, nms_dist: int = 4,
                      conf_thresh: float = 0.015, patch_size: int = 5) -> Keypoints:
    """NMS -> top-k -> soft-argmax -> descriptor sampling."""
    kpts = topk_keypoints(nms_heatmap(heatmap, nms_dist), out_num_points, conf_thresh)
    kpts = soft_argmax_refine(heatmap, kpts, patch_size)
    return kpts._replace(desc=sample_descriptors(desc_map, kpts.xy + kpts.offsets))
