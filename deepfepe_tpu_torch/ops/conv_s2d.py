"""The space-to-depth-by-2 form of the fused 3x3 conv + affine + ReLU.

Counterpart of the s2d helpers of `deepfepe_tpu/ops/pallas/conv_pallas.py`
(`_pack_w_s2d`, `conv3x3_affine_relu_s2d_pre`, `max_pool_2x2_s2d`,
`to_s2d`, `from_s2d`, `conv3x3_affine_relu_s2d`). In NHWC, [B, H, W, C] ->
[B, H, W/2, 2C] is a free reshape (lane dx * C + ch), and the 3x3 conv
becomes a dense [3, 3, 2Cin, 2C] conv at half the width: the TPU's
128-lane form for 64-channel layers. The JAX package computes it with
XLA convs outside any Pallas kernel, so the port computes it with
`F.conv2d` in full float32 (`ops.conv.full_f32`, as the plain route
`conv3x3_affine_relu_ref`), launches no kernel, and takes its backward
from autograd: the weight pack is linear, so the gradient reaches the
[3, 3, Cin, C] weights exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import full_f32


def _pack_w_s2d(w: torch.Tensor, dtype) -> torch.Tensor:
    """[3, 3, Cin, C] -> [3, 3, 2Cin, 2C]: entry [kh, kw, dx * Cin + ch,
    j * C + co] = w[kh, kx, ch, co] with kx = 2 kw - 1 + dx - j (zero
    outside [0, 2])."""
    wd = w.to(dtype)
    zero = torch.zeros_like(wd[:, 0])  # [3, Cin, C]
    cols = []
    for kw_ in range(3):
        rows = []
        for dx in range(2):
            blocks = []
            for j in range(2):
                kx = 2 * kw_ - 1 + dx - j
                blocks.append(wd[:, kx] if 0 <= kx <= 2 else zero)
            rows.append(torch.cat(blocks, dim=-1))  # [3, Cin, 2C]
        cols.append(torch.cat(rows, dim=-2))  # [3, 2Cin, 2C]
    return torch.stack(cols, dim=1)


def _conv_affine_relu(xs: torch.Tensor, ws: torch.Tensor, scale, bias) -> torch.Tensor:
    """relu(conv3x3_same(xs, ws) * tile(scale, 2) + tile(bias, 2)) in NHWC;
    the conv in xs's dtype, the affine and ReLU in float32 (float64 for
    float64), back in xs's dtype."""
    with full_f32():
        z = F.conv2d(xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1), padding=1)
    acc = torch.promote_types(xs.dtype, torch.float32)
    y = torch.relu(z.permute(0, 2, 3, 1).to(acc) * scale.to(acc).repeat(2)
                   + bias.to(acc).repeat(2))
    return y.to(xs.dtype)


def conv3x3_affine_relu_s2d_pre(xs: torch.Tensor, w, scale, bias) -> torch.Tensor:
    """The fused conv on an input already in s2d form: xs [B, H, W/2,
    2Cin] -> [B, H, W/2, 2C]."""
    return _conv_affine_relu(xs, _pack_w_s2d(w, xs.dtype), scale, bias).contiguous()


def max_pool_2x2_s2d(ys: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pool, s2d in and out: [B, H, G, 2C] -> [B, H/2, G/2, 2C].
    Output group g', slot j, channel ch pools rows {2h', 2h' + 1} of input
    group 2g' + j's two slots."""
    B, H, G, L = ys.shape
    C = L // 2
    z = ys.reshape(B, H // 2, 2, G // 2, 2, 2, C)
    return z.amax(dim=(2, 5)).reshape(B, H // 2, G // 2, 2 * C)


def to_s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W/2, 2C]."""
    B, H, W, C = x.shape
    return x.reshape(B, H, W // 2, 2 * C)


def from_s2d(xs: torch.Tensor) -> torch.Tensor:
    """[B, H, G, 2C] -> [B, H, 2G, C]."""
    B, H, G, L = xs.shape
    return xs.reshape(B, H, 2 * G, L // 2)


def conv3x3_affine_relu_s2d(x: torch.Tensor, w, scale, bias) -> torch.Tensor:
    """relu(conv3x3_same(x, w) * scale + bias) for x [B, H, W, Cin] (W
    even) through the s2d form: [B, H, W, C] in x's dtype."""
    B, H, W, _ = x.shape
    if W % 2:
        raise ValueError(f"the s2d conv needs an even width, not {W}")
    y = _conv_affine_relu(to_s2d(x), _pack_w_s2d(w, x.dtype), scale, bias)
    return from_s2d(y).contiguous()
