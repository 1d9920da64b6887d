"""SuperPoint forward through the fused conv + affine + ReLU.

Counterpart of `deepfepe_tpu/frontend/sp_pallas.py`: the same nets as
`frontend/superpoint.py`, written as a chain of fused 3x3 conv + per-channel
affine + ReLU steps on NHWC tensors, with inference BatchNorm folded into
each step's affine (`_bn_affine`). The per-layer rule is the JAX
package's `_backend`: a layer with H * W >= MIN_PX_PALLAS takes kernel K5
(`ops.conv.conv3x3_affine_relu`, whose backward is K5b) when the conv
implementation is 'pallas'; every other layer takes the plain conv route
(`ops.conv.conv3x3_affine_relu_ref`, full float32).

The forward is differentiable: gradients reach the conv weights and
biases and the BatchNorm weights and biases (through `_bn_affine`), never
the running statistics, which are buffers. The first conv's input is the
image, so it declares no input gradient (`need_dx=False`, as the JAX
package does for `inc`'s first conv and `conv1a`). Folding BN from its
running statistics is an inference transform: a train-mode-BN forward
takes the module forward instead (`pipeline.run_superpoint`).

The conv implementation keeps the JAX package's switch and default:
`DEEPFEPE_SP_CONV_IMPL`, 'xla' (the plain route everywhere); 'pallas'
picks K5 on the card, as it picks the TPU kernel there; 's2d' (the TPU's
space-to-depth form) is not ported. `conv_impl=` overrides it per call.
The 1x1 heads are float32 matrix products. `remat` (rerunning blocks in
the backward) is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv3x3_affine_relu, conv3x3_affine_relu_ref
from .superpoint import SuperPointNetGauss2, normalize_desc

CONV_IMPL = os.environ.get("DEEPFEPE_SP_CONV_IMPL", "xla")
CONV_IMPLS = ("xla", "pallas", "s2d")
MIN_PX_PALLAS = 16384  # below this pixel count a layer always takes the plain route


def _pool(y: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pool of NHWC y."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def _backend(x: torch.Tensor, conv_impl: str) -> str:
    """'kernel' (K5) or 'plain' for the layer that takes x [B, H, W, C]."""
    big = x.shape[1] * x.shape[2] >= MIN_PX_PALLAS
    return "kernel" if conv_impl == "pallas" and big else "plain"


def _bn_affine(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN after a conv as a per-channel (scale, bias)."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    t = (conv.bias - bn.running_mean) * s + bn.bias
    dt = torch.promote_types(s.dtype, torch.float32)
    return s.to(dt).contiguous(), t.to(dt).contiguous()


def _cbr(x: torch.Tensor, conv: nn.Conv2d, s, t, conv_impl: str,
         need_dx: bool = True) -> torch.Tensor:
    w = conv.weight.permute(2, 3, 1, 0).contiguous()  # [3, 3, Cin, C]
    if _backend(x, conv_impl) == "kernel":
        return conv3x3_affine_relu(x, w, s, t, need_dx)
    return conv3x3_affine_relu_ref(x if need_dx else x.detach(), w, s, t)


def _head(x: torch.Tensor, conv: nn.Conv2d, s, t) -> torch.Tensor:
    """1x1 conv as a float32 product, then the affine."""
    return (x @ conv.weight[:, :, 0, 0].T) * s + t


def _check(conv_impl: str, remat: str) -> None:
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv implementation {conv_impl!r} is not one of {CONV_IMPLS}")
    if conv_impl == "s2d":
        raise NotImplementedError("the space-to-depth conv route ('s2d') is not ported "
                                  "(ROADMAP Queue 1, frontend items)")
    if remat != "none":
        raise NotImplementedError("remat (jax.checkpoint of encoder blocks; "
                                  "torch.utils.checkpoint here) is not ported (ROADMAP Queue 1)")


def gauss2_forward_fused(net: SuperPointNetGauss2, x: torch.Tensor,
                         conv_impl: str) -> Dict[str, torch.Tensor]:
    """`SuperPointNetGauss2` forward with fused convs; x [B, H, W, 1]."""
    if net.training:
        raise ValueError("the fused forward folds BatchNorm's running statistics; a net in "
                         "train mode takes the module forward (run_superpoint(bn_train=True))")
    y = x
    for i, block in enumerate((net.inc.conv, net.down1.mpconv[1], net.down2.mpconv[1],
                               net.down3.mpconv[1])):
        if i:
            y = _pool(y)
        seq = block.conv
        for j, (conv, bn) in enumerate(((seq[0], seq[1]), (seq[3], seq[4]))):
            y = _cbr(y, conv, *_bn_affine(conv, bn), conv_impl, need_dx=i > 0 or j > 0)
    d = _cbr(y, net.convPa, *_bn_affine(net.convPa, net.bnPa), conv_impl)
    semi = _head(d, net.convPb, *_bn_affine(net.convPb, net.bnPb))
    e = _cbr(y, net.convDa, *_bn_affine(net.convDa, net.bnDa), conv_impl)
    desc = _head(e, net.convDb, *_bn_affine(net.convDb, net.bnDb))
    return {"semi": semi, "desc": normalize_desc(desc)}


def plain_forward_fused(net, x: torch.Tensor, conv_impl: str) -> Dict[str, torch.Tensor]:
    """`SuperPointNet` forward with fused convs (scale 1, bias = conv bias)."""

    def cr(conv, y, need_dx=True):
        return _cbr(y, conv, torch.ones_like(conv.bias), conv.bias.contiguous(), conv_impl,
                    need_dx)

    y = x
    for i, (a, b) in enumerate(((net.conv1a, net.conv1b), (net.conv2a, net.conv2b),
                                (net.conv3a, net.conv3b), (net.conv4a, net.conv4b))):
        if i:
            y = _pool(y)
        y = cr(b, cr(a, y, need_dx=i > 0))
    one = torch.ones_like(net.convPb.bias)
    semi = _head(cr(net.convPa, y), net.convPb, one, net.convPb.bias)
    one = torch.ones_like(net.convDb.bias)
    desc = _head(cr(net.convDa, y), net.convDb, one, net.convDb.bias)
    return {"semi": semi, "desc": normalize_desc(desc)}


def superpoint_forward_fused(net, x: torch.Tensor, conv_impl: str | None = None,
                             remat: str = "none") -> Dict[str, torch.Tensor]:
    """Dispatch on the net class; `conv_impl` defaults to CONV_IMPL."""
    conv_impl = conv_impl or CONV_IMPL
    _check(conv_impl, remat)
    if isinstance(net, SuperPointNetGauss2):
        return gauss2_forward_fused(net, x, conv_impl)
    return plain_forward_fused(net, x, conv_impl)
