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
picks K5 on the card, as it picks the TPU kernel there; 's2d' takes the
space-to-depth form (`ops/conv_s2d.py`, `F.conv2d` in full float32, no
kernel) on the layers where the JAX package takes it, H * W >=
MIN_PX_PALLAS with 64 input channels and an even width, and the plain
route elsewhere. `conv_impl=` overrides it per call.

The dtype is the net's (`net.dtype`, as the JAX package's
`superpoint_forward_fused` follows the module's): x and each conv weight
are cast to it, so a bf16 net runs the bf16 K5 and K5b (`ops/conv_bf16.py`)
and, on its plain layers, the library's bf16 conv; the BatchNorm fold
(`_bn_affine`) stays float32. The 1x1 heads are products in that dtype:
gauss2's rounded to it and then the float32 affine, the plain net's bias
added in it. float32 casts nothing (the tests run the nets in float64).

`remat` reruns parts of the forward in the backward instead of keeping
their activations (`torch.utils.checkpoint`, non-reentrant; the JAX
package's `jax.checkpoint`): 'block' each encoder double-conv of the
gauss2 net, 'full' the whole forward. The plain net ignores it, as the JAX
package's `plain_forward_fused` does. A rerun launches K5 again: a gauss2
stage-1 step launches it 12 times under 'block' or 'full', 6 under 'none'.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv import conv3x3_affine_relu, conv3x3_affine_relu_ref
from ..ops.conv_s2d import conv3x3_affine_relu_s2d
from .superpoint import SuperPointNetGauss2, normalize_desc

CONV_IMPL = os.environ.get("DEEPFEPE_SP_CONV_IMPL", "xla")
CONV_IMPLS = ("xla", "pallas", "s2d")
REMATS = ("none", "block", "full")
MIN_PX_PALLAS = 16384  # below this pixel count a layer always takes the plain route


def _pool(y: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pool of NHWC y."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def _backend(x: torch.Tensor, conv_impl: str) -> str:
    """'kernel' (K5), 's2d' or 'plain' for the layer that takes x [B, H, W,
    C], by the JAX package's rule."""
    big = x.shape[1] * x.shape[2] >= MIN_PX_PALLAS
    if conv_impl == "pallas" and big:
        return "kernel"
    if conv_impl == "s2d" and big and x.shape[-1] == 64 and x.shape[2] % 2 == 0:
        return "s2d"
    return "plain"


def _bn_affine(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN after a conv as a per-channel (scale, bias)."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    t = (conv.bias - bn.running_mean) * s + bn.bias
    dt = torch.promote_types(s.dtype, torch.float32)
    return s.to(dt).contiguous(), t.to(dt).contiguous()


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in the compute dtype; float32 keeps the parameters' own."""
    return t if dtype == torch.float32 else t.to(dtype)


def _cbr(x: torch.Tensor, conv: nn.Conv2d, s, t, conv_impl: str, dtype,
         need_dx: bool = True) -> torch.Tensor:
    w = _cast(conv.weight.permute(2, 3, 1, 0).contiguous(), dtype)  # [3, 3, Cin, C]
    backend = _backend(x, conv_impl)
    if backend == "kernel":
        return conv3x3_affine_relu(x, w, s, t, need_dx)
    plain = conv3x3_affine_relu_s2d if backend == "s2d" else conv3x3_affine_relu_ref
    return plain(x if need_dx else x.detach(), w, s, t)


def _head(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """1x1 conv as a product in `dtype`, in float32 after."""
    z = _cast(x, dtype) @ _cast(conv.weight[:, :, 0, 0].T, dtype)
    return z.float() if z.dtype == torch.bfloat16 else z


def _check(conv_impl: str, remat: str) -> None:
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv implementation {conv_impl!r} is not one of {CONV_IMPLS}")
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} is not one of {REMATS}")


def _rerun(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def gauss2_forward_fused(net: SuperPointNetGauss2, x: torch.Tensor, conv_impl: str,
                         remat: str = "none") -> Dict[str, torch.Tensor]:
    """`SuperPointNetGauss2` forward with fused convs; x [B, H, W, 1]."""
    if net.training:
        raise ValueError("the fused forward folds BatchNorm's running statistics; a net in "
                         "train mode takes the module forward (run_superpoint(bn_train=True))")
    if remat == "full":
        return _rerun(lambda v: gauss2_forward_fused(net, v, conv_impl), x)
    dt = net.dtype

    def double_conv(block, y, first_need_dx):
        seq = block.conv
        for j, (conv, bn) in enumerate(((seq[0], seq[1]), (seq[3], seq[4]))):
            y = _cbr(y, conv, *_bn_affine(conv, bn), conv_impl, dt,
                     need_dx=first_need_dx or j > 0)
        return y

    y = _cast(x, dt)
    for i, block in enumerate((net.inc.conv, net.down1.mpconv[1], net.down2.mpconv[1],
                               net.down3.mpconv[1])):
        if i:
            y = _pool(y)
        if remat == "block":
            y = _rerun(lambda v, b=block, n=i > 0: double_conv(b, v, n), y)
        else:
            y = double_conv(block, y, i > 0)
    d = _cbr(y, net.convPa, *_bn_affine(net.convPa, net.bnPa), conv_impl, dt)
    sPb, tPb = _bn_affine(net.convPb, net.bnPb)
    semi = _head(d, net.convPb, dt) * sPb + tPb
    e = _cbr(y, net.convDa, *_bn_affine(net.convDa, net.bnDa), conv_impl, dt)
    sDb, tDb = _bn_affine(net.convDb, net.bnDb)
    desc = _head(e, net.convDb, dt) * sDb + tDb
    return {"semi": semi, "desc": normalize_desc(desc)}


def plain_forward_fused(net, x: torch.Tensor, conv_impl: str) -> Dict[str, torch.Tensor]:
    """`SuperPointNet` forward with fused convs (scale 1, bias = conv bias)."""
    dt = net.dtype

    def cr(conv, y, need_dx=True):
        return _cbr(y, conv, torch.ones_like(conv.bias), conv.bias.contiguous(), conv_impl, dt,
                    need_dx)

    def head(conv, y):
        z = _cast(y, dt) @ _cast(conv.weight[:, :, 0, 0].T, dt) + _cast(conv.bias, dt)
        return z.float() if z.dtype == torch.bfloat16 else z

    y = _cast(x, dt)
    for i, (a, b) in enumerate(((net.conv1a, net.conv1b), (net.conv2a, net.conv2b),
                                (net.conv3a, net.conv3b), (net.conv4a, net.conv4b))):
        if i:
            y = _pool(y)
        y = cr(b, cr(a, y, need_dx=i > 0))
    semi = head(net.convPb, cr(net.convPa, y))
    desc = head(net.convDb, cr(net.convDa, y))
    return {"semi": semi, "desc": normalize_desc(desc)}


def superpoint_forward_fused(net, x: torch.Tensor, conv_impl: str | None = None,
                             remat: str = "none") -> Dict[str, torch.Tensor]:
    """Dispatch on the net class; `conv_impl` defaults to CONV_IMPL. The
    plain net ignores `remat`."""
    conv_impl = conv_impl or CONV_IMPL
    _check(conv_impl, remat)
    if isinstance(net, SuperPointNetGauss2):
        return gauss2_forward_fused(net, x, conv_impl, remat)
    return plain_forward_fused(net, x, conv_impl)
