"""SuperPoint detector/descriptor CNNs, inference.

Counterpart of `deepfepe_tpu/frontend/superpoint.py`. The modules use the
reference's layouts and parameter names, so their state dicts are the
reference checkpoints' (`utils/weights.py` carries the JAX package's
parameters across):

- `SuperPointNet`: magicleap's net, conv1a..conv4b (64-64-64-64-128-128-
  128-128), heads convPa/convPb (det 65) and convDa/convDb (desc 256).
- `SuperPointNetGauss2`: pytorch-superpoint's `SuperPointNet_gauss2`,
  double-conv blocks inc/down1/down2/down3 (64-64-128-128, each
  conv-BN-ReLU twice, keys `inc.conv.conv.{0,1,3,4}` and
  `down<k>.mpconv.1.conv.{0,1,3,4}`) and BN'd heads.

Public layout is the JAX package's NHWC: `forward` takes grey images
[B, H, W, 1] and returns {'semi' [B, H/8, W/8, 65], 'desc' [B, H/8, W/8,
256]} with unit descriptors. In eval mode BatchNorm runs on its running
statistics (`nn.BatchNorm2d`, eps 1e-5). In train mode (joint training)
it runs on batch statistics, as the reference fine-tunes SuperPoint, and
`forward(x, bn_groups=g)` splits the batch into g groups (both frames of a
pair go through one [2B] pass, frame 1 then frame 2): each group is
normalized by its own biased statistics and the running buffers take one
momentum-0.1 update per group, in group order, with the unbiased variance,
exactly the reference's two per-frame passes (the JAX package's
`TorchBatchNorm`). The buffers are updated in place during the forward, as
`nn.BatchNorm2d` does. Convolutions run in full float32
(`ops.conv.full_f32`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.basic import safe_norm
from ..ops.conv import full_f32

BN_EPS = 1e-5


def conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def conv1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


def normalize_desc(desc: torch.Tensor) -> torch.Tensor:
    """Unit descriptors along the last axis (zero-safe)."""
    return desc / (safe_norm(desc, dim=-1, keepdim=True) + 1e-10)


def reset_superpoint(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights, as flax initializes the JAX nets: conv kernels
    truncated-normal with variance 1/fan_in (lecun_normal), biases zero, BN
    affine (1, 0) and running statistics (0, 1)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                # lecun_normal: a unit normal truncated at 2, rescaled to variance 1/fan_in
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net


class SuperPointNet(nn.Module):
    """magicleap's VGG-style SuperPoint (no BatchNorm)."""

    def __init__(self, det_h: int = 65, desc_dim: int = 256,
                 channels=(64, 64, 64, 64, 128, 128, 128, 128)):
        super().__init__()
        c = channels
        self.conv1a, self.conv1b = conv3(1, c[0]), conv3(c[0], c[1])
        self.conv2a, self.conv2b = conv3(c[1], c[2]), conv3(c[2], c[3])
        self.conv3a, self.conv3b = conv3(c[3], c[4]), conv3(c[4], c[5])
        self.conv4a, self.conv4b = conv3(c[5], c[6]), conv3(c[6], c[7])
        self.convPa, self.convPb = conv3(c[7], 256), conv1(256, det_h)
        self.convDa, self.convDb = conv3(c[7], 256), conv1(256, desc_dim)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 1] grey in [0, 1] -> {'semi', 'desc'} (NHWC)."""
        with full_f32():
            y = x.permute(0, 3, 1, 2)
            for i, (a, b) in enumerate(((self.conv1a, self.conv1b), (self.conv2a, self.conv2b),
                                        (self.conv3a, self.conv3b),
                                        (self.conv4a, self.conv4b))):
                if i:
                    y = F.max_pool2d(y, 2)
                y = F.relu(b(F.relu(a(y))))
            semi = self.convPb(F.relu(self.convPa(y)))
            desc = self.convDb(F.relu(self.convDa(y)))
        return {"semi": semi.permute(0, 2, 3, 1),
                "desc": normalize_desc(desc.permute(0, 2, 3, 1))}


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """`bn` on NCHW x: on its running statistics in eval mode; in train
    mode on the batch statistics of each of `groups` equal slices of the
    batch, each slice updating the running buffers in turn."""
    if not bn.training:
        return bn(x)
    if x.shape[0] % groups:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {groups} groups")
    outs = [F.batch_norm(xg, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=True, momentum=bn.momentum, eps=bn.eps)
            for xg in x.chunk(groups)]
    bn.num_batches_tracked.add_(groups)
    return torch.cat(outs) if groups > 1 else outs[0]


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2, pytorch-superpoint's `double_conv`."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(conv3(cin, cout), nn.BatchNorm2d(cout, eps=BN_EPS),
                                  nn.ReLU(inplace=True), conv3(cout, cout),
                                  nn.BatchNorm2d(cout, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x, bn_groups: int = 1):
        seq = self.conv
        x = F.relu(batch_norm(seq[1], seq[0](x), bn_groups))
        return F.relu(batch_norm(seq[4], seq[3](x), bn_groups))


class InConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, bn_groups: int = 1):
        return self.conv(x, bn_groups)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x, bn_groups: int = 1):
        return self.mpconv[1](self.mpconv[0](x), bn_groups)


class SuperPointNetGauss2(nn.Module):
    """pytorch-superpoint's `SuperPointNet_gauss2`, the net the reference
    instantiates (train_good.py:224); built in eval mode."""

    def __init__(self, det_h: int = 65, desc_dim: int = 256):
        super().__init__()
        self.inc = InConv(1, 64)
        self.down1 = Down(64, 64)
        self.down2 = Down(64, 128)
        self.down3 = Down(128, 128)
        self.convPa, self.bnPa = conv3(128, 256), nn.BatchNorm2d(256, eps=BN_EPS)
        self.convPb, self.bnPb = conv1(256, det_h), nn.BatchNorm2d(det_h, eps=BN_EPS)
        self.convDa, self.bnDa = conv3(128, 256), nn.BatchNorm2d(256, eps=BN_EPS)
        self.convDb, self.bnDb = conv1(256, desc_dim), nn.BatchNorm2d(desc_dim, eps=BN_EPS)
        self.eval()

    def forward(self, x: torch.Tensor, bn_groups: int = 1) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 1] grey in [0, 1] -> {'semi', 'desc'} (NHWC);
        `bn_groups` splits the batch for train-mode BatchNorm."""
        g = bn_groups
        with full_f32():
            y = x.permute(0, 3, 1, 2)
            for block in (self.inc, self.down1, self.down2, self.down3):
                y = block(y, g)
            d = F.relu(batch_norm(self.bnPa, self.convPa(y), g))
            semi = batch_norm(self.bnPb, self.convPb(d), g)
            e = F.relu(batch_norm(self.bnDa, self.convDa(y), g))
            desc = batch_norm(self.bnDb, self.convDb(e), g)
        return {"semi": semi.permute(0, 2, 3, 1),
                "desc": normalize_desc(desc.permute(0, 2, 3, 1))}


def flatten_detection(semi: torch.Tensor) -> torch.Tensor:
    """semi [B, H/8, W/8, 65] -> heatmap [B, H, W]: softmax over the 65
    channels, drop the dustbin, depth-to-space the 64 cell scores."""
    prob = torch.softmax(semi, dim=-1)[..., :64]
    B, Hc, Wc, _ = prob.shape
    return prob.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
