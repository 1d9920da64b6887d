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
`nn.BatchNorm2d` does, unless `update_stats=False` (a rerun of the same
forward, `pipeline.run_superpoint`'s remat). Convolutions run in full
float32 (`ops.conv.full_f32`).

`dtype` is the compute dtype, as the JAX modules' (bf16 on the JAX
package's production path): parameters and running buffers stay float32,
and each conv casts its input, weight and bias to `dtype` per call (the
conv in `dtype`, then the bias added in `dtype`). In eval mode BatchNorm
runs in `dtype` as `(x - mean) (rsqrt(var + eps) scale) + bias`, every
term cast to `dtype`; in train mode it takes its batch statistics in
float32 (E[x^2] - E[x]^2) and normalizes in `dtype`. `semi` and `desc`
return in float32 and the descriptor is normalized in float32. float32 runs
in the parameters' own dtype (the tests raise it to float64), through
`nn.Conv2d` and `F.batch_norm`.

Under data parallelism `sync_batch_norm(net, group)` makes the train-mode
BatchNorm take each group's statistics over the data group's ranks (the
global batch's, as the JAX package's sharded-array BatchNorm takes them):
the sums are all-reduced (`parallel.mesh.sync_sum`), the normalization is
applied to each rank's rows, and the running buffers take the same
update on every rank. float32 sums the squared deviations from the global
mean (a second all-reduce); a narrower dtype takes E[x^2] - E[x]^2 in
float32, as its one-device BatchNorm does.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.basic import safe_norm
from ..ops.conv import full_f32
from ..parallel.mesh import sync_sum

BN_EPS = 1e-5


def run_conv(conv: nn.Conv2d, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """`conv` on NCHW x in `dtype`: float32 is the module itself; another
    dtype casts x, the weight and the bias to it, convolves, then adds the
    bias (flax's nn.Conv with `dtype`)."""
    if dtype == torch.float32:
        return conv(x)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, padding=conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


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
                 channels=(64, 64, 64, 64, 128, 128, 128, 128), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = channels
        self.conv1a, self.conv1b = conv3(1, c[0]), conv3(c[0], c[1])
        self.conv2a, self.conv2b = conv3(c[1], c[2]), conv3(c[2], c[3])
        self.conv3a, self.conv3b = conv3(c[3], c[4]), conv3(c[4], c[5])
        self.conv4a, self.conv4b = conv3(c[5], c[6]), conv3(c[6], c[7])
        self.convPa, self.convPb = conv3(c[7], 256), conv1(256, det_h)
        self.convDa, self.convDb = conv3(c[7], 256), conv1(256, desc_dim)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 1] grey in [0, 1] -> {'semi', 'desc'} (NHWC)."""
        dt = self.dtype
        with full_f32():
            y = x.permute(0, 3, 1, 2)
            for i, (a, b) in enumerate(((self.conv1a, self.conv1b), (self.conv2a, self.conv2b),
                                        (self.conv3a, self.conv3b),
                                        (self.conv4a, self.conv4b))):
                if i:
                    y = F.max_pool2d(y, 2)
                y = F.relu(run_conv(b, F.relu(run_conv(a, y, dt)), dt))
            semi = run_conv(self.convPb, F.relu(run_conv(self.convPa, y, dt)), dt)
            desc = run_conv(self.convDb, F.relu(run_conv(self.convDa, y, dt)), dt)
        return {"semi": _out(semi), "desc": normalize_desc(_out(desc))}


def _out(y: torch.Tensor) -> torch.Tensor:
    """A head's NCHW output as NHWC, in float32 where it was computed in a
    narrower dtype."""
    y = y.permute(0, 2, 3, 1)
    return y.float() if y.dtype == torch.bfloat16 else y


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, groups: int = 1, dtype=torch.float32,
               update_stats: bool = True) -> torch.Tensor:
    """`bn` on NCHW x: on its running statistics in eval mode; in train
    mode on the batch statistics of each of `groups` equal slices of the
    batch, each slice updating the running buffers in turn (none with
    `update_stats` False). Computes in `dtype` (module docstring)."""
    if not bn.training:
        if dtype == torch.float32:
            return bn(x)
        mul = torch.rsqrt(bn.running_var.to(dtype) + bn.eps) * bn.weight.to(dtype)
        return ((x.to(dtype) - bn.running_mean.to(dtype)[:, None, None]) * mul[:, None, None]
                + bn.bias.to(dtype)[:, None, None])
    if x.shape[0] % groups:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {groups} groups")
    if getattr(bn, "sync_group", None) is not None:
        return _sync_batch_norm(bn, x, groups, dtype, update_stats)
    if dtype == torch.float32:
        # A rerun updates throwaway copies: the same operation as the forward's.
        rm, rv = (bn.running_mean, bn.running_var) if update_stats else \
            (bn.running_mean.clone(), bn.running_var.clone())
        outs = [F.batch_norm(xg, rm, rv, bn.weight, bn.bias, training=True,
                             momentum=bn.momentum, eps=bn.eps) for xg in x.chunk(groups)]
    else:
        outs = []
        for xg in x.chunk(groups):
            xf = xg.float()
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
            if update_stats:
                n = xg.numel() // xg.shape[1]
                m = bn.momentum
                with torch.no_grad():
                    bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
                    bn.running_var.copy_((1.0 - m) * bn.running_var + m * (var * (n / max(n - 1, 1))))
            mul = torch.rsqrt(var.to(dtype) + bn.eps) * bn.weight.to(dtype)
            outs.append((xg.to(dtype) - mean.to(dtype)[:, None, None]) * mul[:, None, None]
                        + bn.bias.to(dtype)[:, None, None])
    if update_stats:
        bn.num_batches_tracked.add_(groups)
    return torch.cat(outs) if groups > 1 else outs[0]


def _sync_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, groups: int, dtype,
                     update_stats: bool) -> torch.Tensor:
    """Train-mode `batch_norm` with each group's statistics over the ranks
    of `bn.sync_group` (module docstring); the ranks' batches are equal."""
    group = bn.sync_group
    native = dtype == torch.float32
    acc = torch.promote_types(x.dtype, torch.float32) if native else torch.float32
    xs = x.to(acc).unflatten(0, (groups, -1))  # [g, b, C, H, W]
    n = xs[0].numel() // xs.shape[2] * dist.get_world_size(group)
    dims = (1, 3, 4)
    mean = sync_sum(xs.sum(dims), group) / n  # [g, C]
    if native:
        dev = xs - mean[:, None, :, None, None]
        var = sync_sum((dev * dev).sum(dims), group) / n
    else:
        var = sync_sum((xs * xs).sum(dims), group) / n - mean * mean
    if update_stats:
        m = bn.momentum
        with torch.no_grad():
            for g in range(groups):
                bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean[g])
                bn.running_var.copy_((1.0 - m) * bn.running_var
                                     + m * (var[g] * (n / max(n - 1, 1))))
        bn.num_batches_tracked.add_(groups)
    cdt = acc if native else dtype
    mul = torch.rsqrt(var.to(cdt) + bn.eps) * bn.weight.to(cdt)
    y = ((xs.to(cdt) - mean.to(cdt)[:, None, :, None, None]) * mul[:, None, :, None, None]
         + bn.bias.to(cdt)[:, None, None])
    return y.flatten(0, 1).to(x.dtype if native else dtype)


@contextlib.contextmanager
def sync_batch_norm(net: nn.Module, group):
    """Inside the block the train-mode BatchNorm layers of `net` take their
    statistics over the ranks of `group` (the rerun of a rematerialized
    forward included, when the backward runs inside the block)."""
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.sync_group = group
    try:
        yield
    finally:
        for m in bns:
            m.sync_group = None


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2, pytorch-superpoint's `double_conv`."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(conv3(cin, cout), nn.BatchNorm2d(cout, eps=BN_EPS),
                                  nn.ReLU(inplace=True), conv3(cout, cout),
                                  nn.BatchNorm2d(cout, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x, bn_groups: int = 1, dtype=torch.float32, update_stats: bool = True):
        seq = self.conv
        kw = dict(groups=bn_groups, dtype=dtype, update_stats=update_stats)
        x = F.relu(batch_norm(seq[1], run_conv(seq[0], x, dtype), **kw))
        return F.relu(batch_norm(seq[4], run_conv(seq[3], x, dtype), **kw))


class InConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, bn_groups: int = 1, dtype=torch.float32, update_stats: bool = True):
        return self.conv(x, bn_groups, dtype, update_stats)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x, bn_groups: int = 1, dtype=torch.float32, update_stats: bool = True):
        return self.mpconv[1](self.mpconv[0](x), bn_groups, dtype, update_stats)


class SuperPointNetGauss2(nn.Module):
    """pytorch-superpoint's `SuperPointNet_gauss2`, the net the reference
    instantiates (train_good.py:224); built in eval mode."""

    def __init__(self, det_h: int = 65, desc_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.inc = InConv(1, 64)
        self.down1 = Down(64, 64)
        self.down2 = Down(64, 128)
        self.down3 = Down(128, 128)
        self.convPa, self.bnPa = conv3(128, 256), nn.BatchNorm2d(256, eps=BN_EPS)
        self.convPb, self.bnPb = conv1(256, det_h), nn.BatchNorm2d(det_h, eps=BN_EPS)
        self.convDa, self.bnDa = conv3(128, 256), nn.BatchNorm2d(256, eps=BN_EPS)
        self.convDb, self.bnDb = conv1(256, desc_dim), nn.BatchNorm2d(desc_dim, eps=BN_EPS)
        self.eval()

    def forward(self, x: torch.Tensor, bn_groups: int = 1,
                update_stats: bool = True) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 1] grey in [0, 1] -> {'semi', 'desc'} (NHWC);
        `bn_groups` splits the batch for train-mode BatchNorm, which updates
        the running buffers unless `update_stats` is False."""
        dt = self.dtype
        kw = dict(groups=bn_groups, dtype=dt, update_stats=update_stats)
        with full_f32():
            y = x.permute(0, 3, 1, 2)
            for block in (self.inc, self.down1, self.down2, self.down3):
                y = block(y, bn_groups, dt, update_stats)
            d = F.relu(batch_norm(self.bnPa, run_conv(self.convPa, y, dt), **kw))
            semi = batch_norm(self.bnPb, run_conv(self.convPb, d, dt), **kw)
            e = F.relu(batch_norm(self.bnDa, run_conv(self.convDa, y, dt), **kw))
            desc = batch_norm(self.bnDb, run_conv(self.convDb, e, dt), **kw)
        return {"semi": _out(semi), "desc": normalize_desc(_out(desc))}


def flatten_detection(semi: torch.Tensor) -> torch.Tensor:
    """semi [B, H/8, W/8, 65] -> heatmap [B, H, W]: softmax over the 65
    channels, drop the dustbin, depth-to-space the 64 cell scores."""
    prob = torch.softmax(semi, dim=-1)[..., :64]
    B, Hc, Wc, _ = prob.shape
    return prob.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
