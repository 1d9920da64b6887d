"""The PointNet-style per-correspondence weight networks.

Counterpart of `deepfepe_tpu/models/error_estimator.py`: `ErrorEstimator`
(with its BatchNorm variant), the descriptor-fusion heads
`ErrorEstimatorFeatFusion` and `ErrorEstimatorFeatFusion2Head`, and
`GoodCorresNet`. Layout is [B, N, C]: a 1x1 Conv1d over points is a Linear
over the channel axis.

Submodules follow the reference layout `fw.<i>` (Linear, InstanceNorm,
LeakyReLU per hidden layer, then the final Linear at `fw.15`), so a
reference-layout state_dict (Conv1d weights [out, in, 1]) loads with
`strict=True`; the trailing kernel axis is dropped on load. With `if_bn`
each hidden layer is Linear, BatchNorm, InstanceNorm, LeakyReLU
(`fw.<4i>` to `fw.<4i+3>`) and the final Linear, at `fw.20`, has no bias:
the layout of the JAX package's `export_error_estimator(..., if_bn=True)`.

`use_fused` routes the stack through `ops.mlp.fused_pointnet_mlp` (the
K2/K2b kernels on the card) under the JAX package's conditions: bfloat16
matmuls, no BatchNorm, C_in <= 128 and output_size <= 128; otherwise the
layers run one by one (so DeepFNet's descriptor-fused inputs, C_in 261 and
264, never reach K2). The parameters are the same either way; the fused
route never reads the hidden Linear biases, so they get no gradient there.
`tp` (None unless `parallel.tp.shard_params_tp` sharded the wide layers)
routes the forward through the tensor-parallel one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.mlp import MAX_IN, fused_pointnet_mlp

FEATURES = (64, 128, 1024, 512, 256)


class InstanceNorm1d(nn.Module):
    """torch.nn.InstanceNorm1d(C, affine=True) on [B, N, C]: normalizes over
    N per (batch, channel), biased variance, eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-2, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-2, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def _drop_conv_kernel_axis(state_dict, prefix, *args):
    for k in list(state_dict):
        if k.startswith(prefix) and k.endswith(".weight") and state_dict[k].dim() == 3:
            state_dict[k] = state_dict[k][..., 0]


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    y = x @ lin.weight.to(dtype).T
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _lecun_normal_(lin: nn.Linear, generator: torch.Generator | None) -> None:
    """The JAX package's Dense initializers: LeCun-normal kernels (truncated
    at two standard deviations), zero biases."""
    std = math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    if lin.bias is not None:
        lin.bias.zero_()


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the points and the batch of [B, N, C] (flax's
    `nn.BatchNorm(axis=-1)`), the reference's BatchNorm1d on [B, C, N].
    Batch statistics where `train`, else the running ones; the running
    buffers take torch's momentum update, as in the reference."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = nn.functional.batch_norm(x.transpose(-1, -2), self.running_mean, self.running_var,
                                     self.weight, self.bias, train, self.momentum, self.eps)
        return y.transpose(-1, -2)


class ErrorEstimator(nn.Module):
    """[B, N, C_in] -> [B, N, output_size] logits (float32 or wider).

    `dtype` is the matmul type (bfloat16 by default in the config).
    Parameters stay float32; InstanceNorm statistics are computed in at
    least float32. Hidden Linear biases are kept. `if_bn` adds BatchNorm
    before each InstanceNorm (`train` picks its statistics), computed in
    at least float32 as the JAX module's (its float32 parameters promote a
    bfloat16 input).
    """

    def __init__(self, in_features: int, output_size: int = 1,
                 features: Sequence[int] = FEATURES, negative_slope: float = 0.01,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False,
                 if_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_fused = use_fused
        self.if_bn = if_bn
        self.output_size = output_size
        self.negative_slope = negative_slope
        layers, c = [], in_features
        for f in features:
            layers += ([nn.Linear(c, f)] + ([BatchNorm(f)] if if_bn else [])
                       + [InstanceNorm1d(f), nn.LeakyReLU(negative_slope)])
            c = f
        layers.append(nn.Linear(c, output_size, bias=not if_bn))
        self.fw = nn.Sequential(*layers)
        self.stride = 4 if if_bn else 3
        self.tp = None
        self._register_load_state_dict_pre_hook(_drop_conv_kernel_axis)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initializers: LeCun-normal (truncated at two
        standard deviations) kernels, zero biases, unit norm scales."""
        for m in self.fw:
            if isinstance(m, nn.Linear):
                _lecun_normal_(m, generator)
            elif isinstance(m, (InstanceNorm1d, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.forward(self, x, train)
        if (self.use_fused and not self.if_bn and self.dtype == torch.bfloat16
                and x.shape[-1] <= MAX_IN and self.output_size <= MAX_IN):
            hidden = [self.fw[i] for i in range(0, len(self.fw) - 1, 3)]
            norms = [self.fw[i + 1] for i in range(0, len(self.fw) - 1, 3)]
            return fused_pointnet_mlp(
                x, [m.weight for m in hidden], [m.weight for m in norms],
                [m.bias for m in norms], self.fw[-1].weight, self.fw[-1].bias,
                self.negative_slope)
        dt = self.dtype
        acc = torch.promote_types(dt, torch.float32)
        x = x.to(dt)
        for i in range(0, len(self.fw) - 1, self.stride):
            x = _linear(x, self.fw[i], dt)
            if self.if_bn:
                x = self.fw[i + 1](x.to(acc), train)
            x = self.fw[i + self.stride - 2](x.to(acc)).to(dt)
            x = nn.functional.leaky_relu(x, self.negative_slope)
        return _linear(x, self.fw[-1], dt).to(acc)


class ErrorEstimatorFeatFusion(nn.Module):
    """Early fusion of the point features and the descriptors (the JAX
    package's `ErrorEstimatorFeatFusion`): their concatenation through
    Linear + InstanceNorm + ReLU layers (`features`) and a final Linear, in
    the layout of `ErrorEstimator` (`fw.<3i>`, `fw.<3i+1>`, `fw.15`). It
    computes in its inputs' dtype.

    pts_in [B, N, C_p], des_in [B, N, D] -> [B, N, output_size]."""

    def __init__(self, in_features: int, des_features: int, output_size: int = 1,
                 features: Sequence[int] = FEATURES):
        super().__init__()
        layers, c = [], in_features + des_features
        for f in features:
            layers += [nn.Linear(c, f), InstanceNorm1d(f), nn.ReLU()]
            c = f
        layers.append(nn.Linear(c, output_size))
        self.fw = nn.Sequential(*layers)
        self._register_load_state_dict_pre_hook(_drop_conv_kernel_axis)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset(self, generator)

    def forward(self, pts_in: torch.Tensor, des_in: torch.Tensor) -> torch.Tensor:
        x = torch.cat([pts_in, des_in.to(pts_in.dtype)], dim=-1)
        for i in range(0, len(self.fw) - 1, 3):
            x = torch.relu(self.fw[i + 1](_linear(x, self.fw[i], x.dtype)))
        return _linear(x, self.fw[-1], x.dtype)


class ErrorEstimatorFeatFusion2Head(nn.Module):
    """Late fusion (the JAX package's `ErrorEstimatorFeatFusion2Head`): a
    point stem (Linear + InstanceNorm + LeakyReLU to 64, 128, 1024) and a
    descriptor stem (Linear + LeakyReLU to 64, 128, 1024), concatenated,
    then Linear + InstanceNorm + LeakyReLU to 512 and 256 and the final
    Linear. Submodules `pts_fw` (Linear, InstanceNorm, LeakyReLU a layer),
    `des_fw` (Linear, LeakyReLU a layer) and `fuse_fw` (Linear,
    InstanceNorm, LeakyReLU a layer, then the final Linear); it computes in
    its inputs' dtype.

    pts_in [B, N, C_p], des_in [B, N, D] -> [B, N, output_size]."""

    STEM, FUSE = (64, 128, 1024), (512, 256)

    def __init__(self, in_features: int, des_features: int, output_size: int = 1,
                 negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope
        pts, des, c, d = [], [], in_features, des_features
        for f in self.STEM:
            pts += [nn.Linear(c, f), InstanceNorm1d(f), nn.LeakyReLU(negative_slope)]
            des += [nn.Linear(d, f), nn.LeakyReLU(negative_slope)]
            c = d = f
        fuse, c = [], 2 * self.STEM[-1]
        for f in self.FUSE:
            fuse += [nn.Linear(c, f), InstanceNorm1d(f), nn.LeakyReLU(negative_slope)]
            c = f
        fuse.append(nn.Linear(c, output_size))
        self.pts_fw, self.des_fw = nn.Sequential(*pts), nn.Sequential(*des)
        self.fuse_fw = nn.Sequential(*fuse)
        self._register_load_state_dict_pre_hook(_drop_conv_kernel_axis)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset(self, generator)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.leaky_relu(x, self.negative_slope)

    def forward(self, pts_in: torch.Tensor, des_in: torch.Tensor) -> torch.Tensor:
        x, y = pts_in, des_in.to(pts_in.dtype)
        for i in range(0, len(self.pts_fw), 3):
            x = self._act(self.pts_fw[i + 1](_linear(x, self.pts_fw[i], x.dtype)))
        for i in range(0, len(self.des_fw), 2):
            y = self._act(_linear(y, self.des_fw[i], y.dtype))
        z = torch.cat([x, y], dim=-1)
        for i in range(0, len(self.fuse_fw) - 1, 3):
            z = self._act(self.fuse_fw[i + 1](_linear(z, self.fuse_fw[i], z.dtype)))
        return _linear(z, self.fuse_fw[-1], z.dtype)


def _reset(net: nn.Module, generator: torch.Generator | None) -> None:
    """The JAX package's initializers: LeCun-normal kernels, zero biases,
    unit norm scales."""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m, generator)
        elif isinstance(m, InstanceNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()


class GoodCorresNet(nn.Module):
    """The legacy global-context weight net (`if_goodCorresArch`), the
    counterpart of the JAX package's `GoodCorresNet`: Linear + InstanceNorm
    + ReLU blocks, a stem (64, 128, 128) and a local MLP (512, 2048), a max
    over the points, the per-point concatenation of every block's output
    and the global feature (4,928 channels), a segmentation head (256, 256,
    128) and the logits. It runs in its input's type (float32 on the path).

    The reference has no parameter layout for it (its blocks came from an
    external package), so the submodules keep the JAX package's names:
    `stem<i>_conv`, `stem<i>_in`, `local<i>_...`, `seg<i>_...`, `logits`;
    Linear weights are [out, in] ([out, in, 1] in a checkpoint)."""

    STEM, LOCAL, SEG = (64, 128, 128), (512, 2048), (256, 256, 128)

    def __init__(self, in_features: int, output_size: int = 1):
        super().__init__()
        self.output_size = output_size
        self.blocks = []
        c, skip = in_features, 0
        for group, widths in (("stem", self.STEM), ("local", self.LOCAL)):
            for i, f in enumerate(widths):
                self._block(f"{group}{i}", c, f)
                c, skip = f, skip + f
        c = skip + c  # every block's output and the global feature
        for i, f in enumerate(self.SEG):
            self._block(f"seg{i}", c, f)
            c = f
        self.logits = nn.Linear(c, output_size)
        self._register_load_state_dict_pre_hook(_drop_conv_kernel_axis)

    def _block(self, name: str, c_in: int, c_out: int) -> None:
        setattr(self, f"{name}_conv", nn.Linear(c_in, c_out))
        setattr(self, f"{name}_in", InstanceNorm1d(c_out))
        self.blocks.append(name)

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f"{name}_in")(getattr(self, f"{name}_conv")(x)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initializers (LeCun-normal kernels, zero
        biases, unit norm scales)."""
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for name in self.blocks[:len(self.STEM) + len(self.LOCAL)]:
            x = self._run(name, x)
            skips.append(x)
        g = torch.amax(x, dim=-2, keepdim=True)  # the global feature
        x = torch.cat(skips + [g.expand(x.shape)], dim=-1)
        for name in self.blocks[len(self.STEM) + len(self.LOCAL):]:
            x = self._run(name, x)
        return self.logits(x)
