"""The PointNet-style per-correspondence weight network.

Counterpart of the base `ErrorEstimator` and `InstanceNorm1d` of
`deepfepe_tpu/models/error_estimator.py`. Layout is [B, N, C]: a 1x1
Conv1d over points is a Linear over the channel axis.

Submodules follow the reference layout `fw.<i>` (Linear, InstanceNorm,
LeakyReLU per hidden layer, then the final Linear at `fw.15`), so a
reference-layout state_dict (Conv1d weights [out, in, 1]) loads with
`strict=True`; the trailing kernel axis is dropped on load.

`use_fused` routes the stack through `ops.mlp.fused_pointnet_mlp` (the
K2/K2b kernels on the card) under the JAX package's conditions: bfloat16
matmuls, C_in <= 128 and output_size <= 128; otherwise the layers run one
by one. The parameters are the same either way; the fused route never
reads the hidden Linear biases, so they get no gradient there.
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


class ErrorEstimator(nn.Module):
    """[B, N, C_in] -> [B, N, output_size] logits (float32 or wider).

    `dtype` is the matmul type (bfloat16 by default in the config).
    Parameters stay float32; InstanceNorm statistics are computed in at
    least float32. Hidden Linear biases are kept.
    """

    def __init__(self, in_features: int, output_size: int = 1,
                 features: Sequence[int] = FEATURES, negative_slope: float = 0.01,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_fused = use_fused
        self.output_size = output_size
        self.negative_slope = negative_slope
        layers, c = [], in_features
        for f in features:
            layers += [nn.Linear(c, f), InstanceNorm1d(f), nn.LeakyReLU(negative_slope)]
            c = f
        layers.append(nn.Linear(c, output_size))
        self.fw = nn.Sequential(*layers)
        self._register_load_state_dict_pre_hook(_drop_conv_kernel_axis)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's initializers: LeCun-normal (truncated at two
        standard deviations) kernels, zero biases, unit norm scales."""
        for m in self.fw:
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, InstanceNorm1d):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.use_fused and self.dtype == torch.bfloat16 and x.shape[-1] <= MAX_IN
                and self.output_size <= MAX_IN):
            hidden = [self.fw[i] for i in range(0, len(self.fw) - 1, 3)]
            norms = [self.fw[i + 1] for i in range(0, len(self.fw) - 1, 3)]
            return fused_pointnet_mlp(
                x, [m.weight for m in hidden], [m.weight for m in norms],
                [m.bias for m in norms], self.fw[-1].weight, self.fw[-1].bias,
                self.negative_slope)
        dt = self.dtype
        acc = torch.promote_types(dt, torch.float32)
        x = x.to(dt)
        for i in range(0, len(self.fw) - 1, 3):
            lin, norm = self.fw[i], self.fw[i + 1]
            x = x @ lin.weight.to(dt).T + lin.bias.to(dt)
            x = norm(x.to(acc)).to(dt)
            x = nn.functional.leaky_relu(x, self.negative_slope)
        lin = self.fw[-1]
        x = x @ lin.weight.to(dt).T + lin.bias.to(dt)
        return x.to(acc)


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
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, InstanceNorm1d):
                m.weight.fill_(1.0)
                m.bias.zero_()

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
