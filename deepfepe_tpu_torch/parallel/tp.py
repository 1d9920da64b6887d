"""Tensor parallelism for the weight-net MLPs over the mesh's model group.

Counterpart of `deepfepe_tpu/parallel/tp.py`: every ErrorEstimator layer
whose channel count is at least `min_channels` and divides by n_model
(the 1024-, 512- and 256-wide layers) is column-sharded: its Linear
weight rows, bias, BatchNorm and InstanceNorm leaves keep this rank's
slice of the output channels. In the JAX package XLA inserts the
collectives from the committed shardings; here they are explicit. Each
sharded layer takes its (replicated) input through `mesh.copy`, computes
its channels, normalizes them (InstanceNorm is per channel over N, so it
stays local) and gathers the full width over the model group with
`mesh.gather` before the next layer; the narrow layers and the 1-wide
head run replicated.

Weights enter whole (a `.pth.tar` through `load_state_dict(strict=True)`,
or `shard_params`' broadcast) and are sliced afterwards, in place, so an
optimizer built before keeps its parameters. Under tensor parallelism
the MLP runs unfused, as the JAX package runs it there: `use_pallas_mlp`
with n_model > 1 raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.error_estimator import ErrorEstimator, _linear
from .mesh import Mesh, copy, gather

MIN_CHANNELS = 256


@dataclass
class TPShard:
    """An ErrorEstimator's sharding: the model group, its size, this rank's
    index in it and the `fw` indices of the sharded Linear layers."""

    group: object
    n: int
    index: int
    layers: Tuple[int, ...]

    def forward(self, est: ErrorEstimator, x: torch.Tensor, train: bool) -> torch.Tensor:
        return tp_forward(est, x, train)


def weight_nets(net: nn.Module) -> Dict[str, nn.Module]:
    """`net`'s weight MLPs by name (DeepFNet's input_weights,
    update_weights and, with learned offsets, update_offsets)."""
    return {name: m for name, m in net.named_children()
            if name in ("input_weights", "update_weights", "update_offsets")}


@torch.no_grad()
def shard_params_tp(mesh: Mesh, net: nn.Module, opt: torch.optim.Optimizer | None = None,
                    min_channels: int = MIN_CHANNELS) -> None:
    """Slice every wide ErrorEstimator layer of `net` to this rank's
    channels (and `opt`'s moments of those parameters, where it has any)
    and mark the estimator for the tensor-parallel forward."""
    n, idx = mesh.n_model, mesh.m
    if n == 1:
        return
    for name, est in weight_nets(net).items():
        if not isinstance(est, ErrorEstimator):
            raise ValueError(f"tensor parallelism shards ErrorEstimator layers; {name} is a "
                             f"{type(est).__name__}")
        if est.use_fused:
            raise ValueError("use_pallas_mlp runs the fused MLP kernels, which take whole "
                             "layers: set it false to shard the MLP over the model group")
        layers = tuple(i for i in range(0, len(est.fw) - 1, est.stride)
                       if est.fw[i].out_features >= min_channels
                       and est.fw[i].out_features % n == 0)
        for i in layers:
            k = est.fw[i].out_features // n
            for mod in [est.fw[j] for j in range(i, i + est.stride - 1)]:
                for t in (*mod.parameters(recurse=False), *mod.buffers(recurse=False)):
                    if t.dim() >= 1 and t.shape[0] == est.fw[i].out_features:
                        t.data = t.data[idx * k:(idx + 1) * k].clone()
                        for key, v in (opt.state.get(t, {}) if opt is not None else {}).items():
                            if torch.is_tensor(v) and v.dim() >= 1:
                                opt.state[t][key] = v[idx * k:(idx + 1) * k].clone()
        est.tp = TPShard(mesh.model_group, n, idx, layers)


def tp_forward(est: ErrorEstimator, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """ErrorEstimator's unfused forward with its sharded layers split over
    the model group (the estimator's `forward` comes here when `est.tp` is
    set). Each sharded layer gathers in the normalization's type."""
    tp = est.tp
    dt = est.dtype
    acc = torch.promote_types(dt, torch.float32)
    x = x.to(dt)
    for i in range(0, len(est.fw) - 1, est.stride):
        sharded = i in tp.layers
        y = _linear(copy(x, tp.group) if sharded else x, est.fw[i], dt)
        if est.if_bn:
            y = est.fw[i + 1](y.to(acc), train)
        y = est.fw[i + est.stride - 2](y.to(acc))
        if sharded:
            y = gather(y, tp.group, dim=-1)
        x = nn.functional.leaky_relu(y.to(dt), est.negative_slope)
    return _linear(x, est.fw[-1], dt).to(acc)


def sharded_names(net: nn.Module) -> Dict[str, int]:
    """The state_dict keys of `net`'s sharded leaves, each with its full
    size along dim 0."""
    out = {}
    for name, est in weight_nets(net).items():
        tp = getattr(est, "tp", None)
        if tp is None:
            continue
        for i in tp.layers:
            full = est.fw[i].out_features
            for j in range(i, i + est.stride - 1):
                for key, t in est.fw[j].state_dict().items():
                    if t.dim() >= 1 and t.shape[0] * tp.n == full:
                        out[f"{name}.fw.{j}.{key}"] = full
    return out


@torch.no_grad()
def gather_full(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A sharded leaf's whole tensor, concatenated over the model group."""
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=0)


@torch.no_grad()
def full_state_dict(mesh: Mesh, net: nn.Module) -> Dict[str, torch.Tensor]:
    """`net.state_dict()` with every sharded leaf gathered whole (a
    collective: every rank of the world calls it)."""
    names = sharded_names(net)
    return {k: gather_full(mesh, v) if k in names else v for k, v in net.state_dict().items()}


@torch.no_grad()
def full_optimizer_state(mesh: Mesh, net: nn.Module, opt: torch.optim.Optimizer) -> Dict:
    """`opt.state_dict()` with the moments of sharded parameters gathered
    whole (a collective, as `full_state_dict`)."""
    names = sharded_names(net)
    sharded = {id(p) for k, p in net.named_parameters() if k in names}
    params = [p for g in opt.param_groups for p in g["params"]]
    sd = opt.state_dict()
    for i, p in enumerate(params):
        if id(p) in sharded and i in sd["state"]:
            sd["state"][i] = {k: gather_full(mesh, v) if torch.is_tensor(v) and v.dim() >= 1
                              else v for k, v in sd["state"][i].items()}
    return sd
