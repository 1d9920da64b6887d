"""Carry DeepFNet and SuperPoint parameters across from the JAX package.

`deepfnet_state_from_flax` and `superpoint_state_from_flax` map the JAX
package's parameter trees, given as nested dicts of numpy arrays, to this
package's `state_dict()` keys. The port's modules use the reference
layout, so the output of the JAX package's `export_deepf_state` (Conv1d
weights [out, in, 1]) and `export_superpoint_gauss2_state` load as well,
with `load_state_dict(strict=True)`. `to_reference_layout` goes the other
way, for the checkpoints the port writes. `save_superpoint` writes a
SuperPoint net as the reference's `.pth.tar` (BatchNorm buffers
included), and `load_superpoint` reads one, or a reference `.pth`.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

N_HIDDEN = 5


def error_estimator_state_from_flax(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """{'Dense_i': {kernel [in, out], bias}, 'InstanceNorm1d_i': {scale,
    bias}} -> '<prefix>.fw.<j>.{weight, bias}' ('fw.<j>...' without a
    prefix)."""
    pre = f"{prefix}.fw" if prefix else "fw"
    sd = {}
    for li in range(N_HIDDEN + 1):
        dense = tree[f"Dense_{li}"]
        sd[f"{pre}.{3 * li}.weight"] = np.asarray(dense["kernel"]).T
        sd[f"{pre}.{3 * li}.bias"] = np.asarray(dense["bias"])
        if li < N_HIDDEN:
            norm = tree[f"InstanceNorm1d_{li}"]
            sd[f"{pre}.{3 * li + 1}.weight"] = np.asarray(norm["scale"])
            sd[f"{pre}.{3 * li + 1}.bias"] = np.asarray(norm["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def good_corres_state_from_flax(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX GoodCorresNet's {'<block>_conv': {kernel [in, out], bias},
    '<block>_in': {scale, bias}, 'logits': {...}} -> '<prefix>.<name>.
    {weight, bias}': the reference has no layout for this net, so the JAX
    package's names stay."""
    sd = {}
    for name, p in tree.items():
        if "kernel" in p:
            sd[f"{prefix}.{name}.weight"] = np.asarray(p["kernel"]).T
        else:
            sd[f"{prefix}.{name}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.{name}.bias"] = np.asarray(p["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def deepfnet_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DeepFNet's params ({'params': {...}} or the inner dict) ->
    this package's DeepFNet state_dict: the weight nets (ErrorEstimators
    or GoodCorresNets) and, with learned offsets, `update_offsets`."""
    params = params.get("params", params)
    sd = {}
    for name in ("input_weights", "update_weights", "update_offsets"):
        if name not in params:
            continue
        tree = params[name]
        sd.update(error_estimator_state_from_flax(tree, name) if "Dense_0" in tree
                  else good_corres_state_from_flax(tree, name))
    return sd


def to_reference_layout(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This package's DeepFNet state_dict -> the reference layout, whose
    Conv1d weights are [out, in, 1] (the inverse of the load hook), on the
    CPU."""
    return {k: (v[..., None] if v.dim() == 2 else v).detach().cpu().contiguous()
            for k, v in state_dict.items()}


GAUSS2_SEQ = {"conv0": 0, "bn0": 1, "conv1": 3, "bn1": 4}


def _conv_from_flax(sd: dict, key: str, p: Mapping) -> None:
    """flax Conv {kernel [kh, kw, in, out], bias} -> torch weight [out, in, kh, kw]."""
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _bn_from_flax(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])
    sd[f"{key}.running_mean"] = np.asarray(s["mean"])
    sd[f"{key}.running_var"] = np.asarray(s["var"])
    sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def superpoint_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX SuperPointNet or SuperPointNetGauss2 variables ({'params'[,
    'batch_stats']}) -> the state_dict of this package's net of the same
    kind (gauss2 when there are batch statistics)."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats")
    sd: dict = {}
    if stats is None:
        for name, p in params.items():
            _conv_from_flax(sd, name, p)
    else:
        for block in ("inc", "down1", "down2", "down3"):
            base = "inc.conv.conv" if block == "inc" else f"{block}.mpconv.1.conv"
            for name, i in GAUSS2_SEQ.items():
                if name.startswith("conv"):
                    _conv_from_flax(sd, f"{base}.{i}", params[block][name])
                else:
                    _bn_from_flax(sd, f"{base}.{i}", params[block][name], stats[block][name])
        for head in ("convPa", "convPb", "convDa", "convDb"):
            _conv_from_flax(sd, head, params[head])
        for head in ("bnPa", "bnPb", "bnDa", "bnDb"):
            _bn_from_flax(sd, head, params[head], stats[head])
    return {k: torch.tensor(np.ascontiguousarray(v)) if v.dtype == np.int64
            else torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def to_cpu(obj):
    """Tensors (in dicts, lists and tuples) detached onto the CPU, so a
    checkpoint loads on any device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_superpoint(path: str, net: torch.nn.Module, n_iter: int,
                    opt: torch.optim.Optimizer | None = None, loss: float = 0.0) -> None:
    """The reference's SuperPoint checkpoint (`superPointNet_<n>_checkpoint
    .pth.tar`): n_iter, model_state_dict (the reference's keys, BatchNorm
    running statistics and counts included), optimizer_state_dict, loss."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"n_iter": int(n_iter), "model_state_dict": to_cpu(net.state_dict()),
                "optimizer_state_dict": to_cpu(opt.state_dict()) if opt is not None else {},
                "loss": float(loss)}, path)


def load_superpoint(path: str, device=None, dtype=torch.float32) -> torch.nn.Module:
    """A reference SuperPoint checkpoint (`.pth` state dict, or `.pth.tar`
    with `model_state_dict`) -> the matching net, in eval mode, computing
    in `dtype` (its parameters float32, as in the file):
    `SuperPointNetGauss2` when the file has BatchNorm keys, else
    `SuperPointNet`."""
    from ..frontend.superpoint import SuperPointNet, SuperPointNetGauss2

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    gauss2 = any(k.endswith("running_mean") for k in sd)
    net = SuperPointNetGauss2(dtype=dtype) if gauss2 else SuperPointNet(dtype=dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(device)
