"""Carry DeepFNet and SuperPoint parameters across from the JAX package.

`deepfnet_state_from_flax` and `superpoint_state_from_flax` map the JAX
package's parameter trees, given as nested dicts of numpy arrays, to this
package's `state_dict()` keys. The port's modules use the reference
layout, so the output of the JAX package's `export_deepf_state` (Conv1d
weights [out, in, 1]) and `export_superpoint_gauss2_state` load as well,
with `load_state_dict(strict=True)`. The JAX package's own `.msgpack`
checkpoints are read without flax (`utils/msgpack_io.py`):
`deepfnet_state_from_msgpack` and `load_superpoint` take them through the
same two functions. `to_reference_layout` goes the other way, for the
checkpoints the port writes. `save_superpoint` writes a SuperPoint net as
the reference's `.pth.tar` (BatchNorm buffers included), and
`load_superpoint` reads one, a reference `.pth` or a flax `.msgpack`
(`superpoint_state_from_file` gives its state_dict). The descriptor-fusion
heads take the JAX package's trees through `feat_fusion_state_from_flax`
and `feat_fusion_2head_state_from_flax`; a BatchNorm ErrorEstimator's
through `error_estimator_state_from_flax` with its batch statistics.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

N_HIDDEN = 5
MSGPACK = ".msgpack"


def _np(x) -> np.ndarray:
    """A leaf as a numpy array: msgpack bfloat16 leaves come as torch
    tensors (numpy has no bfloat16), widened to float32 exactly."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x)


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v)) if np.asarray(v).dtype == np.int64
            else torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def _dense(sd: dict, key: str, p: Mapping) -> None:
    """flax Dense {kernel [in, out][, bias]} -> '<key>.weight' [out, in] (and bias)."""
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = _np(p["bias"])


def _affine(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])


def error_estimator_state_from_flax(tree: Mapping, prefix: str,
                                    stats: Mapping | None = None) -> Dict[str, torch.Tensor]:
    """{'Dense_i': {kernel [in, out], bias}, 'InstanceNorm1d_i': {scale,
    bias}} -> '<prefix>.fw.<j>.{weight, bias}' ('fw.<j>...' without a
    prefix). A tree with 'BatchNorm_i' (the `if_bn` net; `stats` its
    batch statistics {'BatchNorm_i': {mean, var}}) maps to the BatchNorm
    layout: Linear at fw.<4i>, BatchNorm at fw.<4i+1>, InstanceNorm at
    fw.<4i+2>, the final Linear (no bias) at fw.20."""
    pre = f"{prefix}.fw" if prefix else "fw"
    bn = "BatchNorm_0" in tree
    stride = 4 if bn else 3
    sd = {}
    for li in range(N_HIDDEN + 1):
        _dense(sd, f"{pre}.{stride * li}", tree[f"Dense_{li}"])
        if li < N_HIDDEN:
            _affine(sd, f"{pre}.{stride * li + stride - 2}", tree[f"InstanceNorm1d_{li}"])
            if bn:
                key = f"{pre}.{stride * li + 1}"
                _affine(sd, key, tree[f"BatchNorm_{li}"])
                s = (stats or {}).get(f"BatchNorm_{li}")
                if s is None:
                    raise KeyError(f"no batch statistics for {prefix} BatchNorm_{li}")
                sd[f"{key}.running_mean"] = _np(s["mean"])
                sd[f"{key}.running_var"] = _np(s["var"])
                sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)
    return _tensors(sd)


def feat_fusion_state_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX `ErrorEstimatorFeatFusion` tree -> the port module's state
    (the ErrorEstimator layout: Linear at fw.<3i>, InstanceNorm at
    fw.<3i+1>, the final Linear at fw.15)."""
    return error_estimator_state_from_flax(tree, prefix)


def feat_fusion_2head_state_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX `ErrorEstimatorFeatFusion2Head` tree (Dense_0-2 and
    InstanceNorm1d_0-2 the point stem, Dense_3-5 the descriptor stem,
    Dense_6-8 and InstanceNorm1d_3-4 the fused layers, in flax's order of
    creation) -> the port module's `pts_fw`, `des_fw` and `fuse_fw`."""
    pre = f"{prefix}." if prefix else ""
    sd: dict = {}
    for i in range(3):
        _dense(sd, f"{pre}pts_fw.{3 * i}", tree[f"Dense_{i}"])
        _affine(sd, f"{pre}pts_fw.{3 * i + 1}", tree[f"InstanceNorm1d_{i}"])
        _dense(sd, f"{pre}des_fw.{2 * i}", tree[f"Dense_{3 + i}"])
    for i in range(2):
        _dense(sd, f"{pre}fuse_fw.{3 * i}", tree[f"Dense_{6 + i}"])
        _affine(sd, f"{pre}fuse_fw.{3 * i + 1}", tree[f"InstanceNorm1d_{3 + i}"])
    _dense(sd, f"{pre}fuse_fw.6", tree["Dense_8"])
    return _tensors(sd)


def good_corres_state_from_flax(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX GoodCorresNet's {'<block>_conv': {kernel [in, out], bias},
    '<block>_in': {scale, bias}, 'logits': {...}} -> '<prefix>.<name>.
    {weight, bias}': the reference has no layout for this net, so the JAX
    package's names stay."""
    sd = {}
    for name, p in tree.items():
        if "kernel" in p:
            sd[f"{prefix}.{name}.weight"] = _np(p["kernel"]).T
        else:
            sd[f"{prefix}.{name}.weight"] = _np(p["scale"])
        sd[f"{prefix}.{name}.bias"] = _np(p["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def deepfnet_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DeepFNet's variables ({'params': {...}[, 'batch_stats']} or
    the inner parameter dict) -> this package's DeepFNet state_dict: the
    weight nets (ErrorEstimators, with BatchNorm where the tree has it, or
    GoodCorresNets) and, with learned offsets, `update_offsets`."""
    stats = params.get("batch_stats", {})
    params = params.get("params", params)
    sd = {}
    for name in ("input_weights", "update_weights", "update_offsets"):
        if name not in params:
            continue
        tree = params[name]
        sd.update(error_estimator_state_from_flax(tree, name, stats.get(name))
                  if "Dense_0" in tree else good_corres_state_from_flax(tree, name))
    return sd


def deepfnet_params_from_tree(tree: Mapping) -> Mapping:
    """The solver's parameter dict inside a flax checkpoint tree: a
    TrainState ({'params': {'params': ...}, 'opt_state', 'n_iter'}), a
    joint state's 'deepf_params', or bare parameters, peeled down to the
    dict that holds the weight nets."""
    while "input_weights" not in tree:
        key = next((k for k in ("params", "deepf_params") if isinstance(tree.get(k), Mapping)),
                   None)
        if key is None:
            raise KeyError(f"no solver parameters in a tree with keys {sorted(tree)}")
        tree = tree[key]
    return tree


def deepfnet_state_from_msgpack(path: str) -> tuple[Dict[str, torch.Tensor], int]:
    """A JAX DeepFNet `.msgpack` checkpoint -> (this package's state_dict,
    its n_iter, 0 where it has none). The Adam state of a TrainState file
    is not carried."""
    from .msgpack_io import load_params_msgpack

    tree = load_params_msgpack(path)
    n_iter = tree.get("n_iter")
    return (deepfnet_state_from_flax(deepfnet_params_from_tree(tree)),
            int(_np(n_iter)) if n_iter is not None else 0)


def to_reference_layout(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This package's DeepFNet state_dict -> the reference layout, whose
    Conv1d weights are [out, in, 1] (the inverse of the load hook), on the
    CPU."""
    return {k: (v[..., None] if v.dim() == 2 else v).detach().cpu().contiguous()
            for k, v in state_dict.items()}


GAUSS2_SEQ = {"conv0": 0, "bn0": 1, "conv1": 3, "bn1": 4}


def _conv_from_flax(sd: dict, key: str, p: Mapping) -> None:
    """flax Conv {kernel [kh, kw, in, out], bias} -> torch weight [out, in, kh, kw]."""
    sd[f"{key}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = _np(p["bias"])


def _bn_from_flax(sd: dict, key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])
    sd[f"{key}.running_mean"] = _np(s["mean"])
    sd[f"{key}.running_var"] = _np(s["var"])
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
    return _tensors(sd)


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


def superpoint_state_from_file(path: str) -> Dict[str, torch.Tensor]:
    """A SuperPoint checkpoint's state_dict in this package's keys: a
    reference `.pth` state dict or `.pth.tar` with `model_state_dict`
    (`module.` prefixes dropped), or the JAX package's flax `.msgpack`
    variables."""
    if str(path).endswith(MSGPACK):
        from .msgpack_io import load_params_msgpack

        return superpoint_state_from_flax(load_params_msgpack(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_superpoint(path: str, device=None, dtype=torch.float32) -> torch.nn.Module:
    """A SuperPoint checkpoint (`superpoint_state_from_file`) -> the
    matching net, in eval mode, computing in `dtype` (its parameters
    float32, as in the file): `SuperPointNetGauss2` when the file has
    BatchNorm keys (batch statistics), else `SuperPointNet`."""
    from ..frontend.superpoint import SuperPointNet, SuperPointNetGauss2

    sd = superpoint_state_from_file(path)
    gauss2 = any(k.endswith("running_mean") for k in sd)
    net = SuperPointNetGauss2(dtype=dtype) if gauss2 else SuperPointNet(dtype=dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(device)
