"""Carry DeepFNet parameters across from the JAX package.

`deepfnet_state_from_flax` maps the JAX package's parameter tree, given as
nested dicts of numpy arrays, to this package's `DeepFNet.state_dict()`
keys. The port's submodules use the reference layout, so the output of the
JAX package's `export_deepf_state` (Conv1d weights [out, in, 1]) loads as
well, with `load_state_dict(strict=True)`. `to_reference_layout` goes the
other way, for the checkpoints the port writes.
"""

from __future__ import annotations

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


def deepfnet_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DeepFNet's params ({'params': {...}} or the inner dict) ->
    this package's DeepFNet state_dict."""
    params = params.get("params", params)
    sd = {}
    for name in ("input_weights", "update_weights"):
        sd.update(error_estimator_state_from_flax(params[name], name))
    return sd


def to_reference_layout(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This package's DeepFNet state_dict -> the reference layout, whose
    Conv1d weights are [out, in, 1] (the inverse of the load hook), on the
    CPU."""
    return {k: (v[..., None] if v.dim() == 2 else v).detach().cpu().contiguous()
            for k, v in state_dict.items()}
