"""Sharded checkpoints of named components, over torch.distributed.checkpoint.

Counterpart of `deepfepe_tpu/train/orbax_ckpt.py`. The reference keeps
separate deepF and SuperPoint `.pth.tar` files for its staged recipe
(Train_model_pipeline.py:56-77, loader.py:196-229); here the separation is
the top-level component names of one checkpoint,

    {"deepF": {...}, "superPoint": {...}, "meta": {...}},

each restorable on its own (restore deepF without superPoint). Every rank
writes its part: a leaf replicated over ranks is written once, and a
tensor-parallel leaf is written as its shards, each under its own key
(`module_state`), so nothing is gathered to one rank.

The file format is torch.distributed.checkpoint's (a directory with a
`.metadata` file and one data file a rank), not Orbax's: a checkpoint
does not cross between the two packages. Weights still cross as before,
as the reference `.pth.tar` and the JAX package's flax `.msgpack`.

Without a process group the functions run in the calling process alone.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..parallel import tp
from ..parallel.mesh import Mesh

METRICS_FILE = "metrics.json"


def shard_key(key: str, index: int, n: int) -> str:
    """The checkpoint key of shard `index` of `n` of a tensor-parallel leaf."""
    return f"{key}#shard{index}of{n}"


def module_state(net: torch.nn.Module, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """`net.state_dict()` for a checkpoint: with `mesh`, each tensor-parallel
    leaf under the key of this rank's shard."""
    names = tp.sharded_names(net) if mesh is not None else {}
    return {shard_key(k, mesh.m, mesh.n_model) if k in names else k: v
            for k, v in net.state_dict().items()}


def load_module_state(net: torch.nn.Module, state: Dict[str, torch.Tensor],
                      mesh: Optional[Mesh] = None) -> None:
    """Load a `module_state` (restored) back into `net`, strictly."""
    names = tp.sharded_names(net) if mesh is not None else {}
    inv = {shard_key(k, mesh.m, mesh.n_model): k for k in names}
    net.load_state_dict({inv.get(k, k): v for k, v in state.items()}, strict=True)


def _abs(path: str) -> str:
    return os.path.abspath(path)


def save_sharded(path: str, components: Dict[str, Any]) -> str:
    """Write one checkpoint of named component trees (nested dicts of
    tensors and plain values); every rank of the world calls it."""
    path = _abs(path)
    dcp.save(components, checkpoint_id=path, no_dist=not dist.is_initialized())
    return path


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def restore_sharded(path: str, templates: Dict[str, Any]) -> Dict[str, Any]:
    """The components named in `templates` (trees of the saved structure
    whose tensors give shapes, dtypes and devices), read from `path`;
    components left out of `templates` are not read."""
    state = _copy(templates)
    dcp.load(state, checkpoint_id=_abs(path), no_dist=not dist.is_initialized())
    return state


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManagerWrapper:
    """Step-keyed checkpoints under `directory` (one folder a step), keeping
    `max_to_keep`: the latest, or with `best_fn_metric` the ones with the
    lowest value of that metric (the reference's best-val checkpoint). Rank
    0 writes the metrics and removes the rest."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 best_fn_metric: Optional[str] = None):
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep
        self.best_fn_metric = best_fn_metric
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self._path(int(d)),
                                                                     ".metadata")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metric(self, step: int) -> float:
        with open(os.path.join(self._path(step), METRICS_FILE)) as f:
            return json.load(f)[self.best_fn_metric]

    def save(self, step: int, components: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> None:
        if self.best_fn_metric and (metrics is None or self.best_fn_metric not in metrics):
            raise ValueError(f"best_fn_metric {self.best_fn_metric!r} needs that metric")
        save_sharded(self._path(step), components)
        if _rank() != 0:
            return
        if metrics is not None:
            with open(os.path.join(self._path(step), METRICS_FILE), "w") as f:
                json.dump(metrics, f)
        steps = self.all_steps()
        keep = (sorted(steps, key=self._metric)[:self.max_to_keep] if self.best_fn_metric
                else steps[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._path(s))

    def restore(self, step: int, templates: Dict[str, Any]) -> Dict[str, Any]:
        return restore_sharded(self._path(step), templates)

    def restore_latest(self, templates: Dict[str, Any]) -> Dict[str, Any]:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return self.restore(step, templates)
