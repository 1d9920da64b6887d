"""Process mesh and data-parallel plumbing over `torch.distributed`.

Counterpart of `deepfepe_tpu/parallel/mesh.py`. The JAX package lays its
devices out as a (data, model) `jax.sharding.Mesh` and lets XLA emit the
`psum`s; here every process is one rank of a `torch.distributed` world, the
ranks are laid out row-major as the JAX mesh lays out its devices
(`rank = d * n_model + m`, `np.array(devices).reshape(n_data, n_model)`),
and the collectives are explicit:

- the data group of a rank holds the ranks with its model coordinate m
  (gradients are averaged over it, batches are split over it);
- the model group holds the ranks with its data coordinate d (the tensor-
  and correspondence-parallel layers gather and sum over it).

The backend is the caller's choice, never a fallback: NCCL where each rank
has a card of its own, gloo on the CPU or where ranks share a card (gloo
carries CUDA tensors through host copies; NCCL refuses two ranks on one
device). Only three collectives are used, each for every backend alike:
`all_reduce`, `all_gather` and `broadcast`.

Autograd conventions (Megatron's f and g): a value replicated over a group
is counted once in the objective. `reduce` sums partials into a
replicated value (backward: the identity, since every rank holds the
same cotangent); `copy` marks a replicated value entering rank-local work
(backward: the sum of the ranks' cotangents); `gather` concatenates
shards into a replicated value (backward: this rank's slice). Over the
data group each rank's loss is its own rows' and the step averages the
gradients, so batch statistics shared across it (sync BatchNorm) take
`reduce` then `copy`. (`torch.distributed.nn.functional.all_gather` is
not used: its backward sums every rank's cotangent by reduce-scatter or
all-to-all, collectives outside the three, and under replicated
cotangents that sum is the model group's size times the gradient.)

Without a process group nothing here runs: every path of the port takes
`mesh=None` and behaves as on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")
# A peer that fails ends its collectives; the others raise once this passes.
TIMEOUT = timedelta(seconds=600)


def init_distributed(backend: str, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> tuple[int, int]:
    """Join the world: `coordinator` 'host:port' with `num_processes` and
    `process_id` (the JAX launcher's flags), or torchrun's environment
    (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) when it is None.
    Returns (rank, world size)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    else:
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("no --coordinator and no torchrun environment (WORLD_SIZE): "
                             "say how to reach the other processes")
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where given ('cpu' for the CPU), else
    the card of its local rank (LOCAL_RANK, else the rank) modulo the cards
    present, so ranks beyond the card count share cards."""
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass
class Mesh:
    """This rank's place in the (data, model) layout."""

    n_data: int
    n_model: int
    rank: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def d(self) -> int:
        """The data coordinate (which rows of the batch)."""
        return self.rank // self.n_model

    @property
    def m(self) -> int:
        """The model coordinate (which shard of the wide layers)."""
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return {DATA_AXIS: self.d, MODEL_AXIS: self.m}[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The (n_data, n_model) mesh over the initialized world (n_data =
    world // n_model when None); every rank calls it with the same
    arguments, since each group is created by all ranks in one order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {world} ranks")
    layout = np.arange(world).reshape(n_data, n_model)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group(layout[:, m].tolist())
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(layout[d].tolist())
        if rank // n_model == d:
            model_group = g
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current card
    return Mesh(n_data, n_model, rank, data_group, model_group, dev)


def make_hybrid_mesh(n_model: int = 1, device=None) -> Mesh:
    """The multi-host layout: process-major data axis x model axis. Each
    process is one rank, so this is `make_mesh(world // n_model, n_model)`:
    the ranks of one host (consecutive under torchrun) fill the model axis
    first, as the JAX package's process-major device order does."""
    return make_mesh(None, n_model, device)


def _bounds(mesh: Mesh, n: int, axis: str) -> tuple[int, int]:
    """This rank's equal share [k n / size, (k + 1) n / size) of n entries
    along `axis` (equal shares, so local means combine into the global one)."""
    size, k = mesh.size(axis), mesh.coord(axis)
    if n % size:
        raise ValueError(f"{n} entries do not split over the {size} ranks of {axis!r}")
    return k * n // size, (k + 1) * n // size


def shard(mesh: Mesh, x: torch.Tensor, dim: int = 0, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's slice of x along `dim`, split over `axis`."""
    lo, hi = _bounds(mesh, x.shape[dim], axis)
    return x.narrow(dim, lo, hi - lo)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict[str, torch.Tensor]:
    """This rank's rows [d B / n_data, (d + 1) B / n_data) of a global host
    batch, on its device (the JAX launcher's `local_rows` and
    `shard_batch` in one)."""
    lo, hi = _bounds(mesh, len(next(iter(batch.values()))), DATA_AXIS)
    return {k: torch.as_tensor(np.asarray(v[lo:hi]) if not torch.is_tensor(v) else v[lo:hi],
                               device=mesh.device) for k, v in batch.items()}


@torch.no_grad()
def shard_params(mesh: Mesh, net: torch.nn.Module) -> None:
    """Every parameter and buffer of `net` set to rank 0's (whole, before
    any tensor-parallel slicing)."""
    for t in (*net.parameters(), *net.buffers()):
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def sum_over(group, *xs: torch.Tensor) -> list:
    """Each tensor (one dtype) summed over `group` by one all_reduce of one
    flat buffer; views of the buffer, shaped as the inputs."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].view_as(x))
        i += x.numel()
    return out


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Each gradient replaced by its mean over the data group: one
    all_reduce per dtype."""
    if mesh.n_data == 1:
        return
    params = [p for p in params if p.grad is not None]
    for dtype in sorted({p.grad.dtype for p in params}, key=str):
        grads = [p.grad for p in params if p.grad.dtype == dtype]
        for g, total in zip(grads, sum_over(mesh.data_group, *grads)):
            g.copy_(total / mesh.n_data)


@torch.no_grad()
def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor: the data group's rows in
    rank order (all_gather)."""
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def mean_scalars(mesh: Mesh, metrics: Dict) -> Dict:
    """`metrics` with every 0-d floating tensor replaced by its mean over the
    data group (one all_reduce); other entries stay this rank's."""
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point()]
    if mesh.n_data == 1 or not keys:
        return metrics
    sums = sum_over(mesh.data_group, *(metrics[k].detach().double() for k in keys))
    return {**metrics, **{k: (v / mesh.n_data).to(metrics[k].dtype) for k, v in zip(keys, sums)}}


def any_rank(flags: torch.Tensor) -> torch.Tensor:
    """Elementwise max of `flags` over the whole world (all_reduce MAX): a
    decision every rank then takes alike."""
    out = flags.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


class _Reduce(torch.autograd.Function):
    """Sum over a group; backward: the identity (replicated cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """The identity; backward: the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenate the group's shards along `dim` in rank order; backward:
    this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        size = dist.get_world_size(group)
        ctx.dim, ctx.index, ctx.width = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, group, dim % x.dim())


def sync_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of a rank-local partial that each rank then uses on
    its own rows (sync BatchNorm's statistics): `reduce`, then `copy`."""
    return copy(reduce(x, group), group)
