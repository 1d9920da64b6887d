"""The outer training loop: validation cadence, checkpoints, metric logs.

Counterpart of `deepfepe_tpu/train/loop.py` on one device: periodic
validation over the val stream, the val-in-train window, periodic and
best checkpoints keyed by n_iter, JSONL plus tfevents metric logs, resume
from a checkpoint, and a `torch.profiler` capture of the steps
[profile_start, profile_start + profile_steps) when `profile_dir` is set.

Checkpoints are `.pth.tar` files in the reference's `save_checkpoint`
schema (Train_model_pipeline.py:56-77; the JAX package's
`save_reference_checkpoint`): n_iter, n_iter_val, model_state_dict in the
reference Conv1d layout, optimizer_state_dict (the Adam state) and loss.
`load_checkpoint` also reads the JAX package's flax `.msgpack` files.

With a `parallel.Mesh` (`mesh`) the Trainer is one rank of a data-parallel
(and, after `parallel.shard_params_tp`, tensor-parallel) run: every rank
starts from rank 0's parameters, feeds its rows of each global batch,
takes the data-parallel `train_step` and logs the data group's means;
only rank 0 writes metrics, tfevents, traces and checkpoints, and a
tensor-parallel checkpoint is gathered whole first, so every rank calls
`save` and `validate` alike.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..parallel import tp
from ..parallel.mesh import Mesh, shard_batch, shard_params
from ..utils.device import batch_to_device
from ..utils.weights import MSGPACK, deepfnet_state_from_msgpack, to_cpu, to_reference_layout
from .config import Config, qt_clamps
from .engine import eval_step, make_optimizer, train_step

TRACE_FILE = "trace.json"


def save_checkpoint(path: str, net: torch.nn.Module, opt: Optional[torch.optim.Optimizer],
                    n_iter: int, n_iter_val: int = 0, loss: float = 0.0) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({
        "n_iter": int(n_iter),
        "n_iter_val": int(n_iter_val),
        "model_state_dict": to_reference_layout(net.state_dict()),
        "optimizer_state_dict": to_cpu(opt.state_dict()) if opt is not None else {},
        "loss": float(loss),
    }, path)


def load_checkpoint(path: str, net: torch.nn.Module,
                    opt: Optional[torch.optim.Optimizer] = None) -> int:
    """Load a reference-schema checkpoint into `net` (and its Adam state
    into `opt`, where the file has one), or the JAX package's flax
    `.msgpack` (parameters only); returns its n_iter. A tree that does not
    match the net fails `load_state_dict(strict=True)`."""
    if str(path).endswith(MSGPACK):
        sd, n_iter = deepfnet_state_from_msgpack(path)
        net.load_state_dict(sd, strict=True)
        return n_iter
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(ckpt["model_state_dict"], strict=True)
    if opt is not None and ckpt.get("optimizer_state_dict"):
        opt.load_state_dict(ckpt["optimizer_state_dict"])
    return int(ckpt.get("n_iter", 0))


def scalars(metrics: Dict) -> Dict[str, float]:
    """The 0-d entries of `metrics` as floats, in one device-to-host copy."""
    keys = [k for k, v in metrics.items() if np.ndim(v) == 0]
    tensors = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(metrics[k]) for k in keys if k not in tensors}
    if tensors:
        vals = torch.stack([metrics[k].double() for k in tensors]).cpu().tolist()
        out.update(zip(tensors, vals))
    return {k: out[k] for k in keys}


def start_profile(device: torch.device):
    """A started `torch.profiler` capture: the CPU, and the card's kernels
    when `device` is a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, device: torch.device, out_dir: str) -> None:
    """End the capture after the device's work and write `out_dir/trace.json`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


class MetricLogger:
    """Dual metric sink: JSONL plus first-party tfevents scalars (the
    reference's tensorboardX workflow)."""

    def __init__(self, path: Optional[str] = None, echo_every: int = 50,
                 tb_dir: Optional[str] = None):
        self.path = path
        self.echo_every = echo_every
        self._f = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._f = open(path, "a")
        if tb_dir:
            from ..utils.tb_writer import TBWriter

            self._tb = TBWriter(tb_dir)

    def log(self, n_iter: int, tag: str, metrics: Dict) -> None:
        vals = scalars(metrics)
        if self._f:
            self._f.write(json.dumps({"iter": n_iter, "tag": tag, **vals}) + "\n")
            self._f.flush()
        if self._tb:
            for k, v in vals.items():
                self._tb.add_scalar(f"{tag}/{k}", v, n_iter)
        if n_iter % self.echo_every == 0:
            print(f"[{tag}] iter={n_iter} {({k: round(v, 6) for k, v in vals.items()})}",
                  flush=True)

    def log_histogram(self, n_iter: int, tag: str, values) -> None:
        if self._tb:
            self._tb.add_histogram(tag, values, n_iter)

    def log_image(self, n_iter: int, tag: str, img) -> None:
        if self._tb:
            self._tb.add_image(tag, img, n_iter)

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()


class Trainer:
    """One-device trainer for the DeepFNet solver; `net` already lies on
    the device its batches are sent to.

    The sample loss's subsets are drawn, step after step, from one
    generator on that device seeded SAMPLE_SEED (the JAX Trainer's
    'sample' stream seed, its rng_seed 0 + 1); validations draw from
    DeepFNet's seed-0 generator, as the JAX package's use PRNGKey(0). A
    torch.Generator and jax.random give different draws from one seed.
    With `mesh` the batches are global host batches (module docstring)."""

    SAMPLE_SEED = 1

    def __init__(self, net: torch.nn.Module, cfg: Config, save_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.net = net
        self.cfg = cfg
        self.save_dir = save_dir
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self.device = next(net.parameters()).device
        if mesh is not None:
            shard_params(mesh, net)
            net.data_mesh = mesh
        self.sample_generator = torch.Generator(device=self.device).manual_seed(self.SAMPLE_SEED)
        self.opt = make_optimizer(net, cfg)
        self.n_iter = 0
        self.n_iter_val = 0
        log_dir = save_dir if self.writes else None
        tb = log_dir and cfg.training.tensorboard
        self.logger = MetricLogger(os.path.join(log_dir, "metrics.jsonl") if log_dir else None,
                                   tb_dir=os.path.join(log_dir, "runs") if tb else None)
        self._best_val = float("inf")
        self._vit_accum: Dict[str, float] = {}
        self._vit_count: Optional[int] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, train_stream: Iterable[Dict],
            val_stream_fn: Optional[Callable[[], Iterable[Dict]]] = None,
            max_iters: Optional[int] = None) -> Dict[str, float]:
        cfg, t = self.cfg, self.cfg.training
        max_iters = max_iters or t.train_iter
        t0 = time.perf_counter()
        last: Dict = {}
        prof = None
        want_profile = bool(t.profile_dir) and self.writes
        for batch in train_stream:
            n_iter = self.n_iter
            if n_iter >= max_iters:
                break
            if want_profile and n_iter == t.profile_start:
                prof = start_profile(self.device)
            if prof is not None and n_iter == t.profile_start + t.profile_steps:
                stop_profile(prof, self.device, t.profile_dir)
                prof, want_profile = None, False  # one capture per fit
            tb = self._to_device(batch)
            metrics = train_step(self.net, self.opt, tb, cfg, *qt_clamps(t, n_iter),
                                 self.sample_generator, self.mesh)
            self.n_iter += 1
            self._log(n_iter, "train", metrics)
            last = metrics

            # Val-in-train telemetry (Train_model_pipeline.py:197-233): every
            # val_interval_in_train steps, the eval metrics over the next
            # val_batches training batches, logged under 'training'.
            vit = t.val_interval_in_train
            if vit > 0:
                if n_iter != 0 and n_iter % vit == 0:
                    self._vit_accum, self._vit_count = {}, 0
                if self._vit_count is not None:
                    for k, v in scalars(eval_step(self.net, tb, cfg, self.mesh)).items():
                        self._vit_accum[k] = self._vit_accum.get(k, 0.0) + v
                    self._vit_count += 1
                    if self._vit_count > t.val_batches:
                        self._log(n_iter, "training", {
                            k: v / self._vit_count for k, v in self._vit_accum.items()})
                        self._vit_count = None

            if val_stream_fn is not None and t.val_interval > 0 \
                    and (n_iter + 1) % t.val_interval == 0:
                self.validate(val_stream_fn())
            if self.save_dir and t.save_interval > 0 and (n_iter + 1) % t.save_interval == 0:
                self.save(n_iter + 1)
        if prof is not None:  # the run ended inside the capture window
            stop_profile(prof, self.device, t.profile_dir)
        out = scalars(last)
        self._sync()
        out["wall_s"] = time.perf_counter() - t0
        return out

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch on the device: this rank's rows of it under a mesh."""
        if self.mesh is None:
            return batch_to_device(batch, self.device)
        return shard_batch(self.mesh, batch)

    def _log(self, n_iter: int, tag: str, metrics: Dict) -> None:
        if self.writes:
            self.logger.log(n_iter, tag, metrics)

    def validate(self, val_stream: Iterable[Dict]) -> Dict[str, float]:
        accum: Dict[str, float] = {}
        count, first = 0, None
        limit = self.cfg.training.val_batches
        for i, batch in enumerate(val_stream):
            if limit >= 0 and i >= limit:
                break
            tb = self._to_device(batch)
            first = first if first is not None else tb
            for k, v in scalars(eval_step(self.net, tb, self.cfg, self.mesh)).items():
                accum[k] = accum.get(k, 0.0) + v
            count += 1
        self.n_iter_val += count
        means = {k: v / max(count, 1) for k, v in accum.items()}
        self._log(self.n_iter, "val", means)
        vsi = self.cfg.training.val_show_interval
        show = vsi <= 0 or (self.n_iter % vsi) < max(self.cfg.training.val_interval, 1)
        # Every rank runs the inspection's forward (its collectives); rank 0 logs it.
        if self.save_dir and self.cfg.training.tensorboard and first is not None and show:
            self._log_val_inspection(first)
        key = "loss" if "loss" in means else "loss_F"
        if self.save_dir and means.get(key) is not None and means[key] < self._best_val:
            self._best_val = means[key]
            self._write(os.path.join(self.save_dir, "checkpoints",
                                     "deepFNet_best_checkpoint.pth.tar"), self.n_iter, means[key])
        return means

    @torch.no_grad()
    def _log_val_inspection(self, batch: Dict[str, torch.Tensor]) -> None:
        """Weight and residual histograms and a per-item weight strip for one
        val batch (Train_model_pipeline.py:772-815, 998-1035)."""
        self.net.eval()
        outs = self.net(batch)
        n = self.n_iter
        w = outs["weights"].float().cpu().numpy()
        self.logger.log_histogram(n, "val/weights", w)
        self.logger.log_histogram(n, "val/epi_res", outs["epi_res_layers"][-1].float().cpu().numpy())
        self.logger.log_histogram(n, "val/residual",
                                  outs["residual_layers"][-1].float().cpu().numpy())
        strip = np.sort(w.reshape(w.shape[0], -1), axis=1)[:, ::-1]
        strip = strip / (strip.max(axis=1, keepdims=True) + 1e-12)
        self.logger.log_image(n, "val/weights_strip", strip.astype(np.float32))

    def _write(self, path: str, n_iter: int, loss: float = 0.0) -> None:
        """The checkpoint, from rank 0 (gathered whole under tensor
        parallelism, which takes every rank)."""
        if self.mesh is not None and tp.sharded_names(self.net):
            net = _Whole(tp.full_state_dict(self.mesh, self.net))
            opt = _Whole(tp.full_optimizer_state(self.mesh, self.net, self.opt))
        else:
            net, opt = self.net, self.opt
        if self.writes:
            save_checkpoint(path, net, opt, n_iter, self.n_iter_val, loss)

    def save(self, n_iter: int) -> str:
        path = os.path.join(self.save_dir, "checkpoints", f"deepFNet_{n_iter}_checkpoint.pth.tar")
        self._write(path, n_iter)
        return path

    def restore(self, path: str) -> int:
        """Parameters, Adam state and n_iter from a checkpoint (into the
        whole net: before `parallel.shard_params_tp`, which slices both)."""
        if tp.sharded_names(self.net):
            raise ValueError("restore into the whole net, then shard it (shard_params_tp)")
        self.n_iter = load_checkpoint(path, self.net, self.opt)
        return self.n_iter


class _Whole:
    """A gathered state dict where `save_checkpoint` takes a net or an Adam."""

    def __init__(self, state: Dict):
        self._state = state

    def state_dict(self) -> Dict:
        return self._state
