"""Multi-process data-parallel training launcher.

Counterpart of `launch/train_multihost.py` (the JAX package's
`jax.distributed` entry point). Run it once per process:

    python -m deepfepe_tpu_torch.launch.train_multihost --config c.yaml \\
        --exper mh0 --backend nccl \\
        --coordinator host0:29500 --num_processes N --process_id K

or under torchrun, which sets the world in the environment (no
--coordinator). `--backend` is NCCL for one card a rank, gloo on the CPU
(`--device cpu`) or where ranks share a card. Every rank renders the
global batch from the shared seed (`training.seed`) and keeps its rows
(`parallel.shard_batch`), so the batches, and the whole trajectory, do
not depend on the number of processes; rank 0 writes metrics.jsonl,
tfevents and checkpoints under logs/<exper>/. `--pretrained` restores the
same file on every rank.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..cli import _snapshot_config, epochs
from ..data.prefetch import prefetch_batches
from ..loader import data_loader, model_loader
from ..parallel.mesh import BACKENDS, init_distributed, make_hybrid_mesh
from ..train import Trainer, load_config


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--exper", required=True)
    p.add_argument("--coordinator", default=None, help="host:port of rank 0 (else torchrun's "
                   "environment)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", choices=BACKENDS, default="nccl")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="cpu for a CPU run (with gloo); default: this rank's card")
    p.add_argument("--train_iter", type=int, default=None)
    p.add_argument("--pretrained", default="",
                   help="checkpoint to restore before training (every rank restores it)")
    args = p.parse_args(argv)

    rank, world = init_distributed(args.backend, args.coordinator, args.num_processes,
                                   args.process_id)
    trainer = None
    try:
        cfg = load_config(args.config)
        t = cfg.training
        if args.train_iter:
            t.train_iter = args.train_iter
        mesh = make_hybrid_mesh(device=args.device)
        if rank == 0:
            print(f"processes={world} backend={args.backend} device={mesh.device} "
                  f"mesh={mesh.shape}", flush=True)
            save_dir = _snapshot_config(cfg, args.exper)
        else:
            save_dir = os.path.join("logs", args.exper)
        net = model_loader(cfg, mesh.device, torch.Generator().manual_seed(t.seed), train=True)
        trainer = Trainer(net, cfg, save_dir=save_dir, mesh=mesh)
        train_ds, val_ds = data_loader(cfg, "train"), data_loader(cfg, "val")
        gbs = cfg.data.batch_size
        if args.pretrained:
            # One batch drawn to restore into, as the JAX launcher and the
            # CLI draw it: the runs then see the same pairs.
            next(iter(train_ds.batches(gbs)))
            trainer.restore(args.pretrained)
            if rank == 0:
                print(f"restored from {args.pretrained} @ iter {trainer.n_iter}", flush=True)
        last = trainer.fit(
            prefetch_batches(epochs(train_ds, gbs), depth=max(2, min(t.workers_train, 8))),
            val_stream_fn=lambda: val_ds.batches(gbs), max_iters=t.train_iter)
        trainer.save(trainer.n_iter)
        last["n_iter"] = trainer.n_iter
        if rank == 0:
            print("done: " + json.dumps(last), flush=True)
        return last
    finally:
        if trainer is not None:
            trainer.logger.close()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
