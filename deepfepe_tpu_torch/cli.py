"""Command-line entry point of the port.

    python -m deepfepe_tpu_torch.cli eval_good <config.yaml> <exper_name>
        [--max_batches k] [--device cpu|cuda]

`eval_good` runs the solver on the config's test stream, scores each pair
against the ground truth and the 8-point RANSAC baseline, and prints the
JAX package's summary keys as one JSON line. The device defaults to the
card; without one it raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from .eval import val_rt_batch
from .loader import data_loader, model_loader
from .train import eval_step, load_config
from .train.config import Config
from .utils.device import resolve_device

PER_PAIR = ("err_q_est", "err_t_est", "err_q_base", "err_t_base", "err_q_gt",
            "err_t_gt", "base_inliers")


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def evaluate(cfg: Config, net, batch_iter: Iterable[Dict[str, np.ndarray]],
             device: torch.device, generator: torch.Generator | None = None,
             ransac_idxs: Sequence[torch.Tensor] | None = None) -> Dict[str, np.ndarray]:
    """Per-pair errors over `batch_iter`; the RANSAC hypotheses of batch i
    are `ransac_idxs[i]` when given, else drawn from `generator`."""
    per_pair = {k: [] for k in PER_PAIR}
    losses = []
    for i, batch in enumerate(batch_iter):
        tb = batch_to_device(batch, device)
        metrics = eval_step(net, tb, cfg)
        with torch.no_grad():
            rt = val_rt_batch(
                metrics["E_ests"], tb["Ks"], tb["matches_xy_ori"], tb["E_gts"],
                tb["delta_Rtijs_4_4"],
                ransac_idxs=None if ransac_idxs is None else ransac_idxs[i],
                generator=generator, five_point=cfg.exps.five_point)
        for k in PER_PAIR:
            per_pair[k].append(rt[k].cpu().numpy())
        losses.append(float(metrics["loss_F"]))
    out = {k: np.concatenate(v) for k, v in per_pair.items()}
    out["loss_F"] = np.asarray(losses)
    return out


def summarize(res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The JAX `cmd_eval` summary keys, plus the mean F-loss."""
    return {
        "median_err_q": float(np.median(res["err_q_est"])),
        "median_err_t": float(np.median(res["err_t_est"])),
        "median_err_q_base": float(np.median(res["err_q_base"])),
        "median_err_t_base": float(np.median(res["err_t_base"])),
        "median_err_q_gt": float(np.median(res["err_q_gt"])),
        "pairs": int(len(res["err_q_est"])),
        "loss_F": float(np.mean(res["loss_F"])),
    }


def eval_good(cfg: Config, max_batches: int, device=None) -> Dict[str, float]:
    """Weights seeded from `cfg.training.seed`, the config's test stream,
    `max_batches` batches."""
    device = resolve_device(device)
    seed = cfg.training.seed
    net = model_loader(cfg, device, torch.Generator().manual_seed(seed))
    ds = data_loader(cfg, "test")
    bs = cfg.data.batch_size
    # The JAX CLI draws one batch to initialize its parameters before it
    # evaluates; drawing it here too keeps both CLIs on the same pairs.
    ds.batch(bs)
    # Data is made up front (host set-up), so `seconds` times the solver
    # and its evaluation alone.
    data = list(ds.epoch(bs, max_batches))
    t0 = time.perf_counter()
    res = evaluate(cfg, net, data, device, generator=torch.Generator().manual_seed(seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary = summarize(res)
    summary["seconds"] = time.perf_counter() - t0
    summary["device"] = str(device)
    return summary


def cmd_eval(args) -> Dict[str, float]:
    cfg = load_config(args.config)
    summary = eval_good(cfg, args.max_batches, args.device)
    summary["exper_name"] = args.exper_name
    print(json.dumps(summary))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deepfepe_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("eval_good", help="solver eval against gt and RANSAC")
    p.add_argument("config")
    p.add_argument("exper_name")
    p.add_argument("--max_batches", type=int, default=5)
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.set_defaults(fn=cmd_eval)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
