"""Ablation-matrix eval driver: one process of the port's CLI a cell.

Counterpart of `deepfepe_tpu/run_eval.py` (the reference's
run_eval_good.py :35-386): a base eval config rewritten per cell by the
cell's overrides, each cell's `eval_good` run in a fresh process (the
port's CLI, with the cell's `pretrained`), its JSON line collected into
<out>/ablation_results.json.

    python -m deepfepe_tpu_torch.run_eval --config configs/synthetic_baseline.yaml \\
        --ablation ablations.yaml --out logs/ablation [--device cpu]

Ablation YAML: {name: {pretrained: ..., overrides: {model: {...}, ...}}}. The
cells write logs/<out's last part>/<name>/ under the current directory,
as the CLI does, so give `--out logs/<name>` from there.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[1])


def update_config(base: dict, overrides: dict) -> dict:
    """`base` with `overrides` merged in, dict by dict."""
    out = copy.deepcopy(base)

    def merge(d, u):
        for k, v in u.items():
            if isinstance(v, dict) and isinstance(d.get(k), dict):
                merge(d[k], v)
            else:
                d[k] = v

    merge(out, overrides)
    return out


def check_exist(entries: dict, out_dir: str) -> dict:
    """Whether each cell's checkpoint and results exist."""
    return {name: {"checkpoint": (not spec.get("pretrained"))
                   or os.path.isfile(spec["pretrained"]),
                   "results": os.path.isfile(os.path.join(out_dir, name, "DeepF_err_ratio.npz"))}
            for name, spec in entries.items()}


def run_ablations(base_config_path: str, ablation_path: str, out_dir: str,
                  max_batches: int = 0, dry_run: bool = False, device: str | None = None) -> dict:
    """Each cell's config written to <out_dir>/temp_config_<name>.yaml and
    evaluated by `eval_good` in its own process; returns {name: its JSON
    line, or {'cmd'} with `dry_run`, or {'error'}}."""
    import yaml

    with open(base_config_path) as f:
        base = yaml.safe_load(f)
    with open(ablation_path) as f:
        entries = yaml.safe_load(f)
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)}
    results = {}
    for name, spec in entries.items():
        spec = spec or {}
        tmp_cfg = Path(out_dir) / f"temp_config_{name}.yaml"
        with open(tmp_cfg, "w") as f:
            yaml.safe_dump(update_config(base, spec.get("overrides", {})), f)
        cmd = [sys.executable, "-m", "deepfepe_tpu_torch.cli", "eval_good", str(tmp_cfg),
               f"{Path(out_dir).name}/{name}"]
        if spec.get("pretrained"):
            cmd += ["--pretrained", spec["pretrained"]]
        if max_batches:
            cmd += ["--max_batches", str(max_batches)]
        if device:
            cmd += ["--device", device]
        print("+", " ".join(cmd), flush=True)
        if dry_run:
            results[name] = {"cmd": cmd}
            continue
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
        last = [ln for ln in proc.stdout.strip().splitlines() if ln.startswith("{")]
        try:
            results[name] = json.loads(last[-1]) if last else {"error": proc.stderr[-500:]}
        except json.JSONDecodeError:
            results[name] = {"error": proc.stderr[-500:]}
        print(name, "->", results[name], flush=True)
    with open(Path(out_dir) / "ablation_results.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser("deepfepe_tpu_torch.run_eval")
    p.add_argument("--config", required=True)
    p.add_argument("--ablation", required=True)
    p.add_argument("--out", default="logs/ablation")
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--device", choices=("cpu", "cuda"), default=None)
    p.add_argument("--check_exist", action="store_true")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.check_exist:
        import yaml

        with open(args.ablation) as f:
            print(json.dumps(check_exist(yaml.safe_load(f), args.out), indent=2))
        return None
    return run_ablations(args.config, args.ablation, args.out, args.max_batches, args.dry_run,
                         args.device)


if __name__ == "__main__":
    main()
