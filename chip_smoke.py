#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout around this file; exits
non-zero without them. Phases, each printed as one JSON line with its
seconds:

  device   the card's name and power limit (nvidia-smi);
  build    nvcc build of every kernel source of the slice's path;
  kernels  each kernel against its plain PyTorch version on the card at
           the main path's shapes, with its bars, and timed beside the
           plain version, one PyTorch library call and its bound;
  eval_good  the port's `eval_good` entry point at the full width of
           configs/synthetic_baseline.yaml (B=8, N=1000, depth 5, bf16
           MLP, 512 RANSAC hypotheses), 5 batches, seeded weights, with
           every kernel's launch count read around that run alone;
  breakdown  the same path again, each eigh solve timed by solver and
           shape, with its share of a batch;
  check    the card's results against the CPU path on a small input.

The line before the card's name line is the kernels' JSON summary; the
last line is {"ok": true, "device": {...}}. Any failed check exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The synthetic_baseline.yaml values, built in code (no YAML reader needed).
BASELINE = {
    "name": "synthetic_good_corr",
    "data": {"dataset": "synthetic", "batch_size": 8, "good_num": 1000,
             "noise_px": 0.5, "outlier_frac": 0.15,
             "image": {"size": [376, 1241, 3]},
             "preprocessing": {"resize": [376, 1241]}},
    "model": {"depth": 5, "clamp_at": 0.02, "if_quality": True, "quality_size": 1,
              "if_learn_offsets": False, "if_tri_depth": False, "if_qt_loss": False,
              "if_sample_loss": False, "if_SP": False},
    "exps": {"five_point": False, "base_name": "ransac_8p"},
    "training": {"seed": 0},
}
EVAL_BATCHES = 5
# Per eval_good batch: depth (5) weighted 8-point fits in DeepFNet, one
# batched RANSAC hypothesis fan-out and one RANSAC refit.
EIGH9_PER_BATCH = 5 + 1 + 1
BREAKDOWN_BATCHES = 2


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


class Phases:
    def __init__(self):
        self.t = time.perf_counter()

    def emit(self, phase: str, **fields) -> None:
        now = time.perf_counter()
        print(json.dumps({"phase": phase, "seconds": round(now - self.t, 3), **fields}),
              flush=True)
        self.t = now


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gram_batch(B: int, rows: int, gen):
    """Gram matrices of random constraint rows, as the path forms them:
    rows = 8 for RANSAC minimal fits, 1000 for the DeepFNet solves."""
    import torch

    X = torch.randn(B, rows, 9, generator=gen)
    X = X / X.norm(dim=-1, keepdim=True)
    return (X.transpose(-1, -2) @ X).cuda()


def eigh_errors(A, w, V, w_ref, V_ref):
    """Kernel (w, V) against the plain version (w_ref, V_ref) and against
    float64 eigenvalues, with the kernel's own residual and orthogonality.
    Errors are relative to ||A||_2, the largest |eigenvalue| (Weyl's bound
    on an eigenvalue's change is ||dA||_2)."""
    import torch

    w64 = torch.linalg.eigvalsh(A.double())
    scale = w64.abs().amax(-1).clamp_min(1e-30)  # ||A||_2, [B]
    dw = ((w - w_ref).abs().amax(-1) / scale).max().item()
    dw64 = ((w.double() - w64).abs().amax(-1) / scale).max().item()
    dw64_plain = ((w_ref.double() - w64).abs().amax(-1) / scale).max().item()
    # Eigenvector comparison only where the eigenvalue is separated by
    # 1e-2 ||A||_2 from the others; near-repeated eigenvalues leave the
    # vectors free within their subspace, and the residuals cover them.
    gaps = (w_ref[..., :, None] - w_ref[..., None, :]).abs()
    gaps = gaps + torch.eye(9, device=A.device) * 1e30
    sep = gaps.amin(-1) / scale[:, None].float() >= 1e-2  # [B, 9]
    dv_cols = (V.abs() - V_ref.abs()).abs().amax(-2)  # [B, 9]
    dV = dv_cols[sep].max().item() if sep.any() else 0.0
    resid = ((A @ V - V * w[:, None, :]).norm(dim=(-1, -2)) / scale.float()).max().item()
    eye = torch.eye(9, device=A.device)
    ortho = (V.transpose(-1, -2) @ V - eye).abs().amax().item()
    return {"dw_rel": dw, "dw_rel_vs_f64": dw64, "dw_rel_plain_vs_f64": dw64_plain,
            "dV_separated": dV, "separated_share": sep.float().mean().item(),
            "residual_rel": resid, "orthogonality": ortho}


EIGH9_BARS = {"dw_rel": 1e-5, "dw_rel_vs_f64": 1e-5, "dV_separated": 1e-4,
              "residual_rel": 1e-5, "orthogonality": 1e-5}


def eigh9_bound_ms(B: int) -> tuple[float, str]:
    """Least time for B matrices: 7 sweeps x 36 rotations x 180 flops each
    over the FP32 rate, against 81 floats read and 90 written over HBM."""
    flops = B * 7 * 36 * 180
    nbytes = B * (81 + 9 + 81) * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(ph: Phases) -> dict:
    import torch

    from deepfepe_tpu_torch.ops import eigh9 as eigh9_mod
    from deepfepe_tpu_torch.ops.jacobi import jacobi_eigh

    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for B, rows in ((1, 1000), (8, 1000), (4096, 8), (4097, 8)):
        A = gram_batch(B, rows, gen)
        w, V = eigh9_mod.eigh9(A)
        w_ref, V_ref = jacobi_eigh(A)
        torch.cuda.synchronize()
        errs = eigh_errors(A, w, V, w_ref, V_ref)
        ok = all(errs[k] <= bar for k, bar in EIGH9_BARS.items())
        ph.emit("kernels", kernel="eigh9", B=B, rows=rows, errors=errs, bars=EIGH9_BARS,
                within_bars=ok)
        check(ok, f"eigh9 at B={B} is outside its bars: {errs}")
        check(bool(torch.isfinite(w).all() and torch.isfinite(V).all()),
              f"eigh9 at B={B} gave non-finite values")
        max_err = max(max_err, errs["dw_rel"], errs["dV_separated"])

    timings = {}
    for B, rows in ((8, 1000), (4096, 8)):
        A = gram_batch(B, rows, gen)
        A_sym = ((A + A.transpose(-1, -2)) * 0.5).contiguous()
        bound, bound_by = eigh9_bound_ms(B)
        timings[B] = {
            "kernel_ms": cuda_time_ms(lambda: eigh9_mod.launch(A_sym), 200),
            "wrapper_ms": cuda_time_ms(lambda: eigh9_mod.eigh9(A), 100),
            "plain_ms": cuda_time_ms(lambda: jacobi_eigh(A), 3, warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.linalg.eigh(A), 20),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        ph.emit("kernels", kernel="eigh9", timing_B=B, **timings[B])
    t = timings[4096]
    return {"name": "eigh9", "route": "cuda", "source": "deepfepe_tpu_torch/csrc/eigh9.cu",
            "replaces": "deepfepe_tpu/ops/pallas/eigh9_pallas.py:34",
            "launches": None, "max_abs_err": max_err, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": "[4096, 9, 9] f32",
            "wrapper_ms": t["wrapper_ms"], "wrapper_ms_B8": timings[8]["wrapper_ms"],
            "ms_B8": timings[8]["kernel_ms"], "plain_ms_B8": timings[8]["plain_ms"],
            "library_ms_B8": timings[8]["library_ms"], "bound_ms_B8": timings[8]["bound_ms"]}


def phase_eval_good(ph: Phases, cfg) -> dict:
    import numpy as np
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.ops.eigh9 import eigh9

    eigh9.launches = 0
    summary = cli.eval_good(cfg, EVAL_BATCHES, device="cuda")
    torch.cuda.synchronize()
    launches = {"eigh9": eigh9.launches}
    expected = EIGH9_PER_BATCH * EVAL_BATCHES
    ph.emit("eval_good", summary=summary, eigh9_launches=launches["eigh9"],
            eigh9_expected=expected, pairs_per_s=summary["pairs"] / summary["seconds"])
    check(launches["eigh9"] == expected,
          f"eigh9 launched {launches['eigh9']} times on the path, expected {expected}")
    check(summary["pairs"] == EVAL_BATCHES * cfg.data.batch_size, "wrong number of pairs")
    check(all(np.isfinite(v) for v in summary.values() if isinstance(v, float)),
          f"non-finite summary: {summary}")
    check(summary["median_err_q_gt"] < 1e-3,
          f"median_err_q_gt {summary['median_err_q_gt']} >= 1e-3 deg")
    check(summary["median_err_q_base"] < 0.5,
          f"median_err_q_base {summary['median_err_q_base']} >= 0.5 deg")
    return launches


def phase_breakdown(ph: Phases, cfg) -> None:
    """Where an eval_good batch spends its time: the path once more, each
    eigh solve wrapped in synchronizes and timed on the host clock, by
    solver and shape. Runs after the main path's counts were read."""
    import torch

    from deepfepe_tpu_torch import cli
    from deepfepe_tpu_torch.ops import eigh as eigh_mod

    spent = {}

    def timed(label, fn):
        def run(A, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(A, *args)
            torch.cuda.synchronize()
            key = f"{label} {list(A.shape)}"
            calls, s = spent.get(key, (0, 0.0))
            spent[key] = (calls + 1, s + time.perf_counter() - t)
            return out
        return run

    saved = eigh_mod.jacobi_eigh, eigh_mod.eigh9
    eigh_mod.jacobi_eigh = timed("jacobi_eigh", saved[0])
    eigh_mod.eigh9 = timed("eigh9", saved[1])
    try:
        summary = cli.eval_good(cfg, BREAKDOWN_BATCHES, device="cuda")
    finally:
        eigh_mod.jacobi_eigh, eigh_mod.eigh9 = saved
    batch_ms = summary["seconds"] * 1e3 / BREAKDOWN_BATCHES
    solves = {k: {"calls_per_batch": c / BREAKDOWN_BATCHES, "ms_per_call": s * 1e3 / c,
                  "share_of_batch": s * 1e3 / BREAKDOWN_BATCHES / batch_ms}
              for k, (c, s) in sorted(spent.items())}
    ph.emit("breakdown", batch_ms=batch_ms, solves=solves,
            share_all_solves=sum(v["share_of_batch"] for v in solves.values()))


def phase_check(ph: Phases, cfg) -> None:
    """The same small batch, weights and hypotheses through the CPU path
    (plain versions) and the card (kernels), both in float32."""
    import dataclasses

    import numpy as np
    import torch

    from deepfepe_tpu_torch.cli import batch_to_device, evaluate
    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.eval import draw_hypotheses
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train import eval_step

    small = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mlp_dtype="float32"))
    n = 200
    batch = SyntheticPairs(image_size=(376, 1241), good_num=n, seed=7).batch(2)
    idxs = [draw_hypotheses(2, n, 512, torch.Generator().manual_seed(1))]
    res, F = {}, {}
    for dev in ("cpu", "cuda"):
        net = model_loader(small, torch.device(dev), torch.Generator().manual_seed(3))
        F_est = eval_step(net, batch_to_device(batch, torch.device(dev)), small)["F_ests"]
        F_est = F_est.double().cpu().numpy()
        F[dev] = np.abs(F_est / np.linalg.norm(F_est, axis=(-1, -2), keepdims=True))
        res[dev] = evaluate(small, net, [batch], torch.device(dev), ransac_idxs=idxs)
    diffs = {k: float(np.abs(res["cpu"][k] - res["cuda"][k]).max())
             for k in ("err_q_est", "err_t_est", "err_q_gt")}
    dF = float(np.abs(F["cpu"] - F["cuda"]).max())
    d_inl = int(np.abs(res["cpu"]["base_inliers"] - res["cuda"]["base_inliers"]).max())
    # Bars: the solver's F to 1e-3 (f32 sums in another order, fed through
    # 5 layers); pose angles to 0.05 deg (acos near 0 has a float32 floor
    # of about 0.03 deg); the RANSAC baseline only by its inlier count,
    # within 5% of N, since an 8-point minimal fit in float32 is
    # ill-conditioned and another rounding can pick another hypothesis.
    bars = {"F_unit": 1e-3, "angle_deg": 0.05, "inliers": 0.05 * n}
    ph.emit("check", max_abs_diff_cpu_vs_cuda={"F_unit": dF, **diffs,
                                               "base_inliers": d_inl}, bars=bars)
    check(dF <= bars["F_unit"], f"F_est: card and CPU differ by {dF}")
    check(all(d <= bars["angle_deg"] for d in diffs.values()), f"card and CPU disagree: {diffs}")
    check(d_inl <= bars["inliers"], f"RANSAC inlier counts differ by {d_inl}")


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    from deepfepe_tpu_torch.train.config import config_from_dict
    from deepfepe_tpu_torch.utils import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # Full-precision f32 matmuls on the card, as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ph = Phases()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    ph.emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
            name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    path, log = build.build("eigh9.cu")
    ph.emit("build", source="eigh9.cu", library=os.path.relpath(path, REPO),
            nvcc=log.strip().splitlines()[-4:])

    try:
        row = phase_kernels(ph)
        cfg = config_from_dict(BASELINE)
        launches = phase_eval_good(ph, cfg)
        row["launches"] = launches["eigh9"]
        check(row["launches"] > 0, "eigh9 never launched on the main path")
        phase_breakdown(ph, cfg)
        phase_check(ph, cfg)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": [row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
