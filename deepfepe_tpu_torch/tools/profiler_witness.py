"""Whether torch.profiler still sees the card's work after K3's caller
readings (`tools/profile_epi.py`, profiled in this process) and
chip_smoke.py's sample-loss check have run: one eigh9 call is traced at
the start, after the readings and after the check (chip_smoke.py
`device_ops`, up to three traces), and so is one PyTorch matrix product
(a kernel of PyTorch's own CUDA runtime, where eigh9's comes from the
runtime linked into its library); each probe prints one JSON line with
the device operations each saw.

    python -m deepfepe_tpu_torch.tools.profiler_witness TAG [VARIANT]
        [--cudart static|shared] [--no-callers] [--no-check] [--warm]
        [--sessions N] [--check-part PART]

Run from a checkout's root: it imports that checkout's chip_smoke.py and
package, so the file and tools/profile_epi.py copy into an older checkout
to witness its K3. VARIANT binds a build of tools/epi_variants.py (this
checkout's kernel source with lines changed) in place of the K3 library.
`--cudart shared` builds every kernel library against the shared CUDA
runtime (nvcc's default links a static copy into each); `--no-callers` and
`--no-check` leave out the readings or the check; `--warm` runs one
backward on the card before any trace, so that autograd's device thread
starts outside a profiler session; `--sessions N` opens N more profiler
sessions, each over one eigh9 call and one PyTorch product (no K3), before
the check; `--check-part` runs one part of the check in its place: `card`
(the sample-loss step on the card, its choices recorded), `cpu` (its
float32 and float64 replays on the CPU), `card_plain` (the card step
without the recording patches), `card_fit` (a plain F-loss step on the
card). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("variant", nargs="?")
    ap.add_argument("--cudart", choices=("static", "shared"), default="static")
    ap.add_argument("--no-callers", dest="callers", action="store_false")
    ap.add_argument("--no-check", dest="check", action="store_false")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--sessions", type=int, default=0)
    ap.add_argument("--check-part", dest="part", default="all",
                    choices=("all", "card", "cpu", "card_plain", "card_fit"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_witness: no CUDA device", file=sys.stderr)
        return 2
    tag, variant = args.tag, args.variant
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from deepfepe_tpu_torch.ops import eigh9
    from deepfepe_tpu_torch.ops import epi_residual as epi
    from deepfepe_tpu_torch.tools import profile_epi
    from deepfepe_tpu_torch.utils import build

    if args.cudart == "shared":
        build.NVCC_FLAGS = [*build.NVCC_FLAGS, "-cudart", "shared"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cs.Phases()
    cs.build_all(ph)
    if variant:
        from deepfepe_tpu_torch.tools import epi_variants

        epi._lib = epi_variants.build_variants([variant], Path("build/witness"))[variant]
    A = torch.randn(8, 9, 9, device="cuda")
    A = A @ A.transpose(1, 2)
    if args.warm:
        x = torch.ones(4, device="cuda", requires_grad=True)
        (x * 2).sum().backward()
        torch.cuda.synchronize()

    def probe(where):
        ops, traces = cs.device_ops(lambda: eigh9.eigh9(A))
        torch_ops, torch_traces = cs.device_ops(lambda: A @ A)
        print(json.dumps({"witness": tag, "cudart": args.cudart, "warm": args.warm,
                          "probe": where, "ops": ops,
                          "traces": traces, "torch_ops": torch_ops,
                          "torch_traces": torch_traces}), flush=True)

    probe("start")
    if args.callers:
        for case in profile_epi.CASES:
            for row in profile_epi.measure(*case, 100):
                print(json.dumps({"witness": tag, "case": row["case"],
                                  "direction": row["direction"], "kernel_ms": row["kernel_ms"],
                                  "one_call": row["one_call"]}), flush=True)
        probe("after callers")
    if args.sessions:
        for _ in range(args.sessions):
            cs.device_ops(lambda: (eigh9.eigh9(A), A @ A))
        probe("after sessions")
    if args.check:
        try:
            check_part(cs, ph, args.part)
        except cs.CheckFailed as e:
            print(json.dumps({"witness": tag, "check_sample_failed": str(e)[:300]}), flush=True)
        probe(f"after check_sample ({args.part})")
    return 0


def check_part(cs, ph, part: str) -> None:
    """chip_smoke.py's check_sample, or one part of it."""
    import torch

    from deepfepe_tpu_torch.data import SyntheticPairs
    from deepfepe_tpu_torch.loader import model_loader
    from deepfepe_tpu_torch.train.config import config_from_dict

    if part == "all":
        cs.phase_check_sample(ph)
        return
    batch = SyntheticPairs(image_size=(376, 1241), good_num=200, seed=7).batch(2)
    sample = {**cs.SAMPLE, "data": {**cs.SAMPLE["data"], "batch_size": 2, "good_num": 200},
              "model": {**cs.SAMPLE["model"], "mlp_dtype": "float32"}}
    if part == "card_fit":
        sample["model"] = {**sample["model"], "if_sample_loss": False}
    cfg = config_from_dict(sample)
    state = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(3)).state_dict()
    if part in ("card", "cpu"):
        card = cs.sample_step_report(cfg, "cuda" if part == "card" else "cpu", state, batch)
        if part == "cpu":
            cs.sample_step_report(cfg, "cpu", state, batch, True, card["idx"], card["branches"])
    else:
        cs.train_step_grads(cfg, "cuda", state, batch)
    torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main())
