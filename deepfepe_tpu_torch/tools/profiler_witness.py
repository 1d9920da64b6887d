"""Whether torch.profiler still sees the card's work after K3's caller
readings (`tools/profile_epi.py`, profiled in this process) and
chip_smoke.py's sample-loss check have run: one eigh9 call is traced at
the start, after the readings and after the check (chip_smoke.py
`device_ops`, up to three traces), and each probe prints one JSON line
with the device operations it saw.

    python -m deepfepe_tpu_torch.tools.profiler_witness TAG [VARIANT]

Run from a checkout's root: it imports that checkout's chip_smoke.py and
package, so the file and tools/profile_epi.py copy into an older checkout
to witness its K3. VARIANT binds a build of tools/epi_variants.py (this
checkout's kernel source with lines changed) in place of the K3 library.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("profiler_witness: no CUDA device", file=sys.stderr)
        return 2
    tag, variant = argv[0], (argv[1] if len(argv) > 1 else None)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from deepfepe_tpu_torch.ops import eigh9
    from deepfepe_tpu_torch.ops import epi_residual as epi
    from deepfepe_tpu_torch.tools import profile_epi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cs.Phases()
    cs.build_all(ph)
    if variant:
        from deepfepe_tpu_torch.tools import epi_variants

        epi._lib = epi_variants.build_variants([variant], Path("build/witness"))[variant]
    A = torch.randn(8, 9, 9, device="cuda")
    A = A @ A.transpose(1, 2)

    def probe(where):
        ops, traces = cs.device_ops(lambda: eigh9.eigh9(A))
        print(json.dumps({"witness": tag, "probe": where, "ops": ops, "traces": traces}),
              flush=True)

    probe("start")
    for case in profile_epi.CASES:
        for row in profile_epi.measure(*case, 100):
            print(json.dumps({"witness": tag, "case": row["case"], "direction": row["direction"],
                              "kernel_ms": row["kernel_ms"], "one_call": row["one_call"]}),
                  flush=True)
    probe("after callers")
    try:
        cs.phase_check_sample(ph)
    except cs.CheckFailed as e:
        print(json.dumps({"witness": tag, "check_sample_failed": str(e)[:300]}), flush=True)
    probe("after check_sample")
    return 0


if __name__ == "__main__":
    sys.exit(main())
