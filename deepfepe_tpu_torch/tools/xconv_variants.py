"""Where X1-X4's time goes: variants of `csrc/conv_formulations.cu`
with parts of `conv_wgmma_kernel` cut out or changed, timed on the card.

Without a hardware profiler's counters, the split comes from builds of
the kernel source with one line replaced at a time (VARIANTS),
each timed at the tool's full size (inc.conv1, [8, 376, 1240, 64] -> 64,
bf16) with CUDA events. The four formulations share the kernel, so each
variant applies to every kind (X3 and X4 included) unless it says:

  base          the source as it is
  no_mma        no wgmma (the A registers still read, so ldmatrix stays)
  no_store      the epilogue computes but stores nothing
  no_mma_store  neither
  halo_only     the consumers only wait for each halo (and X2's weight
                slices) and release it: the TMA streams alone
  halo_store    halo_only with the epilogue's stores of zeros
  half_w        X2 streams one of each weight slice's two boxes
  ring2         at most 2 halo stages (X1 and X4 keep 3-4)
  split_acc     X1 sums alternate k steps into two accumulators
  pipe1         one slice's products stay in flight (wait_group 1)
  two_slots     X3's im2col with two patch slots a warpgroup, as the
                other patch kinds: its block (132 KB) fits one an SM

Only `base` computes the function; the others are timings. Each variant
is built by its own nvcc, all started together, and the variants are
timed in turns, `--rounds` times.

    python -m deepfepe_tpu_torch.tools.xconv_variants
        [--variants base,no_mma,...] [--kinds dma-ky3_4_32,...] [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import conv_formulations as cf
from ..utils import build
from . import bench_conv_formulations as tool

_STORE = "          if (inside) *reinterpret_cast<uint4*>(dst + 64 * j + 8 * (4 * blk + t4)) = o;"
_NO_STORE = ("          if (inside && o.x == 0x7fc17fc1u) "
             "*reinterpret_cast<uint4*>(dst + 64 * j + 8 * (4 * blk + t4)) = o;")
_MMA_SS = "            wgmma_ss(acc[j], sdesc(pb + 32 * kk, 16, 1024), db);"
_MMA_RS = "            wgmma_rs(acc[j], a[s & 1][kk], db);"
_NO_MMA = [(_MMA_SS, "            (void)db;"),
           (_MMA_RS, "            acc[j][kk] += __uint_as_float(a[s & 1][kk][0] & 0x3f800000u);")]
_SLICES = "    prepare(0);\n#pragma unroll\n    for (int s = 0; s < NS; ++s) {"
_WAIT_ONLY = ("    if (CIN == 2 * C)\n      for (int s = 0; s < NS; ++s) {\n"
              "        const int ws = (u + s) % p.w_stages;\n"
              "        mbar_wait(&wfull[ws], ((u + s) / p.w_stages) & 1);\n"
              "        mbar_arrive(&wempty[ws]);\n      }\n"
              "#pragma unroll\n    for (int s = 0; s < 0; ++s) {")
_PIPE0 = """      if (s + 1 < NS && SLOTS == 2) prepare(s + 1);
      wg_wait<0>();
      if (s + 1 < NS && SLOTS == 1) prepare(s + 1);
      if (CIN == 2 * C) mbar_arrive(&wempty[(u + s) % p.w_stages]);  // slice s is done
"""
_PIPE1 = """      if (s + 1 < NS) {
        wg_wait<1>();
        if (CIN == 2 * C && s >= 1) mbar_arrive(&wempty[(u + s - 1) % p.w_stages]);
        prepare(s + 1);
      } else {
        wg_wait<0>();
        if (CIN == 2 * C) {
          if (s >= 1) mbar_arrive(&wempty[(u + s - 1) % p.w_stages]);
          mbar_arrive(&wempty[(u + s) % p.w_stages]);
        }
      }
"""
# Each variant: (line of the source, its replacement), each line once.
VARIANTS = {
    "base": [],
    "no_mma": _NO_MMA,
    "no_store": [(_STORE, _NO_STORE)],
    "no_mma_store": _NO_MMA + [(_STORE, _NO_STORE)],
    "halo_only": [(_SLICES, _WAIT_ONLY), (_STORE, _NO_STORE)],
    "halo_store": [(_SLICES, _WAIT_ONLY)],
    "half_w": [
        ("          mbar_expect(&wfull[ws], 2 * BOX);", "          mbar_expect(&wfull[ws], BOX);"),
        ("          tma_load(wsm + ws * 2 * BOX + BOX, &wmap, &wfull[ws], 64, krow);\n", ""),
        ("          const uint64_t db = sdesc(wb + j * BOX + 2048 * kk, BOX, 1024);",
         "          const uint64_t db = sdesc(wb + 2048 * kk, BOX, 1024);")],
    "ring2": [("constexpr int MAX_HALO_STAGES = 4;", "constexpr int MAX_HALO_STAGES = 2;")],
    "split_acc": [
        ("    float acc[NJ][32];\n#pragma unroll\n    for (int j = 0; j < NJ; ++j)",
         "    float acc[2][32];\n#pragma unroll\n    for (int j = 0; j < 2; ++j)"),
        (_MMA_SS, "            wgmma_ss(acc[NJ == 1 ? (kk & 1) : j], sdesc(pb + 32 * kk, 16, 1024), db);"),
        (_MMA_RS, "            wgmma_rs(acc[NJ == 1 ? (kk & 1) : j], a[s & 1][kk], db);"),
        ("    keep(acc);\n", "    keep(acc);\n    if (NJ == 1)\n#pragma unroll\n"
         "      for (int e = 0; e < 32; ++e) acc[0][e] += acc[1][e];\n")],
    "pipe1": [(_PIPE0, _PIPE1)],
    "two_slots": [("{ return family == TILE2D ? 1 : 2; }", "{ return 2; }")],
}
DEFAULT_KINDS = ("taps9_4_64", "ky3_4_32", "im2col_4_32", "dma-ky3_4_32", "dma-im2col_4_32",
                 "t4-ky3_8_16", "t4-im2col_8_16", "s2dc_8_16", "s2d9_8_16")


def source(name: str) -> str:
    """The kernel source of variant `name`; ValueError if a line to
    replace is not in the source exactly once."""
    src = (build.CSRC / cf.SOURCE).read_text()
    for line, new in VARIANTS[name]:
        if src.count(line) != 1:
            raise ValueError(f"variant {name}: {line.strip()[:60]!r} is not in {cf.SOURCE} once")
        src = src.replace(line, new)
    return src


def build_variants(names, out_dir: Path) -> dict:
    """{name: library path}, one nvcc a variant, all started together;
    prints each variant's ptxas lines for conv_wgmma_kernel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(source(name))
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n" + "\n".join(log[-40:]))
        for i, line in enumerate(log):
            if "conv_wgmma" in line and "Function properties" in line:
                kernel = line.split("conv_wgmma_kernel")[1].split("EEEv")[0]
                print(json.dumps({"variant": name, "kernel": kernel,
                                  "ptxas": " | ".join(v.strip() for v in log[i + 1:i + 3])}))
            elif "conv_wgmma" in line and "C75" in line:
                print(json.dumps({"variant": name, "ptxas": line.strip()[:160]}))
    return {name: out_dir / f"{name}.so" for name in names}


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kinds", default=",".join(DEFAULT_KINDS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the variants run only on the card")
    names = [v for v in args.variants.split(",") if v]
    specs = [k for k in args.kinds.split(",") if k]
    libs = build_variants(names, build.BUILD_DIR / "xconv_variants")
    dev = torch.device("cuda")
    x, w, _, _ = tool.inputs(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    s = torch.rand(64, device=dev, generator=g) + 0.5
    t = torch.randn(64, device=dev, generator=g) * 0.1
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "shape": list(x.shape)}))
    saved = cf._lib
    try:
        for rnd in range(args.rounds):
            for name in names:
                cf._lib = cf.bind(ctypes.CDLL(str(libs[name])))
                for spec in specs:
                    f = tool.build(spec)
                    with torch.no_grad():
                        ms = cuda_ms(lambda: f(x, w, s, t))
                    print(json.dumps({"round": rnd, "variant": name, "kind": spec, "ms": ms}),
                          flush=True)
    finally:
        cf._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
