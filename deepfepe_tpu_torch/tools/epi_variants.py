"""Where K3's time goes: builds of `csrc/epi_residual.cu` with one of its
constants or lines changed (VARIANTS), each timed on the card at the
callers' patterns of `tools/profile_epi.py` (CASES, through
`compute_epi_residual`), the K3 kernels' device ms a call from
torch.profiler:

  base        the source as it is
  lb4         the backward held to 4 blocks an SM (at most 64 registers)
  fwd256      forward blocks of 256 threads (128 in base)
  vec_all     every forward takes four residuals a thread where N allows
  vec_none    none does
  narrow      one warp a tile (points) or a matrix (dF), however few
              blocks the grid has
  no_split    no sum is split over a cluster
  split8      every sum is split over 8 blocks, short or long
  parent_dF   dF by the previous kernel's loop (one warp a matrix, points
              staged flat, the cotangent read in the loop), for [P, M, 9]
              and [P, M, N] tensors only (a timing only elsewhere)
  no_math     dF's terms without the residual and its cotangents (a
              product of g and F instead): what the rest of dF costs
  chevron     a launch without clusters goes through <<<>>>, not
              cudaLaunchKernelEx
  grid_const  the backward's parameter block is __grid_constant__
  cluster_top every backward instance makes cg::this_cluster() at its
              start, clusters or not
  plain_div   divisions by runtime sizes with `/`, not by multiply-high
  direct_pts  dF's lanes read their points from global memory (cached),
              not from a chunk staged in shared memory
  args_big    the kernels' parameter block 1 KB larger (unused)
  smem_big    the backward's shared memory padded by 12 KB (its size
              before each role's sums took one path)
  fixed_sms   the backward takes 132 SMs as a constant in place of its
              cudaGetDevice + cudaDeviceGetAttribute queries (the H100
              SXM's count; a runtime-API suspect of tools/profiler_witness.py)

Every variant but no_math and parent_dF computes the function; only the
time differs. Variants joined by '+' apply in turn. `--extra NAME=PATH`
times another source of the same C interface (an earlier version of the
file) among them. The variants are built by one nvcc each, all started
together, and timed in turns, `--rounds` times. Needs a CUDA card and
nvcc.

    python -m deepfepe_tpu_torch.tools.epi_variants [--variants base,...]
        [--extra NAME=PATH] [--rounds 2] [--iters 100]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import epi_residual as epi
from ..utils import build
from . import profile_epi

_SPLIT_P = "  while (need_pts && a.sP < MAX_SPLIT && a.sP * tilesP < sms && M > wq * a.sP) a.sP *= 2;"
_SPLIT_F = "  while (dF && a.sF < MAX_SPLIT && a.sF * tilesF < sms && N > 32 * wn * a.sF) a.sF *= 2;"
_WIDE_P = "  while (wq < NW && wq < M && P * ceil_div(N, 32 * (NW / wq)) < sms) wq *= 2;"
_WIDE_F = "  while (wn < NW && 32 * wn < N && P * ceil_div(M, NW / wn) < sms) wn *= 2;"
_PARENT_DF = """__device__ __forceinline__ int dF_parent(const Args& a, int tile, float* sp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = div_of(tile, a.by_mtiles);
  if (p >= a.q.P) return 0;
  const int m = (tile - p * a.by_mtiles.d) * a.wm + warp;
  const bool live = m < a.M;
  float f[9], acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = live ? a.F[(static_cast<long long>(p) * a.M + m) * 9 + k] : 0.f;
    acc[k] = 0.f;
  }
  const float* gr = a.g + (static_cast<long long>(p) * a.M + (live ? m : 0)) * a.N;
  for (int c0 = 0; c0 < a.N; c0 += 256) {
    const int cn = min(256, a.N - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 3; i += TPB) {
      sp[i] = a.pts1[(static_cast<long long>(p) * a.N + c0) * 3 + i];
      sp[768 + i] = a.pts2[(static_cast<long long>(p) * a.N + c0) * 3 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < cn; j += 32) {
      const float x1 = sp[3 * j], y1 = sp[3 * j + 1], z1 = sp[3 * j + 2];
      const float x2 = sp[768 + 3 * j], y2 = sp[768 + 3 * j + 1], z2 = sp[768 + 3 * j + 2];
      const Terms t = residual(f, x1, y1, z1, x2, y2, z2, a.eps);
      const Grads c = cotangents(t, gr[c0 + j], x2, y2, z2, a.clamp_at);
      acc[0] += c.gl1x * x1 + x2 * c.gl2x;
      acc[1] += c.gl1x * y1 + x2 * c.gl2y;
      acc[2] += c.gl1x * z1;
      acc[3] += c.gl1y * x1 + y2 * c.gl2x;
      acc[4] += c.gl1y * y1 + y2 * c.gl2y;
      acc[5] += c.gl1y * z1;
      acc[6] += c.gl1z * x1 + z2 * c.gl2x;
      acc[7] += c.gl1z * y1 + z2 * c.gl2y;
      acc[8] += c.gl1z * z1;
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.dF[(static_cast<long long>(p) * a.M + m) * 9 + k] = acc[k];
  }
  return 0;
}

__device__ __forceinline__ void store("""
_STAGED = """  for (int c0 = start; c0 < end; c0 += NCH) {
    const int cn = min(NCH, end - c0);
    if (c0 != start) __syncthreads();  // the last chunk's reads are done
    for (int i = threadIdx.x; i < cn; i += TPB) {
      const Pt x = load_point(a, p, c0 + i);
      sp[3 * i] = x.x1;
      sp[3 * i + 1] = x.y1;
      sp[3 * i + 2] = x.z1;
      sp[3 * (NCH + i)] = x.x2;
      sp[3 * (NCH + i) + 1] = x.y2;
      sp[3 * (NCH + i) + 2] = x.z2;
    }
    __syncthreads();
    if (!live) continue;
    const int j0 = (warp & (wn - 1)) * 32 + lane;
    const float* gj = gr + (c0 + j0) * a.q.o[3];
    const long long gstep = wn * 32 * a.q.o[3];
    for (int j = j0; j < cn; j += wn * 32, gj += gstep) {
      const float x1 = sp[3 * j], y1 = sp[3 * j + 1], z1 = sp[3 * j + 2];
      const float x2 = sp[3 * (NCH + j)], y2 = sp[3 * (NCH + j) + 1], z2 = sp[3 * (NCH + j) + 2];"""
_DIRECT = """  if (live) {
    const int j0 = start + (warp & (wn - 1)) * 32 + lane;
    const float* gj = gr + j0 * a.q.o[3];
    const long long gstep = wn * 32 * a.q.o[3];
    for (int j = j0; j < end; j += wn * 32, gj += gstep) {
      const Pt x = load_point(a, p, j);
      const float x1 = x.x1, y1 = x.y1, z1 = x.z1, x2 = x.x2, y2 = x.y2, z2 = x.z2;"""
_CFG = "  cudaLaunchConfig_t cfg = {};"
_CHEVRON = """  if (a.cs == 1) {
    const unsigned blocks = static_cast<unsigned>(nbP + nbF);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (need_pts) {
      epi_bwd_kernel<true, false><<<blocks, TPB, 0, s>>>(a);
    } else {
      epi_bwd_kernel<false, false><<<blocks, TPB, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
"""
_BPART = ("  __shared__ float bpart[CLUSTER ? (PTS ? NW * 32 * 6 : NW * 9) : 1];  "
          "// the block's partial")
VARIANTS = {
    "base": [],
    "lb4": [("__launch_bounds__(TPB) epi_bwd_kernel", "__launch_bounds__(TPB, 4) epi_bwd_kernel")],
    "fwd256": [("constexpr int TPB_FWD = 128;", "constexpr int TPB_FWD = 256;")],
    "vec_all": [("VEC_WORK = 1 << 16;", "VEC_WORK = 0;")],
    "vec_none": [("VEC_WORK = 1 << 16;", "VEC_WORK = 1LL << 40;")],
    "narrow": [(_WIDE_P, ""), (_WIDE_F, "")],
    "no_split": [(_SPLIT_P, ""), (_SPLIT_F, "")],
    "split8": [(_SPLIT_P, "  a.sP = need_pts ? MAX_SPLIT : 1;"),
               (_SPLIT_F, "  a.sF = dF ? MAX_SPLIT : 1;")],
    "parent_dF": [("__device__ __forceinline__ void store(", _PARENT_DF),
                  (": dF_partial(a, tile, part, sp, ws, keep);", ": dF_parent(a, tile, sp);")],
    "no_math": [("      const Terms t = residual(f, x1, y1, z1, x2, y2, z2, a.eps);\n"
                 "      const Grads c = cotangents(t, __ldg(gj), x2, y2, z2, a.clamp_at);",
                 "      const float gv = __ldg(gj);\n"
                 "      const Grads c = {gv, gv * f[0], gv * f[1], gv * f[2], gv * f[3], "
                 "gv * f[4]};")],
    "chevron": [(_CFG, _CHEVRON + _CFG)],
    "grid_const": [("epi_bwd_kernel(const Args a) {",
                    "epi_bwd_kernel(__grid_constant__ const Args a) {")],
    "cluster_top": [(_BPART,
                     _BPART + "\n  cg::cluster_group top = cg::this_cluster();\n  (void)top;")],
    "plain_div": [("  return v.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), "
                   "v.mul) >> v.shr);", "  return n / v.d;")],
    "direct_pts": [(_STAGED, _DIRECT)],
    "args_big": [("  int cs;           // blocks a cluster",
                  "  int cs;           // blocks a cluster\n  long long unused[128];")],
    "smem_big": [("  __shared__ float ws[NW * 9];", "  __shared__ float ws[NW * 9 + 3072];")],
    "fixed_sms": [("  cudaError_t e = cudaGetDevice(&dev);\n"
                   "  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, "
                   "cudaDevAttrMultiProcessorCount, dev);\n",
                   "  cudaError_t e = cudaSuccess;\n  sms = 132;\n  (void)dev;\n")],
}


def source(name: str) -> str:
    """The kernel's source under variant `name`, or under several joined
    by '+' (applied in turn)."""
    src = (build.CSRC / epi.SOURCE).read_text()
    for line, new in (change for part in name.split("+") for change in VARIANTS[part]):
        if src.count(line) != 1:
            raise ValueError(f"variant {name}: {line!r} is not once in {epi.SOURCE}")
        src = src.replace(line, new)
    return src


def build_variants(names, out_dir: Path, extra: dict | None = None) -> dict:
    """One nvcc a variant, all started together: {name: bound library} of
    those that built."""
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(name):
        cu, so = out_dir / f"epi_{name}.cu", out_dir / f"epi_{name}.so"
        cu.write_text(Path(extra[name]).read_text() if name in (extra or {}) else source(name))
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        ptxas = [ln.split("ptxas info    : ")[-1].strip()
                 for ln in proc.stdout.splitlines() + proc.stderr.splitlines()
                 if "registers" in ln or "spill" in ln]
        return name, (so if proc.returncode == 0 else None), ptxas, proc.stderr[-3000:]

    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(one, names))
    libs = {}
    for name, so, ptxas, err in built:
        if so is None:  # reported, and left out of the timing
            print(json.dumps({"variant": name, "nvcc_failed": err}), flush=True)
            continue
        libs[name] = epi.bind(ctypes.CDLL(str(so)))
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=100, help="profiled calls a reading")
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH",
                    help="also time this source, as variant NAME")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("epi_variants: no CUDA device", file=sys.stderr)
        return 2
    extra = dict(e.split("=", 1) for e in args.extra)
    names = args.variants.split(",") + list(extra)
    libs = build_variants(names, build.BUILD_DIR / "epi_variants", extra)
    fns = [(case[0], direction, fn) for case in profile_epi.CASES
           for direction, fn in profile_epi.case_fns(*case).items()]
    for r in range(args.rounds):
        for name in libs:
            epi._lib = libs[name]
            row = {"variant": name, "round": r}
            for case, direction, fn in fns:
                fn()
                row[f"{case}_{direction}"] = profile_epi.device_split(fn, args.iters)["kernel_ms"]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
