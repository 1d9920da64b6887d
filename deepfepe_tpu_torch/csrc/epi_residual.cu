// The robust epipolar residual (K3) and its backward.
//
// Replaces the TPU kernel `_epi_kernel` in
// deepfepe_tpu/ops/pallas/epi_residual_pallas.py (wrapper
// `epi_residual_pallas`), which computes, per correspondence,
//   d = |x2' F x1| * (1 / (|(F x1)_xy| + eps) + 1 / (|(F' x2)_xy| + eps)),
// clamped at `clamp_at`. The TPU kernel reads one F per batch item and is
// forward-only with a plain sqrt. This file computes the same residual for
// M matrices F per item against that item's N points (the sample loss
// scores 500 hypotheses on one set of virtual points), and adds the
// backward the training path needs, with the semantics of the plain version
// (ops/epi_residual.py `epi_residual_ref`, geometry.basic `safe_norm`): a
// norm that is exactly 0 passes no gradient, |s| has gradient 0 at s = 0,
// and the clamp passes the gradient where d <= clamp_at.
//
// Layout. Every tensor is read or written in its caller's own order,
// through element strides that the wrapper computes (ops/epi_residual.py
// `Layout`): points [P, N, 3] (item, point, coordinate), F [P, M_hi, M_lo,
// 3, 3] (item, two matrix axes, row, column), the residual and its
// cotangent [P, M_hi, M_lo, N]. An item has M = M_hi M_lo matrices, m =
// m_hi M_lo + m_lo: the sample loss's [L, B, S] matrices against [B] points
// span two axes. dF is written in F's own shape (contiguous, rows of 3),
// the points' gradients [P, N, 3] contiguous. The (p, m, n) work is
// indexed in 32 bits (the wrapper raises past 2^31 - 1 residuals), its
// divisions by runtime sizes done by multiply and shift (`Div`).
//
// What bounds it. About 45 flops per (p, m, n) against 4 bytes written per
// residual: at the sample loss's [8, 500, 100] that is 18 MFLOP (0.27 us at
// the card's 67 TFLOP/s FP32 rate) against 1.6 MB (0.48 us at 3.35 TB/s),
// so the forward is bound by bytes on paper; the backward's ~100-200 flops
// a term (two square roots and four IEEE divisions among them) by
// operations. Every call on the paths is a few microseconds, so what a call
// costs is its launches, the instructions a term takes, and the longest
// serial chain of one block: the design runs one launch a call, spreads
// each call over the card, and splits a long sum over blocks.
//
// Design.
// - Forward: a thread computes VEC consecutive residuals of one (p, m) row
//   (VEC = 4, a float4 store, where N and the rows allow and the call has
//   VEC_WORK residuals or more; else 1, for more blocks). Threads cover the
//   flattened (p, m, n) work, a warp's lanes consecutive n, so stores are
//   coalesced and only the grid's last block has idle lanes. F's nine
//   entries are one address for all lanes of a row: a broadcast load each.
// - Backward: one launch for dF and, when asked for, the points'
//   gradients, in the instance of `epi_bwd_kernel<PTS, CLUSTER>` the call
//   needs. Its blocks come in two roles, each block taking one output
//   tile: wp tiles of 32 points for the points' gradients (NW / wp warps a
//   tile, over the matrices; first in the grid, as their chains are the
//   longer), or wm matrices of an item for dF (NW / wm warps a matrix,
//   lanes over the item's points, staged in shared memory). The warps a
//   tile take are doubled while the grid has fewer blocks than the card
//   has SMs. A tile's sum that is still long (over N for dF, over M for the
//   points) is then split over `split` blocks of a thread-block cluster
//   (Hopper; up to 8, the portable size), again while the grid is short of
//   one block an SM. Each sum runs in a fixed order: a lane's terms in turn;
//   for dF a warp's lanes in lane order through shared memory; a tile's
//   warps in order; then, in a cluster, the first block of each group adds
//   its group's partials in rank order through distributed shared memory
//   and writes the tile. No atomics and no second pass, so the result is
//   the same from run to run. Every block, padding included, reaches both
//   cluster barriers: the second keeps each block's shared memory alive
//   until its group's first block has read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int TPB_FWD = 128;             // threads a forward block
constexpr long long VEC_WORK = 1 << 16;  // residuals a call from which a thread takes four
constexpr int TPB = 256;                 // threads a backward block
constexpr int NW = TPB / 32;             // its warps
constexpr int NCH = 256;                 // points a dF block stages at a time
constexpr int SP = std::max(2 * NCH * 3, NW * 32 * 9);  // floats: a staged chunk, or lanes' sums
constexpr int MAX_SPLIT = 8;             // blocks a sum: the portable cluster size
constexpr int GEO = 22;                  // long longs in the wrapper's geometry

struct Terms {
  float l1x, l1y, l1z, l2x, l2y;  // F x1 and (F' x2)_xy
  float s, n1, n2, r1, r2, d;
};

__device__ __forceinline__ Terms residual(const float* f, float x1, float y1, float z1,
                                          float x2, float y2, float z2, float eps) {
  Terms t;
  t.l1x = f[0] * x1 + f[1] * y1 + f[2] * z1;
  t.l1y = f[3] * x1 + f[4] * y1 + f[5] * z1;
  t.l1z = f[6] * x1 + f[7] * y1 + f[8] * z1;
  t.l2x = f[0] * x2 + f[3] * y2 + f[6] * z2;
  t.l2y = f[1] * x2 + f[4] * y2 + f[7] * z2;
  t.s = x2 * t.l1x + y2 * t.l1y + z2 * t.l1z;
  const float q1 = t.l1x * t.l1x + t.l1y * t.l1y;
  const float q2 = t.l2x * t.l2x + t.l2y * t.l2y;
  t.n1 = q1 > 0.f ? sqrtf(q1) : 0.f;
  t.n2 = q2 > 0.f ? sqrtf(q2) : 0.f;
  t.r1 = 1.f / (t.n1 + eps);
  t.r2 = 1.f / (t.n2 + eps);
  t.d = fabsf(t.s) * (t.r1 + t.r2);
  return t;
}

// The cotangents of l1 = F x1 (gl1, 3) and of (F' x2)_xy (gl2, 2), and of s
// (gs), for the residual's cotangent g.
struct Grads {
  float gs, gl1x, gl1y, gl1z, gl2x, gl2y;
};

__device__ __forceinline__ Grads cotangents(const Terms& t, float g, float x2, float y2,
                                            float z2, float clamp_at) {
  Grads c;
  const float gd = t.d <= clamp_at ? g : 0.f;  // torch.clamp: passes at the tie
  const float sgn = t.s > 0.f ? 1.f : (t.s < 0.f ? -1.f : 0.f);
  c.gs = gd * sgn * (t.r1 + t.r2);
  const float as = fabsf(t.s);
  const float u1 = t.n1 > 0.f ? (-gd * as * t.r1 * t.r1) / t.n1 : 0.f;
  const float u2 = t.n2 > 0.f ? (-gd * as * t.r2 * t.r2) / t.n2 : 0.f;
  c.gl1x = c.gs * x2 + u1 * t.l1x;
  c.gl1y = c.gs * y2 + u1 * t.l1y;
  c.gl1z = c.gs * z2;
  c.gl2x = u2 * t.l2x;
  c.gl2y = u2 * t.l2y;
  return c;
}

// The wrapper's geometry, in its order: sizes, then element strides.
struct Geo {
  long long P, MH, ML, N;
  long long p1[3], p2[3];  // points: item, point, coordinate
  long long f[5];          // F: item, m_hi, m_lo, row, column
  long long o[4];          // residual (forward) or cotangent (backward): item, m_hi, m_lo, point
  long long d[3];          // dF: item, m_hi, m_lo
};
static_assert(sizeof(Geo) == GEO * sizeof(long long), "Geo is the wrapper's GEO long longs");

// Division of a non-negative int below 2^31 by a fixed divisor d >= 1, by
// a multiply-high and a shift (the divisor's magic number from the host).
struct Div {
  int d;
  unsigned mul, shr;
};

Div make_div(int d) {
  if (d <= 1) return {1, 0u, 0u};
  int l = 0;
  while ((1LL << l) < d) ++l;  // ceil(log2(d))
  const unsigned long long p = 31ULL + l;
  return {d, static_cast<unsigned>(((1ULL << p) + d - 1) / d), static_cast<unsigned>(p - 32)};
}

__device__ __forceinline__ int div_of(int n, const Div& v) {
  return v.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), v.mul) >> v.shr);
}

struct Args {
  Geo q;
  const float* pts1;
  const float* pts2;
  const float* F;
  float* out;       // forward
  const float* g;   // backward
  float* dF;        // backward outputs; each may be null
  float* dpts1;
  float* dpts2;
  float clamp_at, eps;
  int M, N;         // M_hi M_lo, N
  Div by_M, by_ML;  // m = p M + ..., m = m_hi M_lo + m_lo
  Div by_chunks;    // forward: a row's threads
  int cs;           // blocks a cluster
  int wp, lq, sP, lsP, nbP;  // points: 32-point tiles a block, log2 of the warps
                             // a tile, blocks a sum and its log2, blocks
  int wm, ln, sF, lsF;       // dF: matrices a block, log2 of the warps a matrix,
                             // blocks a sum and its log2
  Div by_ptiles, by_mtiles;  // tiles an item: the points', dF's
};

struct Pt {
  float x1, y1, z1, x2, y2, z2;
};

__device__ __forceinline__ Pt load_point(const Args& a, int p, int n) {
  const float* u = a.pts1 + p * a.q.p1[0] + n * a.q.p1[1];
  const float* v = a.pts2 + p * a.q.p2[0] + n * a.q.p2[1];
  const long long cu = a.q.p1[2], cv = a.q.p2[2];
  return {__ldg(u), __ldg(u + cu), __ldg(u + 2 * cu), __ldg(v), __ldg(v + cv), __ldg(v + 2 * cv)};
}

// Offset of row (p, m) under the item, m_hi, m_lo strides s.
__device__ __forceinline__ long long row_at(const long long* s, const Args& a, int p, int m) {
  const int mh = div_of(m, a.by_ML);
  return p * s[0] + mh * s[1] + (m - mh * a.by_ML.d) * s[2];
}

__device__ __forceinline__ void load_F(const Args& a, long long row, float* f) {
  const float* fb = a.F + row;
  if (a.q.f[3] == 3 && a.q.f[4] == 1) {  // row-major 3x3: nine floats in a row
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = __ldg(fb + k);
    return;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) f[3 * r + c] = __ldg(fb + r * a.q.f[3] + c * a.q.f[4]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(TPB_FWD) epi_fwd_kernel(const Args a) {
  const unsigned tu = blockIdx.x * TPB_FWD + threadIdx.x;
  if (tu >= static_cast<unsigned>(a.q.P * a.M) * a.by_chunks.d) return;
  const int t = static_cast<int>(tu);
  const int row = div_of(t, a.by_chunks);
  const int p = div_of(row, a.by_M);
  const int n0 = (t - row * a.by_chunks.d) * VEC;
  const int m = row - p * a.M;
  float f[9];
  load_F(a, row_at(a.q.f, a, p, m), f);
  float d[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const Pt x = load_point(a, p, n0 + i);
    const float r = residual(f, x.x1, x.y1, x.z1, x.x2, x.y2, x.z2, a.eps).d;
    d[i] = r > a.clamp_at ? a.clamp_at : r;  // NaN stays NaN
  }
  float* o = a.out + row_at(a.q.o, a, p, m);
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o + n0) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    o[n0 * a.q.o[3]] = d[0];
  }
}

__device__ __forceinline__ void store(const Args& a, bool pts_role, int tile, int e, float s) {
  if (pts_role) {
    const int p = div_of(tile, a.by_ptiles), j = e / (32 * 6), r = e - j * 32 * 6;
    const int n = ((tile - p * a.by_ptiles.d) * a.wp + j) * 32 + r / 6, k = r % 6;
    float* dst = k < 3 ? a.dpts1 : a.dpts2;
    if (n < a.N && dst) dst[(static_cast<long long>(p) * a.N + n) * 3 + k % 3] = s;
    return;
  }
  const int p = div_of(tile, a.by_mtiles), j = e / 9;
  const int m = (tile - p * a.by_mtiles.d) * a.wm + j;
  if (m < a.M) a.dF[row_at(a.q.d, a, p, m) + (e - j * 9)] = s;
}

// Entry e of a block's tile: written at once, or kept in `keep` (the
// block's partial) for its cluster group's first block.
__device__ __forceinline__ void put(const Args& a, bool pts_role, int tile, int e, float s,
                                    float* keep) {
  if (keep) {
    keep[e] = s;
  } else {
    store(a, pts_role, tile, e, s);
  }
}

// The points' share of a block: the wp 32-point tiles of its tile, over its
// part of the matrices, each lane's sums (dpts1, then dpts2) through ws.
// Puts its tile's entries and returns their count (0 for a padding block).
__device__ __forceinline__ int dpts_partial(const Args& a, int tile, int part, float* ws,
                                            float* keep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = 1 << a.lq;  // warps a 32-point tile
  const int p = div_of(tile, a.by_ptiles);
  if (p >= a.q.P) return 0;
  const int n = ((tile - p * a.by_ptiles.d) * a.wp + (warp >> a.lq)) * 32 + lane;
  float d1[3] = {0.f, 0.f, 0.f};
  float d2[3] = {0.f, 0.f, 0.f};
  if (n < a.N) {
    const Pt x = load_point(a, p, n);
    const int per = (a.M + a.sP - 1) >> a.lsP;  // matrices a part
    const int end = min(a.M, (part + 1) * per);
    const int first = part * per + (warp & (wq - 1));
    // Matrix m's m_lo and its rows in F and g, stepped by wq.
    const int ML = a.by_ML.d;
    const int mh = div_of(first, a.by_ML);
    int ml = first - mh * ML;
    long long rf = p * a.q.f[0] + mh * a.q.f[1] + ml * a.q.f[2];
    long long ro = p * a.q.o[0] + mh * a.q.o[1] + ml * a.q.o[2] + n * a.q.o[3];
    for (int m = first; m < end; m += wq) {
      float f[9];
      load_F(a, rf, f);
      const Terms t = residual(f, x.x1, x.y1, x.z1, x.x2, x.y2, x.z2, a.eps);
      const Grads c = cotangents(t, __ldg(a.g + ro), x.x2, x.y2, x.z2, a.clamp_at);
      // dx1 = F' gl1; dx2 = gs * l1 + F gl2.
      d1[0] += f[0] * c.gl1x + f[3] * c.gl1y + f[6] * c.gl1z;
      d1[1] += f[1] * c.gl1x + f[4] * c.gl1y + f[7] * c.gl1z;
      d1[2] += f[2] * c.gl1x + f[5] * c.gl1y + f[8] * c.gl1z;
      d2[0] += c.gs * t.l1x + f[0] * c.gl2x + f[1] * c.gl2y;
      d2[1] += c.gs * t.l1y + f[3] * c.gl2x + f[4] * c.gl2y;
      d2[2] += c.gs * t.l1z + f[6] * c.gl2x + f[7] * c.gl2y;
      ml += wq;
      rf += wq * a.q.f[2];
      ro += wq * a.q.o[2];
      while (ml >= ML) {
        ml -= ML;
        rf += a.q.f[1] - ML * a.q.f[2];
        ro += a.q.o[1] - ML * a.q.o[2];
      }
    }
  }
  // A tile of one warp puts each lane's sums; one of several warps adds
  // them in order, in the tile's first warp.
  if (wq == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      put(a, true, tile, (warp * 32 + lane) * 6 + k, d1[k], keep);
      put(a, true, tile, (warp * 32 + lane) * 6 + 3 + k, d2[k], keep);
    }
  } else {
    float* w = ws + warp * 32 * 6 + lane * 6;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k] = d1[k];
      w[3 + k] = d2[k];
    }
    __syncthreads();
    if ((warp & (wq - 1)) == 0) {
      const int e0 = ((warp >> a.lq) * 32 + lane) * 6;
      for (int k = 0; k < 6; ++k) {
        float s = 0.f;
        for (int i = 0; i < wq; ++i) s += w[i * 32 * 6 + k];  // the tile's warps, in order
        put(a, true, tile, e0 + k, s, keep);
      }
    }
  }
  return a.wp * 32 * 6;
}

// dF's share of a block: the wm matrices of its tile, over its part of the
// item's points, staged NCH at a time in shared memory (sp: x1, then x2,
// each [n][3]). Puts its tile's entries and returns their count (0 for a
// padding block).
__device__ __forceinline__ int dF_partial(const Args& a, int tile, int part, float* sp,
                                          float* ws, float* keep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = 1 << a.ln;  // warps a matrix
  const int p = div_of(tile, a.by_mtiles);
  if (p >= a.q.P) return 0;
  const int m = (tile - p * a.by_mtiles.d) * a.wm + (warp >> a.ln);
  const bool live = m < a.M;
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;
  float f[9];
  const float* gr = a.g;
  if (live) {
    load_F(a, row_at(a.q.f, a, p, m), f);
    gr += row_at(a.q.o, a, p, m);
  }
  const int per = (a.N + a.sF - 1) >> a.lsF;  // points a part
  const int start = part * per, end = min(a.N, start + per);
  for (int c0 = start; c0 < end; c0 += NCH) {
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
      const float x2 = sp[3 * (NCH + j)], y2 = sp[3 * (NCH + j) + 1], z2 = sp[3 * (NCH + j) + 2];
      const Terms t = residual(f, x1, y1, z1, x2, y2, z2, a.eps);
      const Grads c = cotangents(t, __ldg(gj), x2, y2, z2, a.clamp_at);
      // dF = gl1 x1' + x2 gl2' (gl2's third entry is 0).
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
  __syncthreads();  // every warp is done with the points in sp
#pragma unroll
  for (int k = 0; k < 9; ++k) sp[(warp * 32 + lane) * 9 + k] = acc[k];
  __syncthreads();
  // A matrix of one warp is put from its lanes' sum; one of several warps
  // adds its warps' sums in order.
  if (threadIdx.x < NW * 9) {
    const int w = threadIdx.x / 9, k = threadIdx.x - w * 9;
    float s = 0.f;
    for (int l = 0; l < 32; ++l) s += sp[(w * 32 + l) * 9 + k];  // the warp's lanes, in order
    if (wn == 1) {
      put(a, false, tile, threadIdx.x, s, keep);
    } else {
      ws[threadIdx.x] = s;
    }
  }
  if (wn > 1) {
    __syncthreads();
    if (threadIdx.x < a.wm * 9) {
      const int j = threadIdx.x / 9, k = threadIdx.x - j * 9;
      float s = 0.f;
      for (int i = 0; i < wn; ++i) s += ws[(j * wn + i) * 9 + k];  // the matrix's warps, in order
      put(a, false, tile, threadIdx.x, s, keep);
    }
  }
  return a.wm * 9;
}

// PTS: the grid has the points' role; CLUSTER: blocks come in clusters.
// Each launch takes the instance it needs, the others' code compiled out.
template <bool PTS, bool CLUSTER>
__global__ void __launch_bounds__(TPB) epi_bwd_kernel(const Args a) {
  // dF: a chunk of the item's points, then its lanes' sums; the points'
  // role: its lanes' sums.
  __shared__ float sp[SP];
  __shared__ float ws[NW * 9];  // dF: its warps' sums
  __shared__ float bpart[CLUSTER ? (PTS ? NW * 32 * 6 : NW * 9) : 1];  // the block's partial
  const int bid = static_cast<int>(blockIdx.x);
  const bool pts_role = PTS && bid < a.nbP;  // the longer chains first
  const int blk = pts_role ? bid : bid - a.nbP;  // a.nbP is whole clusters
  const int rank = blk & (a.cs - 1);  // cs and split are powers of two
  const int split = pts_role ? a.sP : a.sF;
  const int part = rank & (split - 1);  // this block's share of its tile's sums
  const int lg = pts_role ? a.lsP : a.lsF;
  const int tile = ((blk - rank) >> lg) + (rank >> lg);
  // A tile of one block is written at once; a split one is kept for the
  // group's first block.
  float* keep = CLUSTER && split > 1 ? bpart : nullptr;
  const int items = pts_role ? dpts_partial(a, tile, part, sp, keep)
                             : dF_partial(a, tile, part, sp, ws, keep);
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (keep && part == 0) {
      for (int e = threadIdx.x; e < items; e += TPB) {
        float s = 0.f;
        // Every rank's partial, in rank order (distributed shared memory).
        for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(bpart, rank + r)[e];
        store(a, pts_role, tile, e, s);
      }
    }
    cluster.sync();  // keeps each block's bpart alive until its group's first block has read it
  }
}

int log2i(int x) {  // x a power of two
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

long long ceil_div(long long x, long long y) {
  return (x + y - 1) / y;
}

Args make_args(const float* pts1, const float* pts2, const float* F, const long long* geo,
               float clamp_at, float eps) {
  Args a = {};
  const long long* src = geo;
  long long* dst = reinterpret_cast<long long*>(&a.q);
  for (int i = 0; i < GEO; ++i) dst[i] = src[i];
  a.pts1 = pts1;
  a.pts2 = pts2;
  a.F = F;
  a.clamp_at = clamp_at;
  a.eps = eps;
  a.M = static_cast<int>(a.q.MH * a.q.ML);
  a.N = static_cast<int>(a.q.N);
  a.by_M = make_div(a.M);
  a.by_ML = make_div(static_cast<int>(a.q.ML));
  return a;
}

bool too_large(const Geo& q) {
  return q.P * q.MH * q.ML * q.N > INT_MAX;
}

}  // namespace

// pts1, pts2, F, out: float32 on the device, addressed through `geo`, the
// wrapper's GEO long longs (Geo's order; `o` the residual's strides).
// Launches on `stream` and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for more than 2^31 - 1 residuals.
extern "C" int epi_residual_f32(const float* pts1, const float* pts2, const float* F, float* out,
                                const long long* geo, float clamp_at, float eps, void* stream) {
  Args a = make_args(pts1, pts2, F, geo, clamp_at, eps);
  if (too_large(a.q)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.q.P == 0 || a.M == 0 || a.N == 0) return 0;
  a.out = out;
  const long long work = a.q.P * a.M * a.N;
  const bool vec = work >= VEC_WORK && a.N % 4 == 0 && a.q.o[3] == 1 && a.q.o[0] % 4 == 0 &&
                   a.q.o[1] % 4 == 0 && a.q.o[2] % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.by_chunks = make_div(vec ? a.N / 4 : a.N);
  const dim3 grid(static_cast<unsigned>(ceil_div(work / (vec ? 4 : 1), TPB_FWD)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    epi_fwd_kernel<4><<<grid, TPB_FWD, 0, s>>>(a);
  } else {
    epi_fwd_kernel<1><<<grid, TPB_FWD, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward for the residual's cotangent g (geo's `o` holds g's
// strides): dF in F's shape, contiguous, when dF is not null; dpts1 and
// dpts2 [P, N, 3] contiguous where they are not null. One launch, in
// clusters of up to MAX_SPLIT blocks (cudaLaunchKernelEx). Returns the
// launch's error, then cudaGetLastError().
extern "C" int epi_residual_bwd_f32(const float* pts1, const float* pts2, const float* F,
                                    const float* g, float* dF, float* dpts1, float* dpts2,
                                    const long long* geo, float clamp_at, float eps,
                                    void* stream) {
  Args a = make_args(pts1, pts2, F, geo, clamp_at, eps);
  if (too_large(a.q)) return static_cast<int>(cudaErrorInvalidValue);
  const bool need_pts = dpts1 || dpts2;
  if (a.q.P == 0 || a.M == 0 || a.N == 0 || !(dF || need_pts)) return 0;
  a.g = g;
  a.dF = dF;
  a.dpts1 = dpts1;
  a.dpts2 = dpts2;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long P = a.q.P, M = a.M, N = a.N;
  // The points' gradients: wq warps a 32-point tile over the matrices,
  // doubled while the grid is short of one block an SM, then the sum over
  // M split over sP blocks while it still is.
  int wq = 1;
  while (wq < NW && wq < M && P * ceil_div(N, 32 * (NW / wq)) < sms) wq *= 2;
  a.wp = NW / wq;
  a.lq = log2i(wq);
  const long long tilesP = need_pts ? P * ceil_div(N, 32 * a.wp) : 0;
  a.sP = 1;
  while (need_pts && a.sP < MAX_SPLIT && a.sP * tilesP < sms && M > wq * a.sP) a.sP *= 2;
  // dF: wn warps a matrix over the points, likewise; then the sum over N.
  int wn = 1;
  while (wn < NW && 32 * wn < N && P * ceil_div(M, NW / wn) < sms) wn *= 2;
  a.wm = NW / wn;
  a.ln = log2i(wn);
  const long long tilesF = dF ? P * ceil_div(M, a.wm) : 0;
  a.sF = 1;
  while (dF && a.sF < MAX_SPLIT && a.sF * tilesF < sms && N > 32 * wn * a.sF) a.sF *= 2;
  a.lsP = log2i(a.sP);
  a.lsF = log2i(a.sF);
  a.cs = std::max(a.sF, a.sP);
  const long long nbP = ceil_div(tilesP, a.cs / a.sP) * a.cs;
  const long long nbF = ceil_div(tilesF, a.cs / a.sF) * a.cs;
  if (nbF + nbP > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.nbP = static_cast<int>(nbP);
  a.by_ptiles = make_div(static_cast<int>(ceil_div(N, 32 * a.wp)));
  a.by_mtiles = make_div(static_cast<int>(ceil_div(M, a.wm)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nbP + nbF));
  cfg.blockDim = dim3(TPB);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  const bool cl = a.cs > 1;
  e = need_pts ? (cl ? cudaLaunchKernelEx(&cfg, epi_bwd_kernel<true, true>, a)
                     : cudaLaunchKernelEx(&cfg, epi_bwd_kernel<true, false>, a))
               : (cl ? cudaLaunchKernelEx(&cfg, epi_bwd_kernel<false, true>, a)
                     : cudaLaunchKernelEx(&cfg, epi_bwd_kernel<false, false>, a));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
