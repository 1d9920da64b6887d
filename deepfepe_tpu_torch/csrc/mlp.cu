// Fused PointNet weight MLP, forward (K2) and backward (K2b), for Hopper.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// deepfepe_tpu/ops/pallas/mlp_pallas.py (wrapper `fused_pointnet_mlp`,
// `_fwd_rule`, `_bwd_rule`). The network is the ErrorEstimator stack:
// L hidden layers of Dense -> InstanceNorm (over the N points of one item)
// -> affine -> LeakyReLU, then a final Dense. Matrix products take bf16
// inputs and sum exact products in f32; the hidden Dense biases are never
// read (InstanceNorm cancels them).
//
// What bounds it. At the main path's shapes (B = 8 items, N = 1000 points,
// widths C_in -> 64 -> 128 -> 1024 -> 512 -> 256 -> 1) one forward is
// 2 B N sum(C_i C_{i+1}) = 12.7 GFLOP of bf16 products, 12.9 us at the
// card's 989 TFLOP/s, against a few MB of inputs and outputs (about 1 us
// at 3.35 TB/s): bound by operations. The backward recomputes the forward
// and adds the weight-gradient and input-gradient products, about three
// times that: 38 GFLOP, 38.6 us.
//
// Design. The TPU kernel holds one item's whole stack in ~100 MB of VMEM,
// so its InstanceNorm is a local sum. An SM has 227 KB, so here every
// product is a launch of `gemm_kernel`, and the statistics of a layer need
// one short pass across its tiles before the next layer can normalise:
//   * gemm_kernel: two warpgroups a block, a 128-row output tile of 64,
//     128 or 256 columns (a 64-row half a warpgroup, both reading the
//     same B, which halves its L2 traffic a row), `wgmma.m64n64k16` bf16
//     products with f32 accumulators, the operands brought by TMA
//     (128-byte swizzle) into a ring of three or four 64-deep stages, each
//     guarded by an mbarrier; a stage's prologue runs while the previous
//     stage's products are in flight. Operands read along their rows use
//     wgmma's MN-major (transposed) layouts.
//   * What a stage does before its products (the prologue):
//       A_BF16  nothing (the first layer's bf16 x, padded to 16 columns);
//       A_NORM  normalise on load: y = bf16(LeakyReLU(h * scale + shift))
//               from the previous layer's f32 h, written as the stage's
//               bf16 A box over its h boxes; in the backward's recompute
//               the column-0 blocks also write y and xhat = bf16((h -
//               mean) * inv), the stashes the backward reads;
//       A_DH    the weight gradient's dh = bf16(bf16(bf16(dz * a) -
//               bf16(xhat * c2)) - c1), formed in place of the dz box
//               from the dz and xhat boxes; the column-0 blocks also write
//               it, once, for the input gradient's product to read.
//   * What a tile does with its accumulators (the epilogue), staged in
//     shared memory:
//       E_STATS the forward: h (f32), and per item of each 64-row tile
//               the sums of bf16(h) and of bf16(bf16(h)^2) over its rows;
//               a tile that straddles two items splits its sums there;
//       E_DZ    the backward's dy = dh W: dz from bf16(dy), xhat, gamma
//               and beta, and per item and 64-row tile the sums r1 = sum
//               dz and r2 = sum bf16(dz * xhat), so dy is never stored;
//       E_STORE f32 out (dx; the weight gradient's row-split partials).
//   * fold_kernel: per (item, channel) the tiles' partial sums in tile
//     order, giving the forward's scale and shift (and mean, inv) or the
//     backward's a, c1, c2 and the item sums r1, r2; the same launch adds
//     row-split partials in split order (the weight gradients) and a
//     layer's item sums in item order (dbeta and dgamma).
//   * final passes: the last hidden layer normalised on load and dotted
//     with Wf (+ bf) per row (forward), or giving xhat, dy = g Wf, dz, the
//     r sums and the Wf and bf gradients' per-tile sums (backward).
// Launches: forward 1 + 2 L + 1 (a pack of x and every weight to bf16,
// a product and a fold per layer, the final pass); backward 3 + 5 L (the
// recompute, the top pass and its fold, then per layer the dW product,
// the dy product and a fold).
// Every sum runs in a fixed order (no atomics): results repeat bit for bit.
// Rounding points mirror the TPU kernel: h is rounded to bf16 only for the
// statistics; z uses the f32 h; y, xhat, dz, dh and the backward's
// transients are bf16; the backward's ReLU mask comes from
// zb = bf16(bf16(xhat * bf16(gamma)) + bf16(beta)); r1, r2 and the weight
// gradients are f32 sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;            // rows of a warpgroup's output tile: wgmma's M
constexpr int BM = 2 * TM;        // rows of a block's tile: two warpgroups
constexpr int TK = 64;            // depth of a stage: one 128-byte row of bf16
constexpr int THREADS = 256;      // two warpgroups
constexpr int RING_BYTES = 200 * 1024;  // the TMA ring's budget of shared memory
constexpr int BOX = 8192;         // bytes of a [64][64] bf16 or [64][32] f32 box
constexpr int LDS_PAD = 8;        // padding of a staged output row, in elements
constexpr int FOLD_THREADS = 1024;
constexpr int ROW_THREADS = 256;  // final forward pass: a warp a row
constexpr int MAX_SEG = 16;
constexpr int MAX_LAST = 1024;    // widest last hidden layer of the final passes
constexpr float IN_EPS = 1e-5f;
constexpr int ERR_TENSOR_MAP = 9001;  // cuTensorMapEncodeTiled missing or refused

enum AMode { A_BF16 = 0, A_NORM = 1, A_DH = 2 };
enum EMode { E_STATS = 0, E_DZ = 1, E_STORE = 2 };

// Bytes of a stage's A boxes, all brought by TMA: A_BF16 one [128][64]
// bf16 box; A_NORM two f32 boxes [128][32], the bf16 A written over the
// first; A_DH the dz boxes [64 rows][64 channels] of both warpgroups (dh
// written over them), then their xhat boxes.
template <int AM>
__host__ __device__ constexpr int a_bytes() {
  return AM == A_BF16 ? 2 * BOX : 4 * BOX;
}
template <int AM, int NB>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<AM>() + NB * BOX;
}
template <int AM, int NB>
__host__ __device__ constexpr int stages() {
  return RING_BYTES / stage_bytes<AM, NB>() < 4 ? RING_BYTES / stage_bytes<AM, NB>() : 4;
}
template <int AM, int NB>
__host__ __device__ constexpr int smem_bytes() {
  return stages<AM, NB>() * stage_bytes<AM, NB>() + 1024;
}

struct GemmParams {
  int M, N, K;      // output rows and columns, depth
  int kt_split;     // 64-deep stages a blockIdx.z takes
  int Nn, slots;    // points an item; item slots of a 64-row tile
  float slope;
  // prologue: the data rows and channels of the operand it forms
  int prow, pch;
  const float* scale;  // A_NORM: per (item, channel), [items][pch]
  const float* shift;
  const float* mean;
  const float* inv;
  bf16* stash_y;       // A_NORM in the recompute: [prow][pch]
  bf16* stash_xhat;
  const float* ab;     // A_DH: per (item, channel), [items][pch]
  const float* c1b;
  const float* c2b;
  bf16* stash_dh;      // A_DH: dh [prow][pch], written by the column-0 blocks
  // epilogue
  float* out;          // E_STATS: h [M][N]; E_STORE: out [splits][M][ldo]
  int ldo;
  long long split_stride;
  float* part1;        // E_STATS, E_DZ: [tiles][slots][N]
  float* part2;
  bf16* dz;            // E_DZ: dz [M][N] out, xhat [M][N] in, gamma, beta [N]
  const bf16* xhat;
  const float* gamma;
  const float* beta;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const float2 a = unpack2(u.x), b = unpack2(u.y), c = unpack2(u.z), d = unpack2(u.w);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y; v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float leaky(float z, float slope) { return z >= 0.0f ? z : slope * z; }

// dz from the upstream gradient dy (f32, rounded to bf16 here) and the
// mask of zb = bf16(bf16(xhat * bf16(gamma)) + bf16(beta)) >= 0.
__device__ __forceinline__ float leaky_grad(float dy, float xh, float gb, float bb, float sl) {
  const float d = round_bf16(dy);
  const float zb = round_bf16(round_bf16(xh * gb) + bb);
  return zb >= 0.0f ? d : round_bf16(sl * d);
}

// Byte offset of the 16-byte chunk `chunk` of row r in a box written by
// TMA with the 128-byte swizzle (rows of 128 bytes, the box 1024-aligned).
__device__ __forceinline__ int swz(int r, int chunk) { return r * 128 + ((chunk ^ (r & 7)) << 4); }

// --- Hopper primitives (PTX) ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for phase `parity` of a stage's barrier. A load that never lands
// traps after about 4 s instead of hanging the stream.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(a, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One box of a 2-D tensor map into shared memory; completion is counted
// on `bar` in bytes. c0 is the column (innermost) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64x64] += A[64x16] B[16x64], bf16 from shared memory, f32 in registers.
// TA / TB: the operand is MN-major (transposed) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, %36, %37, %38;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(1), "n"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

template <int NB>
__device__ __forceinline__ void keep(float (&acc)[NB][32]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(acc[j][q])::"memory");
}

// --- Prologues ----------------------------------------------------------------

// A thread of a prologue forms the 16-byte chunk j = tid % 8 (8 channels)
// of rows tid / 8 + 16 it, it < 4, and keeps its item's per-channel
// constants until the item changes.
struct NormConsts {
  int item;
  float sc[8], sh[8], mu[8], iv[8];
};
struct DhConsts {
  int item;
  float a[8], c1[8], c2[8];
};

__device__ __forceinline__ void fetch_norm(const GemmParams& p, NormConsts& k, int item, int c,
                                           bool stash) {
  if (item == k.item) return;
  k.item = item;
  const long long pi = static_cast<long long>(item) * p.pch + c;
  load8(p.scale + pi, k.sc);
  load8(p.shift + pi, k.sh);
  if (stash) {
    load8(p.mean + pi, k.mu);
    load8(p.inv + pi, k.iv);
  }
}

__device__ __forceinline__ void fetch_dh(const GemmParams& p, DhConsts& k, int item, int c) {
  if (item == k.item) return;
  k.item = item;
  const long long pi = static_cast<long long>(item) * p.pch + c;
  load8(p.ab + pi, k.a);
  load8(p.c1b + pi, k.c1);  // c1 of the row's item
  load8(p.c2b + pi, k.c2);  // c2 of the row's item
}

// y = bf16(LeakyReLU(h * scale + shift)) of one stage, data rows row0..+127
// and channels c0..c0+63, from the two f32 boxes at `box` (channels
// c0..+31, then c0+32..+63) into the bf16 A box written over the first;
// zero outside prow x pch. With `stash`, also y and xhat = bf16((h - mean)
// * inv) into [prow][pch]. A thread forms the 16-byte chunk j = tid % 8 of
// rows tid / 8 + 32 it, it < 4.
__device__ __forceinline__ void norm_on_load(const GemmParams& p, unsigned char* box, int row0,
                                             int c0, bool stash, NormConsts& k) {
  const int j = threadIdx.x & 7, rb = threadIdx.x >> 3;
  const int c = c0 + 8 * j, q = (j & 3) * 2;
  const unsigned char* src = box + (j >> 2) * 2 * BOX;
  float hv[4][8];
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = rb + 32 * it;
    const float4 h0 = *reinterpret_cast<const float4*>(src + swz(r, q));
    const float4 h1 = *reinterpret_cast<const float4*>(src + swz(r, q + 1));
    hv[it][0] = h0.x; hv[it][1] = h0.y; hv[it][2] = h0.z; hv[it][3] = h0.w;
    hv[it][4] = h1.x; hv[it][5] = h1.y; hv[it][6] = h1.z; hv[it][7] = h1.w;
  }
  __syncthreads();  // every thread holds its h before A overwrites the boxes
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = rb + 32 * it, row = row0 + r;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.prow && c < p.pch) {
      fetch_norm(p, k, row / p.Nn, c, stash);
      float yv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) yv[e] = leaky(hv[it][e] * k.sc[e] + k.sh[e], p.slope);
      y = pack8(yv);
      if (stash) {
        float xv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = (hv[it][e] - k.mu[e]) * k.iv[e];
        const long long o = static_cast<long long>(row) * p.pch + c;
        *reinterpret_cast<uint4*>(p.stash_y + o) = y;
        *reinterpret_cast<uint4*>(p.stash_xhat + o) = pack8(xv);
      }
    }
    *reinterpret_cast<uint4*>(box + swz(r, j)) = y;
  }
}

// dh = bf16(bf16(bf16(dz * a) - bf16(xhat * c2)) - c1) of one stage, data
// rows row0..+63 and channels c0..c0+127 (box b of `dz` and `xh` holding
// channels c0 + 64 b..+63), in place of the dz boxes; zero outside prow x
// pch. With `stash`, also dh into [prow][pch]. A thread forms the chunk j
// = tid % 8 of box (tid / 8) % 2, rows tid / 16 + 16 it, it < 4.
__device__ __forceinline__ void dh_on_load(const GemmParams& p, unsigned char* dz,
                                           const unsigned char* xh, int row0, int c0,
                                           bool stash, DhConsts& k) {
  const int j = threadIdx.x & 7, b = (threadIdx.x >> 3) & 1, rb = threadIdx.x >> 4;
  const int c = c0 + 64 * b + 8 * j;
  unsigned char* dzb = dz + b * BOX;
  const unsigned char* xhb = xh + b * BOX;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = rb + 16 * it, row = row0 + r;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.prow && c < p.pch) {
      fetch_dh(p, k, row / p.Nn, c);
      float dv[8], xv[8], dh[8];
      unpack8(*reinterpret_cast<const uint4*>(dzb + swz(r, j)), dv);
      unpack8(*reinterpret_cast<const uint4*>(xhb + swz(r, j)), xv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dh[e] = round_bf16(round_bf16(dv[e] * k.a[e]) - round_bf16(xv[e] * k.c2[e])) - k.c1[e];
      o = pack8(dh);
      if (stash)
        *reinterpret_cast<uint4*>(p.stash_dh + static_cast<long long>(row) * p.pch + c) = o;
    }
    *reinterpret_cast<uint4*>(dzb + swz(r, j)) = o;
  }
}

// --- The product ----------------------------------------------------------

// Per item of the 64-row tile `tile` (rows m0.., rend of them; the tile's
// rows r of each item are [ra, rb)): f(item, ra, rb) -> (s1, s2), written
// to the partials at the item's slot.
template <class F>
__device__ __forceinline__ void item_sums(const GemmParams& p, int tile, int m0, int rend,
                                          int col, F f) {
  const int first = m0 / p.Nn;
  float s1 = 0.0f, s2 = 0.0f;
  for (int item = first, ra = 0; ra < rend; ++item) {  // the tile's rows of each item
    const int rb = min(rend, (item + 1) * p.Nn - m0);
    s1 = 0.0f;  s2 = 0.0f;  // the next item's statistics start here
    f(ra, rb, s1, s2);
    const long long q = (static_cast<long long>(tile) * p.slots + item - first) * p.N + col;
    p.part1[q] = s1;
    p.part2[q] = s2;
    ra = rb;
  }
}

// out tile [128 x 64 NB] at (blockIdx.y, blockIdx.x) over the depth stages
// of blockIdx.z: warpgroup w the rows 64 w..+63, both the same B. Operand
// boxes a stage: A_BF16 [A]; A_NORM [h lo -> A][h hi]; A_DH [dz 0 -> dh 0]
// [dz 1 -> dh 1][xhat 0][xhat 1]; then B, NB boxes. A is [rows][k]
// (K-major) or, for A_DH, [k][channels] (MN-major); B is [n][k] in one box
// of 64 NB rows or, with TB, NB boxes [k][64 n]. The epilogue's per-item
// sums are per 64-row tile, 2 blockIdx.y + w.
template <int AM, bool TB, int EP, int NB>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_b, const GemmParams p) {
  constexpr bool TA = AM == A_DH;
  constexpr int BN = 64 * NB;
  constexpr int STAGES = stages<AM, NB>();
  constexpr int SB = stage_bytes<AM, NB>();
  constexpr int LDC = BN + LDS_PAD;  // f32 staging; E_DZ stages bf16(dy)
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert((EP == E_DZ ? BM * LDC * 2 + BM * BN * 2 : BM * LDC * 4) <= STAGES * SB,
                "the epilogue's staging does not fit in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[STAGES];

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * p.kt_split;
  const int KT = min(p.kt_split, (p.K + TK - 1) / TK - kt0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int i) {
    const int s = i % STAGES;
    unsigned char* st = smem + s * SB;
    const int k0 = (kt0 + i) * TK;
    mbar_expect(&full[s], SB);
    if constexpr (AM == A_BF16) {
      tma_load(st, &map_a, &full[s], k0, m0);
    } else if constexpr (AM == A_NORM) {
      tma_load(st, &map_a, &full[s], k0, m0);
      tma_load(st + 2 * BOX, &map_a, &full[s], k0 + 32, m0);
    } else {  // boxes of [data rows k][channels]
      tma_load(st, &map_a, &full[s], m0, k0);
      tma_load(st + BOX, &map_a, &full[s], m0 + TM, k0);
      tma_load(st + 2 * BOX, &map_x, &full[s], m0, k0);
      tma_load(st + 3 * BOX, &map_x, &full[s], m0 + TM, k0);
    }
    unsigned char* sb = st + a_bytes<AM>();
    if constexpr (TB) {
#pragma unroll
      for (int j = 0; j < NB; ++j) tma_load(sb + j * BOX, &map_b, &full[s], n0 + 64 * j, k0);
    } else {
      tma_load(sb, &map_b, &full[s], k0, n0);
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(STAGES, KT); ++i) load_stage(i);

  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[j][q] = 0.0f;

  NormConsts kn;
  DhConsts kd;
  kn.item = -1;
  kd.item = -1;  // the dW product's channels stay: its constants live across stages
  for (int i = 0; i < KT; ++i) {
    const int s = i % STAGES;
    unsigned char* st = smem + s * SB;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const int k0 = (kt0 + i) * TK;
    if constexpr (AM == A_NORM) {
      kn.item = -1;
      norm_on_load(p, st, m0, k0, p.stash_y != nullptr && blockIdx.x == 0, kn);
    }
    if constexpr (AM == A_DH)  // the dW product: A = dh^T, [data rows k][channels m]
      dh_on_load(p, st, st + 2 * BOX, k0, m0, p.stash_dh != nullptr && blockIdx.x == 0, kd);
    if constexpr (AM != A_BF16) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
    const unsigned char* sa = st + wg * BOX;  // this warpgroup's 64 rows of A
    const unsigned char* sb = st + a_bytes<AM>();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = TA ? sdesc(sa + 2048 * kk, BOX, 1024) : sdesc(sa + 32 * kk, 16, 1024);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint64_t db = TB ? sdesc(sb + j * BOX + 2048 * kk, BOX, 1024)
                               : sdesc(sb + j * BOX + 32 * kk, 16, 1024);
        wgmma_64<TA ? 1 : 0, TB ? 1 : 0>(acc[j], da, db);
      }
    }
    wg_commit();
    // The previous stage's products are done; this stage's run on. (ptxas
    // serialises the normalising kernels' wgmma, so they wait for all.)
    if constexpr (AM == A_NORM)
      wg_wait0();
    else
      wg_wait1();
    __syncthreads();  // every warp is done with the previous stage
    if (tid == 0 && i >= 1 && i - 1 + STAGES < KT) load_stage(i - 1 + STAGES);
  }
  wg_wait0();
  keep(acc);
  // wg_wait0 waits for this warpgroup's products only: the staging below
  // overwrites the ring, which the other warpgroup's last products may
  // still be reading.
  __syncthreads();

  // Stage the accumulators: warp w of warpgroup wg holds rows 64 wg + 16 w
  // + g and + 8, columns 64j + 8q + 2t and + 1 (g = lane / 4, t = lane % 4).
  float* cs = reinterpret_cast<float*>(smem);
  bf16* cs16 = reinterpret_cast<bf16*>(smem);
  {
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r = TM * wg + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 64 * j + 8 * q + 2 * t;
        if constexpr (EP == E_DZ) {
          *reinterpret_cast<uint32_t*>(cs16 + r * LDC + col) = pack2(acc[j][4 * q], acc[j][4 * q + 1]);
          *reinterpret_cast<uint32_t*>(cs16 + (r + 8) * LDC + col) =
              pack2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
        } else {
          *reinterpret_cast<float2*>(cs + r * LDC + col) = make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
          *reinterpret_cast<float2*>(cs + (r + 8) * LDC + col) =
              make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
        }
      }
  }
  const int rend = min(BM, p.M - m0);
  bf16* xs = reinterpret_cast<bf16*>(smem + BM * LDC * 2);  // E_DZ: the xhat tile
  if constexpr (EP == E_DZ) {
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rend && n0 + c < p.N)
        v = __ldg(reinterpret_cast<const uint4*>(p.xhat + static_cast<long long>(m0 + r) * p.N + n0 + c));
      *reinterpret_cast<uint4*>(xs + r * BN + c) = v;
    }
  }
  __syncthreads();

  if constexpr (EP == E_STORE) {
    float* o = p.out + blockIdx.z * p.split_stride;
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      if (r < rend && n0 + c < p.N)
        o[static_cast<long long>(m0 + r) * p.ldo + n0 + c] = cs[r * LDC + c];
    }
  } else if constexpr (EP == E_STATS) {
    for (int i = tid; i < BM * BN / 4; i += THREADS) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      if (r < rend && n0 + c < p.N)
        *reinterpret_cast<float4*>(p.out + static_cast<long long>(m0 + r) * p.ldo + n0 + c) =
            *reinterpret_cast<const float4*>(cs + r * LDC + c);
    }
    // Per 64-row tile h and column: the sums of bf16(h) and bf16(h)^2.
    for (int w = tid; w < 2 * BN; w += THREADS) {
      const int h = w / BN, c = w % BN;
      const int col = n0 + c, r0 = TM * h;
      if (col >= p.N || r0 >= rend) continue;
      const float* hc = cs + r0 * LDC + c;
      item_sums(p, 2 * blockIdx.y + h, m0 + r0, min(TM, rend - r0), col,
                [&](int ra, int rb, float& s1, float& s2) {
#pragma unroll 8
                  for (int r = ra; r < rb; ++r) {
                    const float v = round_bf16(hc[r * LDC]);
                    s1 += v;
                    s2 += round_bf16(v * v);
                  }
                });
    }
  } else {  // E_DZ: dz over the xhat tile, then stored 16 bytes a thread
    const float sl = round_bf16(p.slope);
    for (int w = tid; w < 2 * BN; w += THREADS) {
      const int h = w / BN, c = w % BN;
      const int col = n0 + c, r0 = TM * h;
      if (col >= p.N || r0 >= rend) continue;
      const float gb = round_bf16(p.gamma[col]), bb = round_bf16(p.beta[col]);
      const bf16* dyc = cs16 + r0 * LDC + c;
      bf16* xc = xs + r0 * BN + c;
      item_sums(p, 2 * blockIdx.y + h, m0 + r0, min(TM, rend - r0), col,
                [&](int ra, int rb, float& r1, float& r2) {
#pragma unroll 8
                  for (int r = ra; r < rb; ++r) {
                    const float xh = __bfloat162float(xc[r * BN]);
                    const float d = leaky_grad(__bfloat162float(dyc[r * LDC]), xh, gb, bb, sl);
                    xc[r * BN] = __float2bfloat16(d);
                    r1 += d;
                    r2 += round_bf16(d * xh);
                  }
                });
    }
    __syncthreads();
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      if (r < rend && n0 + c < p.N)
        *reinterpret_cast<uint4*>(p.dz + static_cast<long long>(m0 + r) * p.N + n0 + c) =
            *reinterpret_cast<const uint4*>(xs + r * BN + c);
    }
  }
}

// --- Folds ----------------------------------------------------------------

struct SplitJob {
  const float* src;  // [n][E]
  float* dst;        // [E]
  long long E;
  int n, warp_mode, blocks;
};

struct FoldParams {
  int mode;  // 0: forward statistics, 1: backward constants, -1: none
  const float* p1;
  const float* p2;
  const float* gamma;
  const float* beta;
  const float* inv;
  float* o0;  // mode 0: mean, inv, scale, shift; mode 1: a, c1, c2
  float* o1;
  float* o2;
  float* o3;
  float* rsum;  // mode 1: [items][2 C], r1 then r2 of each item
  int B, Nn, C, slots, stat_blocks;
  SplitJob job[2];
};

// Per (item b, channel c): the partial sums of the tiles that hold b's
// rows. A block is 32 channels of one item; lane ty of a channel adds the
// tiles t0 + ty, t0 + ty + 32, ... and the lanes are added in order (tile
// order when an item spans at most 32 tiles, N <= 1985).
__device__ __forceinline__ void fold_items(const FoldParams& p, int blk) {
  __shared__ float red[2][32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int cblocks = (p.C + 31) / 32;
  const int b = blk / cblocks, c = (blk % cblocks) * 32 + tx;
  const int t0 = (b * p.Nn) / TM, t1 = ((b + 1) * p.Nn - 1) / TM;
  float s1 = 0.0f, s2 = 0.0f;
  if (c < p.C)
    for (int t = t0 + ty; t <= t1; t += 32) {
      const long long q = (static_cast<long long>(t) * p.slots + b - (t * TM) / p.Nn) * p.C + c;
      s1 += p.p1[q];
      s2 += p.p2[q];
    }
  red[0][ty][tx] = s1;
  red[1][ty][tx] = s2;
  __syncthreads();
  if (ty != 0 || c >= p.C) return;
  s1 = 0.0f;
  s2 = 0.0f;
  for (int k = 0; k < 32; ++k) {
    s1 += red[0][k][tx];
    s2 += red[1][k][tx];
  }
  const long long e = static_cast<long long>(b) * p.C + c;
  if (p.mode == 0) {
    const float m = s1 / p.Nn;
    const float var = fmaxf(s2 / p.Nn - m * m, 0.0f);
    const float iv = 1.0f / sqrtf(var + IN_EPS);
    const float sc = p.gamma[c] * iv;
    if (p.o0) p.o0[e] = m;
    if (p.o1) p.o1[e] = iv;
    p.o2[e] = sc;
    p.o3[e] = p.beta[c] - m * sc;
  } else {
    const float a = p.gamma[c] * p.inv[e];
    p.o0[e] = round_bf16(a);
    p.o1[e] = round_bf16(a * (s1 / p.Nn));
    p.o2[e] = round_bf16(a * (s2 / p.Nn));
    p.rsum[2 * static_cast<long long>(b) * p.C + c] = s1;
    p.rsum[(2 * static_cast<long long>(b) + 1) * p.C + c] = s2;
  }
}

// dst[e] = sum over z of src[z E + e]: a thread an element, z in order;
// or (warp_mode) a warp an element, lanes over z and a fixed shuffle tree.
__device__ __forceinline__ void split_sum(const SplitJob& j, int blk) {
  if (j.warp_mode) {
    const long long e = static_cast<long long>(blk) * (FOLD_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    float s = 0.0f;
    if (e < j.E)
      for (int z = lane; z < j.n; z += 32) s += j.src[z * j.E + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (e < j.E && lane == 0) j.dst[e] = s;
  } else {
    const long long e = static_cast<long long>(blk) * FOLD_THREADS + threadIdx.x;
    if (e >= j.E) return;
    float s = 0.0f;
#pragma unroll 4
    for (int z = 0; z < j.n; ++z) s += j.src[z * j.E + e];
    j.dst[e] = s;
  }
}

__global__ void __launch_bounds__(FOLD_THREADS) fold_kernel(const FoldParams p) {
  int blk = blockIdx.x;
  if (blk < p.stat_blocks) {
    fold_items(p, blk);
    return;
  }
  blk -= p.stat_blocks;
  for (int j = 0; j < 2; ++j) {
    if (blk < p.job[j].blocks) {
      split_sum(p.job[j], blk);
      return;
    }
    blk -= p.job[j].blocks;
  }
}

// --- Pack, final passes -----------------------------------------------------

struct PackParams {
  const float* src[MAX_SEG];
  bf16* dst[MAX_SEG];
  int rows[MAX_SEG], scols[MAX_SEG], dcols[MAX_SEG];
};

// dst[k] [rows][dcols] = bf16(src[k] [rows][scols]), zero in the padded
// columns; segment k = blockIdx.y.
__global__ void pack_kernel(const PackParams p) {
  const int k = blockIdx.y;
  const int dc = p.dcols[k], sc = p.scols[k];
  const long long total = static_cast<long long>(p.rows[k]) * dc;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long r = i / dc;
    const int c = static_cast<int>(i - r * dc);
    p.dst[k][i] = __float2bfloat16(c < sc ? p.src[k][r * sc + c] : 0.0f);
  }
}

// logits[row] = y[row] . Wf[o] + bf[o], y = bf16(LeakyReLU(h scale + shift))
// of the last hidden layer: a warp a row, lanes over channels.
__global__ void __launch_bounds__(ROW_THREADS)
    final_fwd_kernel(const float* __restrict__ h, const float* __restrict__ scale,
                     const float* __restrict__ shift, const bf16* __restrict__ wf,
                     const float* __restrict__ bias, float* __restrict__ out, int M, int C,
                     int n_out, int Nn, float slope) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const long long pb = static_cast<long long>(row / Nn) * C;
  float y[MAX_LAST / 32];
#pragma unroll
  for (int i = 0; i < MAX_LAST / 128; ++i) {
    const int c = 4 * (lane + 32 * i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), sc = v, sh = v;
    if (c < C) {
      v = __ldg(reinterpret_cast<const float4*>(h + static_cast<long long>(row) * C + c));
      sc = __ldg(reinterpret_cast<const float4*>(scale + pb + c));
      sh = __ldg(reinterpret_cast<const float4*>(shift + pb + c));
    }
    y[4 * i] = round_bf16(leaky(v.x * sc.x + sh.x, slope));
    y[4 * i + 1] = round_bf16(leaky(v.y * sc.y + sh.y, slope));
    y[4 * i + 2] = round_bf16(leaky(v.z * sc.z + sh.z, slope));
    y[4 * i + 3] = round_bf16(leaky(v.w * sc.w + sh.w, slope));
  }
  for (int o = 0; o < n_out; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_LAST / 128; ++i) {
      const int c = 4 * (lane + 32 * i);
      if (c < C) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(wf + static_cast<long long>(o) * C + c));
        const float2 w01 = unpack2(w.x), w23 = unpack2(w.y);
        s += y[4 * i] * w01.x + y[4 * i + 1] * w01.y + y[4 * i + 2] * w23.x + y[4 * i + 3] * w23.y;
      }
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
    if (lane == 0) out[static_cast<long long>(row) * n_out + o] = s + bias[o];
  }
}

// The backward's top, for the 64-row tile blockIdx.y and the channels
// 64 blockIdx.x..+63 of the last hidden layer: xhat (stash), dy = bf16(g
// Wf), dz, the per-item sums r1 and r2, and the tile's sums of the Wf
// gradient (g^T y) and of the bf gradient (column 0 blocks), one row
// [n_out C + n_out] of part_gf a tile.
__global__ void __launch_bounds__(THREADS)
    final_bwd_kernel(const float* __restrict__ h, const float* __restrict__ mean,
                     const float* __restrict__ inv, const float* __restrict__ scale,
                     const float* __restrict__ shift, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ g,
                     const bf16* __restrict__ wf, bf16* __restrict__ xhat,
                     bf16* __restrict__ dz, float* __restrict__ part1,
                     float* __restrict__ part2, float* __restrict__ part_gf, int M, int C,
                     int n_out, int Nn, int slots, float slope) {
  extern __shared__ float sm[];
  float* hs = sm;             // [64][64] h
  float* gs = sm + TM * 64;   // [64][n_out] bf16(g)
  const int tile = blockIdx.y, m0 = tile * TM, c0 = blockIdx.x * 64;
  const int rend = min(TM, M - m0);
  float* gf = part_gf + static_cast<long long>(tile) * (n_out * C + n_out);
  for (int i = threadIdx.x; i < TM * 16; i += THREADS) {
    const int r = i >> 4, q = 4 * (i & 15);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rend && c0 + q < C)
      v = __ldg(reinterpret_cast<const float4*>(h + static_cast<long long>(m0 + r) * C + c0 + q));
    *reinterpret_cast<float4*>(hs + r * 64 + q) = v;
  }
  for (int i = threadIdx.x; i < TM * n_out; i += THREADS) {
    const int r = i / n_out;
    gs[i] = r < rend ? round_bf16(g[static_cast<long long>(m0 + r) * n_out + i % n_out]) : 0.0f;
  }
  __syncthreads();
  const int c = threadIdx.x, col = c0 + c;
  if (c < 64 && col < C) {
    const float gb = round_bf16(gamma[col]), bb = round_bf16(beta[col]), sl = round_bf16(slope);
    const int first = m0 / Nn;
    int item = first, next = (first + 1) * Nn;
    long long pi = static_cast<long long>(item) * C + col;
    float mu = mean[pi], iv = inv[pi], r1 = 0.0f, r2 = 0.0f;
    for (int r = 0; r < rend; ++r) {
      if (m0 + r == next) {
        const long long q = (static_cast<long long>(tile) * slots + item - first) * C + col;
        part1[q] = r1;
        part2[q] = r2;
        r1 = 0.0f;
        r2 = 0.0f;
        ++item;
        next += Nn;
        pi += C;
        mu = mean[pi];
        iv = inv[pi];
      }
      const long long e = static_cast<long long>(m0 + r) * C + col;
      const float xh = round_bf16((hs[r * 64 + c] - mu) * iv);
      xhat[e] = __float2bfloat16(xh);
      float d = 0.0f;
      for (int o = 0; o < n_out; ++o)
        d += gs[r * n_out + o] * __bfloat162float(wf[static_cast<long long>(o) * C + col]);
      const float dzv = leaky_grad(d, xh, gb, bb, sl);
      dz[e] = __float2bfloat16(dzv);
      r1 += dzv;
      r2 += round_bf16(dzv * xh);
    }
    const long long q = (static_cast<long long>(tile) * slots + item - first) * C + col;
    part1[q] = r1;
    part2[q] = r2;
    for (int o = 0; o < n_out; ++o) {  // this tile's sum of g[:, o] y[:, col]
      item = first;
      next = (first + 1) * Nn;
      pi = static_cast<long long>(item) * C + col;
      float sc = scale[pi], sh = shift[pi], s = 0.0f;
      for (int r = 0; r < rend; ++r) {
        if (m0 + r == next) {
          ++item;
          next += Nn;
          pi += C;
          sc = scale[pi];
          sh = shift[pi];
        }
        s += gs[r * n_out + o] * round_bf16(leaky(hs[r * 64 + c] * sc + sh, slope));
      }
      gf[static_cast<long long>(o) * C + col] = s;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n_out) {
    float s = 0.0f;
    for (int r = 0; r < rend; ++r) s += gs[r * n_out + threadIdx.x];
    gf[static_cast<long long>(n_out) * C + threadIdx.x] = s;
  }
}

// --- Host side --------------------------------------------------------------

int last_error() { return static_cast<int>(cudaGetLastError()); }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A map of a row-major [rows][cols] matrix of bf16 (or f32) in boxes of
// box_rows rows by 128 bytes of columns, 128-byte swizzle; out-of-bounds
// elements read as zero.
bool tensor_map(CUtensorMap* m, const void* base, bool f32, long long rows, long long cols,
                int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int esz = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esz), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int AM, bool TB, int EP, int NB>
int launch_gemm(const CUtensorMap& a, const CUtensorMap& x, const CUtensorMap& b,
                const GemmParams& p, dim3 grid, cudaStream_t s) {
  constexpr int bytes = smem_bytes<AM, NB>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<AM, TB, EP, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  gemm_kernel<AM, TB, EP, NB><<<grid, THREADS, bytes, s>>>(a, x, b, p);
  return last_error();
}

// Output tile width: 64, 128 or 256 columns.
int nb_for(int n) { return n > 128 ? 4 : n > 64 ? 2 : 1; }

template <int AM, bool TB, int EP>
int gemm(int nb, const CUtensorMap& a, const CUtensorMap& x, const CUtensorMap& b,
         const GemmParams& p, int grid_z, cudaStream_t s) {
  const dim3 grid((p.N + 64 * nb - 1) / (64 * nb), (p.M + BM - 1) / BM, grid_z);
  if (nb == 1) return launch_gemm<AM, TB, EP, 1>(a, x, b, p, grid, s);
  if (nb == 2) return launch_gemm<AM, TB, EP, 2>(a, x, b, p, grid, s);
  return launch_gemm<AM, TB, EP, 4>(a, x, b, p, grid, s);
}

}  // namespace

// Every function launches on `stream`, allocates nothing and returns
// cudaGetLastError() after its launch (ERR_TENSOR_MAP when a tensor map
// could not be made). Tensors are contiguous device buffers, 16-byte
// aligned; bf16 is __nv_bfloat16. "Items" are B runs of Nn rows.

// segs: nseg x {src f32 [rows][scols], dst bf16 [rows][dcols], rows,
// scols, dcols}, a host array; one launch casts and pads them all.
extern "C" int mlp_pack(const long long* segs, int nseg, void* stream) {
  if (nseg < 1 || nseg > MAX_SEG) return static_cast<int>(cudaErrorInvalidValue);
  PackParams p{};
  long long most = 1;
  for (int k = 0; k < nseg; ++k) {
    p.src[k] = reinterpret_cast<const float*>(segs[5 * k]);
    p.dst[k] = reinterpret_cast<bf16*>(segs[5 * k + 1]);
    p.rows[k] = static_cast<int>(segs[5 * k + 2]);
    p.scols[k] = static_cast<int>(segs[5 * k + 3]);
    p.dcols[k] = static_cast<int>(segs[5 * k + 4]);
    const long long n = segs[5 * k + 2] * segs[5 * k + 4];
    most = n > most ? n : most;
  }
  const long long blocks = (most + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), nseg);
  pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return last_error();
}

// One hidden layer's product h [M][N] = A W^T with W bf16 [N][K] and A
// either the bf16 [M][K] x (scale null) or the previous layer's f32 h
// [M][K] normalised on load with scale and shift [items][K]; with stash_y
// and stash_xhat (and mean, inv) also y and xhat of that layer, bf16
// [M][K]. Writes h and the tiles' statistics partials [tiles][slots][N].
extern "C" int mlp_gemm_fwd(const void* a, const float* scale, const float* shift,
                            const float* mean, const float* inv, void* stash_y, void* stash_xhat,
                            const void* w, float* h, float* part1, float* part2, int M, int N,
                            int K, int Nn, int slots, float slope, void* stream) {
  GemmParams p{};
  p.M = M; p.N = N; p.K = K; p.kt_split = (K + TK - 1) / TK; p.Nn = Nn; p.slots = slots;
  p.slope = slope; p.prow = M; p.pch = K;
  p.scale = scale; p.shift = shift; p.mean = mean; p.inv = inv;
  p.stash_y = static_cast<bf16*>(stash_y); p.stash_xhat = static_cast<bf16*>(stash_xhat);
  p.out = h; p.ldo = N; p.part1 = part1; p.part2 = part2;
  const int nb = nb_for(N);
  const bool norm = scale != nullptr;
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, a, norm, M, K, BM) || !tensor_map(&mb, w, false, N, K, 64 * nb))
    return ERR_TENSOR_MAP;
  const auto s = static_cast<cudaStream_t>(stream);
  return norm ? gemm<A_NORM, false, E_STATS>(nb, ma, ma, mb, p, 1, s)
              : gemm<A_BF16, false, E_STATS>(nb, ma, ma, mb, p, 1, s);
}

// mode 0: per (item, channel) of a layer, from its statistics partials:
// o0..o3 = mean, inv, scale = gamma inv, shift = beta - mean scale (o0,
// o1 may be null). mode 1: from its r1, r2 partials and inv: o0..o2 =
// bf16(a), bf16(a r1 / Nn), bf16(a r2 / Nn) with a = gamma inv, and the
// item sums r1, r2 into rsum [items][2 C] (dbeta and dgamma are their
// sums over items: a job of a later fold). mode -1: neither. Then, for
// each job with n > 0: dst[e] = sum over z < n of src[z e_ + e], e < e_.
extern "C" int mlp_fold(int mode, const float* part1, const float* part2, const float* gamma,
                        const float* beta, const float* inv, float* o0, float* o1, float* o2,
                        float* o3, float* rsum, int B, int Nn, int C, int slots,
                        const float* src0, float* dst0, long long e0, int n0, const float* src1,
                        float* dst1, long long e1, int n1, void* stream) {
  FoldParams p{};
  p.mode = mode; p.p1 = part1; p.p2 = part2; p.gamma = gamma; p.beta = beta; p.inv = inv;
  p.o0 = o0; p.o1 = o1; p.o2 = o2; p.o3 = o3; p.rsum = rsum;
  p.B = B; p.Nn = Nn; p.C = C; p.slots = slots;
  p.stat_blocks = mode >= 0 ? (C + 31) / 32 * B : 0;
  const float* srcs[2] = {src0, src1};
  float* dsts[2] = {dst0, dst1};
  const long long es[2] = {e0, e1};
  const int ns[2] = {n0, n1};
  long long blocks = p.stat_blocks;
  for (int j = 0; j < 2; ++j) {
    SplitJob& job = p.job[j];
    job.src = srcs[j]; job.dst = dsts[j]; job.E = es[j]; job.n = ns[j];
    job.warp_mode = ns[j] > 16 && es[j] <= 65536;
    const long long per = job.warp_mode ? FOLD_THREADS / 32 : FOLD_THREADS;
    job.blocks = ns[j] > 0 ? static_cast<int>((es[j] + per - 1) / per) : 0;
    blocks += job.blocks;
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  fold_kernel<<<static_cast<unsigned>(blocks), FOLD_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(p);
  return last_error();
}

// logits [M][n_out] of the last hidden layer's h [M][C] (C <= 1024),
// normalised with scale and shift [items][C], bf16 Wf [n_out][C], bias.
extern "C" int mlp_final_fwd(const float* h, const float* scale, const float* shift,
                             const void* wf, const float* bias, float* out, int M, int C,
                             int n_out, int Nn, float slope, void* stream) {
  if (C > MAX_LAST) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_a_block = ROW_THREADS / 32;
  final_fwd_kernel<<<(M + rows_a_block - 1) / rows_a_block, ROW_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      h, scale, shift, static_cast<const bf16*>(wf), bias, out, M, C, n_out, Nn, slope);
  return last_error();
}

// The backward's top from the last hidden layer's h [M][C], its mean,
// inv, scale, shift [items][C], gamma, beta, the cotangent g f32
// [M][n_out] and bf16 Wf [n_out][C]: xhat and dz bf16 [M][C], the r1, r2
// partials [tiles][slots][C], and a tile's partials of the Wf and bf
// gradients, [tiles][n_out C + n_out].
extern "C" int mlp_final_bwd(const float* h, const float* mean, const float* inv,
                             const float* scale, const float* shift, const float* gamma,
                             const float* beta, const float* g, const void* wf, void* xhat,
                             void* dz, float* part1, float* part2, float* part_gf, int M,
                             int C, int n_out, int Nn, int slots, float slope, void* stream) {
  if (n_out > 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + 63) / 64, (M + TM - 1) / TM);
  const size_t bytes = static_cast<size_t>(TM) * (64 + n_out) * sizeof(float);
  final_bwd_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      h, mean, inv, scale, shift, gamma, beta, g, static_cast<const bf16*>(wf),
      static_cast<bf16*>(xhat), static_cast<bf16*>(dz), part1, part2, part_gf, M, C, n_out,
      Nn, slots, slope);
  return last_error();
}

// A layer's weight gradient, split over row ranges: part[z] [cout][cin] =
// sum over the rows of split z of dh[r]^T x_in[r], dh formed on load from
// dz, xhat bf16 [rows][cout] and ab, c1b, c2b [items][cout] and written
// once into dh bf16 [rows][cout]; x_in bf16 [rows][ldx] (ldx >= cin; the
// first layer's padded x).
extern "C" int mlp_gemm_dw(const void* dz, const void* xhat, const float* ab, const float* c1b,
                           const float* c2b, void* dh, const void* x_in, int ldx, float* part,
                           int rows, int cout, int cin, int Nn, int rows_per_split, int splits,
                           void* stream) {
  if (rows_per_split % TK != 0) return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p{};
  p.M = cout; p.N = cin; p.K = rows; p.kt_split = rows_per_split / TK; p.Nn = Nn;
  p.prow = rows; p.pch = cout; p.ab = ab; p.c1b = c1b; p.c2b = c2b;
  p.stash_dh = static_cast<bf16*>(dh);
  p.out = part; p.ldo = cin; p.split_stride = static_cast<long long>(cout) * cin;
  const int nb = nb_for(cin);
  CUtensorMap ma, mx, mb;
  if (!tensor_map(&ma, dz, false, rows, cout, TK) || !tensor_map(&mx, xhat, false, rows, cout, TK) ||
      !tensor_map(&mb, x_in, false, rows, ldx, TK))
    return ERR_TENSOR_MAP;
  return gemm<A_DH, true, E_STORE>(nb, ma, mx, mb, p, splits, static_cast<cudaStream_t>(stream));
}

// A layer's input gradient dy [rows][cin] = dh W[:, :cin], dh bf16
// [rows][cout] (mlp_gemm_dw's), W bf16 [cout][ldw]. With xhat_prev (the
// layer below's xhat [rows][cin]), dy is rounded to bf16 and the layer
// below's dz (bf16 [rows][cin]) and r1, r2 partials are written; else dy
// is dx, f32.
extern "C" int mlp_gemm_dy(const void* dh, const void* w, int ldw, const void* xhat_prev,
                           const float* gamma_prev, const float* beta_prev, void* dz_prev,
                           float* part1, float* part2, float* dx, int rows, int cout, int cin,
                           int Nn, int slots, float slope, void* stream) {
  GemmParams p{};
  p.M = rows; p.N = cin; p.K = cout; p.kt_split = (cout + TK - 1) / TK; p.Nn = Nn;
  p.slots = slots; p.slope = slope;
  p.out = dx; p.ldo = cin;
  p.dz = static_cast<bf16*>(dz_prev); p.xhat = static_cast<const bf16*>(xhat_prev);
  p.gamma = gamma_prev; p.beta = beta_prev; p.part1 = part1; p.part2 = part2;
  const int nb = nb_for(cin);
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, dh, false, rows, cout, BM) || !tensor_map(&mb, w, false, cout, ldw, TK))
    return ERR_TENSOR_MAP;
  const auto s = static_cast<cudaStream_t>(stream);
  return xhat_prev ? gemm<A_BF16, true, E_DZ>(nb, ma, ma, mb, p, 1, s)
                   : gemm<A_BF16, true, E_STORE>(nb, ma, ma, mb, p, 1, s);
}
