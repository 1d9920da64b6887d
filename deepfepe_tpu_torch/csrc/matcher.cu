// Masked mutual-nearest-neighbour search over unit descriptors (K4), float32.
//
// Replaces the TPU kernel `_matcher_kernel` of
// deepfepe_tpu/ops/pallas/matcher_pallas.py (wrapper `mutual_nn_pallas`).
// For each image pair b it computes, without storing the [K, K] similarity
// to device memory,
//     dot[i, j] = desc1[b, i] . desc2[b, j]
//     nn12[i]   = argmax_j (dot[i, j] + m2[j]),   m = 0 valid, -1e9 invalid
//     nn21[j]   = argmax_i (dot[i, j] + m1[i])
//     dist12[i] = sqrt(max(2 - 2 max_j (dot[i, j] + m2[j]), 0))
// with ties going to the lowest index, as jnp.argmax does. The additive
// mask keeps a valid pair whose best similarity is negative ahead of every
// invalid one. The mutual check and the differentiable scores are left to
// the wrapper (ops/matcher.py) and the caller (frontend/matching.py), as in
// the JAX package.
//
// What bounds it. At the frontend's K = 1000, D = 256 and B = 4 pairs the
// similarity is 2 B K^2 D = 2.05 GFLOP: 31 us at the card's 67 TFLOP/s FP32
// rate, against 8.2 MB of descriptors (2.4 us at 3.35 TB/s), so it is bound
// by FP32 operations; the descriptors stay in the 50 MB L2.
//
// Design. Two launches a call.
// - `mutual_nn_tile_kernel`: a block per (column tile, row tile, pair), 64
//   x 64 similarities (about a thousand blocks at B = 4, K = 1000, one wave
//   at eight blocks an SM). Each of its 64 threads holds an 8 x 8 register
//   tile (rows ty + 8 q, columns tx + 8 k) in float32 FFMA; no TF32, whose
//   ~1e-3 relative error would move argmaxes and dist12. D streams through
//   shared memory in chunks of 16 with `cp.async`, double-buffered, rows
//   padded to 20 floats so that the float4 reads of eight columns hit
//   distinct banks (zero-filled past K and D; 4-byte copies when D is not
//   a multiple of 4). Every similarity is one FMA chain over d ascending,
//   whatever tile it lies in, so duplicated descriptors tie exactly. Both
//   reductions read the same accumulators: the row maxima (nn12) and the
//   column maxima (nn21) of the tile, combined across threads by warp
//   shuffles and shared memory, larger value first and lower index on
//   equal values, and written as (best, index) partials per tile.
// - `mutual_nn_fold_kernel`: a thread per row and per column folds its
//   partials in ascending tile order with a strict >, which keeps ties at
//   the lowest index; it writes nn12, nn21 and dist12. The result is
//   deterministic: no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;          // rows and columns of a similarity tile
constexpr int BK = 16;         // descriptor entries per shared-memory stage
constexpr int LDS = BK + 4;    // padded row stride (80 B): conflict-free float4 reads
constexpr int THREADS = 64;    // 8 x 8 threads, 8 x 8 similarities each
constexpr float NEG = -1e9f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows row0 .. row0 + 63, entries k0 .. k0 + 15 of one pair's [K, D]
// descriptors into dst [64][LDS], zero past K and D.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int row0, int K, int D,
                                           int k0, int tid) {
  if (VEC) {  // D % 4 == 0 and 16-byte aligned rows
#pragma unroll
    for (int i = tid; i < T * BK / 4; i += THREADS) {
      const int r = i / (BK / 4), d = k0 + 4 * (i % (BK / 4));
      const bool ok = row0 + r < K && d < D;
      cp_async16(dst + r * LDS + (d - k0), ok ? src + static_cast<size_t>(row0 + r) * D + d : src,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < T * BK; i += THREADS) {
      const int r = i / BK, d = k0 + i % BK;
      const bool ok = row0 + r < K && d < D;
      cp_async4(dst + r * LDS + (d - k0), ok ? src + static_cast<size_t>(row0 + r) * D + d : src,
                ok ? 4 : 0);
    }
  }
}

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void shfl_best(float& v, int& i, int lanes) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, lanes);
  const int oi = __shfl_xor_sync(0xffffffffu, i, lanes);
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// Partials: p12v/p12i [B, nt, K] hold each row's best (value, column) in
// column tile t; p21v/p21i [B, nt, K] each column's best (value, row) in
// row tile t.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 8)
mutual_nn_tile_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                      const unsigned char* __restrict__ v1, const unsigned char* __restrict__ v2,
                      float* __restrict__ p12v, int* __restrict__ p12i,
                      float* __restrict__ p21v, int* __restrict__ p21i, int K, int D) {
  __shared__ __align__(16) float as[2][T * LDS];
  __shared__ __align__(16) float bs[2][T * LDS];
  __shared__ float red_v[2][T];
  __shared__ int red_i[2][T];
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int r0 = rt * T, c0 = ct * T;
  const size_t pair = static_cast<size_t>(b) * K;
  const float* A = d1 + pair * D;
  const float* Bm = d2 + pair * D;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[q][k] = 0.0f;

  const int nk = max(1, (D + BK - 1) / BK);
  load_chunk<VEC>(as[0], A, r0, K, D, 0, tid);
  load_chunk<VEC>(bs[0], Bm, c0, K, D, 0, tid);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_chunk<VEC>(as[(kc + 1) & 1], A, r0, K, D, (kc + 1) * BK, tid);
      load_chunk<VEC>(bs[(kc + 1) & 1], Bm, c0, K, D, (kc + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = as[kc & 1];
    const float* bt = bs[kc & 1];
#pragma unroll
    for (int d = 0; d < BK; d += 4) {
      float4 av[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        av[q] = *reinterpret_cast<const float4*>(a + (ty + 8 * q) * LDS + d);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + (tx + 8 * k) * LDS + d);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[q][k] = fmaf(av[q].x, bv.x, acc[q][k]);
          acc[q][k] = fmaf(av[q].y, bv.y, acc[q][k]);
          acc[q][k] = fmaf(av[q].z, bv.z, acc[q][k]);
          acc[q][k] = fmaf(av[q].w, bv.w, acc[q][k]);
        }
      }
    }
    __syncthreads();
  }

  // Masks of this thread's columns and rows; out-of-range ones take no part.
  float m2[8], m1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = c0 + tx + 8 * k;
    m2[k] = c < K ? (v2[pair + c] ? 0.0f : NEG) : NAN;
    const int r = r0 + ty + 8 * k;
    m1[k] = r < K ? (v1[pair + r] ? 0.0f : NEG) : NAN;
  }

  // Row maxima: columns ascend within a thread, so a strict > keeps the
  // lowest; then the 8 lanes that share ty (lane bits 0-2).
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float x = acc[q][k] + m2[k];
      if (x > bv) {  // false for out-of-range columns (NaN)
        bv = x;
        bi = c0 + tx + 8 * k;
      }
    }
    shfl_best(bv, bi, 1);
    shfl_best(bv, bi, 2);
    shfl_best(bv, bi, 4);
    const int r = r0 + ty + 8 * q;
    if (tx == 0 && r < K) {
      const size_t at = (static_cast<size_t>(b) * nt + ct) * K + r;
      p12v[at] = bv;
      p12i[at] = bi;
    }
  }

  // Column maxima: rows ascend within a thread; then the 4 lanes of a warp
  // that share tx (lane bits 3-4), then the two warps through shared memory.
  const int warp = tid / 32;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float x = acc[q][k] + m1[q];
      if (x > bv) {  // false for out-of-range rows (NaN)
        bv = x;
        bi = r0 + ty + 8 * q;
      }
    }
    shfl_best(bv, bi, 8);
    shfl_best(bv, bi, 16);
    if ((tid & 31) < 8) {
      red_v[warp][tx + 8 * k] = bv;
      red_i[warp][tx + 8 * k] = bi;
    }
  }
  __syncthreads();
  const int c = c0 + tid;
  if (c < K) {
    float bv = red_v[0][tid];
    int bi = red_i[0][tid];
    if (better(red_v[1][tid], red_i[1][tid], bv, bi)) {
      bv = red_v[1][tid];
      bi = red_i[1][tid];
    }
    const size_t at = (static_cast<size_t>(b) * nt + rt) * K + c;
    p21v[at] = bv;
    p21i[at] = bi;
  }
}

// One thread per (pair, row) for nn12 and dist12, then per (pair, column)
// for nn21: the tile partials in ascending tile order.
__global__ void mutual_nn_fold_kernel(const float* __restrict__ p12v, const int* __restrict__ p12i,
                                      const float* __restrict__ p21v, const int* __restrict__ p21i,
                                      int* __restrict__ nn12, int* __restrict__ nn21,
                                      float* __restrict__ dist12, int B, int K, int nt) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long BK_ = static_cast<long long>(B) * K;
  if (id >= 2 * BK_) return;
  const bool rows = id < BK_;
  const long long e = rows ? id : id - BK_;
  const long long b = e / K, r = e - b * K;
  const float* pv = (rows ? p12v : p21v) + b * nt * K + r;
  const int* pi = (rows ? p12i : p21i) + b * nt * K + r;
  float best = pv[0];
  int arg = pi[0];
  for (int t = 1; t < nt; ++t) {
    const float v = pv[static_cast<long long>(t) * K];
    if (v > best) {  // a later tile wins only by a larger value
      best = v;
      arg = pi[static_cast<long long>(t) * K];
    }
  }
  if (rows) {
    nn12[e] = arg;
    dist12[e] = sqrtf(fmaxf(2.0f - 2.0f * best, 0.0f));
  } else {
    nn21[e] = arg;
  }
}

}  // namespace

// Bytes of scratch `mutual_nn_f32` needs for B pairs of K keypoints.
extern "C" long long mutual_nn_f32_scratch_bytes(int B, int K) {
  const long long nt = (K + T - 1) / T;
  return 4LL * static_cast<long long>(B) * nt * K * 4;
}

// desc1, desc2 [B, K, D] float32; valid1, valid2 [B, K] bytes (0 or 1);
// nn12, nn21 [B, K] int32; dist12 [B, K] float32; scratch of
// mutual_nn_f32_scratch_bytes(B, K) bytes, 16-byte aligned. Contiguous, on
// the device; `vec` (D % 4 == 0 and 16-byte aligned descriptors) takes the
// 16-byte copies. Launches both kernels on `stream` and returns
// cudaGetLastError() after each launch.
extern "C" int mutual_nn_f32(const float* desc1, const float* desc2, const unsigned char* valid1,
                             const unsigned char* valid2, int* nn12, int* nn21, float* dist12,
                             void* scratch, int B, int K, int D, int vec, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int nt = (K + T - 1) / T;
  const size_t part = static_cast<size_t>(B) * nt * K;
  float* p12v = static_cast<float*>(scratch);
  int* p12i = reinterpret_cast<int*>(p12v + part);
  float* p21v = reinterpret_cast<float*>(p12i + part);
  int* p21i = reinterpret_cast<int*>(p21v + part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nt, nt, B);
  if (vec)
    mutual_nn_tile_kernel<true><<<grid, THREADS, 0, s>>>(desc1, desc2, valid1, valid2, p12v, p12i,
                                                         p21v, p21i, K, D);
  else
    mutual_nn_tile_kernel<false><<<grid, THREADS, 0, s>>>(desc1, desc2, valid1, valid2, p12v, p12i,
                                                          p21v, p21i, K, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 2LL * B * K;
  mutual_nn_fold_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      p12v, p12i, p21v, p21i, nn12, nn21, dist12, B, K, nt);
  return static_cast<int>(cudaGetLastError());
}
