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
// by operations.
//
// Design. One launch covers both directions: blockIdx.z = 0 takes rows of
// desc1 against columns of desc2 (nn12, dist12), blockIdx.z = 1 the
// transposed product (nn21), whose row argmax is the column argmax of the
// first. Every dot product is summed over d in the same ascending order of
// FMAs in both directions, so the two directions see bitwise the same
// similarity. A block owns 64 rows and sweeps the K columns in tiles of 64;
// per tile it walks D in chunks of 32, staging the row and column chunks in
// shared memory, and each of 256 threads accumulates 4 rows x 4 columns in
// registers (columns tx, tx + 16, tx + 32, tx + 48 of the tile). After each
// tile a thread folds its 4 columns into a running (best, index) per row;
// at the end the 16 threads that share a row combine theirs by warp
// shuffles, larger value first and lower index on equal values. The product
// runs twice (once per direction) to keep the block free of any exchange
// with another block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RT = 64;        // rows per block
constexpr int CTL = 64;       // columns per tile
constexpr int DK = 32;        // descriptor entries per shared-memory chunk
constexpr int LDS = DK + 4;   // padded row stride, keeps float4 alignment
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mutual_nn_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                 const unsigned char* __restrict__ v1, const unsigned char* __restrict__ v2,
                 int* __restrict__ nn12, int* __restrict__ nn21, float* __restrict__ dist12,
                 int K, int D) {
  __shared__ __align__(16) float as[RT * LDS];
  __shared__ __align__(16) float bs[CTL * LDS];
  const int dir = blockIdx.z;
  const int b = blockIdx.y;
  const size_t off = static_cast<size_t>(b) * K * D;
  const float* A = (dir == 0 ? d1 : d2) + off;
  const float* Bm = (dir == 0 ? d2 : d1) + off;
  const unsigned char* vcol = (dir == 0 ? v2 : v1) + static_cast<size_t>(b) * K;
  const int r0 = blockIdx.x * RT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx + 16 k of each tile
  const int ty = tid / 16;   // rows 4 ty .. 4 ty + 3 of the block

  float best[4];
  int arg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    best[q] = -INFINITY;
    arg[q] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < K; c0 += CTL) {
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][k] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += DK) {
      for (int i = tid; i < RT * DK; i += THREADS) {
        const int r = i / DK, d = i % DK;
        as[r * LDS + d] = (r0 + r < K && k0 + d < D)
                              ? A[static_cast<size_t>(r0 + r) * D + k0 + d] : 0.0f;
      }
      for (int i = tid; i < CTL * DK; i += THREADS) {
        const int c = i / DK, d = i % DK;
        bs[c * LDS + d] = (c0 + c < K && k0 + d < D)
                              ? Bm[static_cast<size_t>(c0 + c) * D + k0 + d] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < DK; d += 4) {
        float4 a[4], c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = *reinterpret_cast<const float4*>(as + (4 * ty + q) * LDS + d);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[k] = *reinterpret_cast<const float4*>(bs + (tx + 16 * k) * LDS + d);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[q][k] = fmaf(a[q].x, c[k].x, acc[q][k]);
            acc[q][k] = fmaf(a[q].y, c[k].y, acc[q][k]);
            acc[q][k] = fmaf(a[q].z, c[k].z, acc[q][k]);
            acc[q][k] = fmaf(a[q].w, c[k].w, acc[q][k]);
          }
      }
      __syncthreads();
    }
    // Columns ascend within a thread, so a strict > keeps the lowest index.
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + tx + 16 * k;
      if (c < K) {
        const float m = vcol[c] ? 0.0f : -1e9f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = acc[q][k] + m;
          if (v > best[q]) {
            best[q] = v;
            arg[q] = c;
          }
        }
      }
    }
  }

  // The 16 lanes with the same ty hold the same rows.
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[q], o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg[q], o);
      if (ov > best[q] || (ov == best[q] && oi < arg[q])) {
        best[q] = ov;
        arg[q] = oi;
      }
    }
  }
  if (tx != 0) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 4 * ty + q;
    if (r >= K) break;
    const size_t at = static_cast<size_t>(b) * K + r;
    if (dir == 0) {
      nn12[at] = arg[q];
      dist12[at] = sqrtf(fmaxf(2.0f - 2.0f * best[q], 0.0f));
    } else {
      nn21[at] = arg[q];
    }
  }
}

}  // namespace

// desc1, desc2 [B, K, D] float32; valid1, valid2 [B, K] bytes (0 or 1);
// nn12, nn21 [B, K] int32; dist12 [B, K] float32. Contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int mutual_nn_f32(const float* desc1, const float* desc2, const unsigned char* valid1,
                             const unsigned char* valid2, int* nn12, int* nn21, float* dist12,
                             int B, int K, int D, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const dim3 grid((K + RT - 1) / RT, B, 2);
  mutual_nn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      desc1, desc2, valid1, valid2, nn12, nn21, dist12, K, D);
  return static_cast<int>(cudaGetLastError());
}
