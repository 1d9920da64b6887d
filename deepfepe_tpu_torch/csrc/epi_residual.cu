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
// Layout: points [P, N, 3] (x1 and x2 separately), F [P, M, 9] row-major,
// the residual [P, M, N]; the wrapper maps each caller's broadcast onto it.
//
// What bounds it. About 45 flops per (p, m, n) against 4 bytes written per
// residual: at the sample loss's [8, 500, 100] that is 18 MFLOP (0.27 us at
// the card's 67 TFLOP/s FP32 rate) against 1.6 MB (0.48 us at 3.35 TB/s),
// so it is bound by bytes on paper; at DeepFNet's [8, 1, 1000] it is a
// single wave of 64 blocks and bound by launch latency.
//
// Design.
// - Forward: a thread keeps one point (x1, x2) in registers and loops over a
//   tile of MT matrices held in shared memory; the block's threads cover
//   consecutive n, so every store of a residual row is coalesced along N.
// - dF is, per (p, m), a sum over the N points: one warp owns one (p, m),
//   its lanes stride over the points (staged per chunk in shared memory by
//   the whole block) and add the nine products in registers, then a fixed
//   butterfly of warp shuffles adds the lanes. The order of every sum is
//   fixed, so the result does not change from run to run; no atomics.
// - dpts1 and dpts2 are sums over M: one thread per point, looping over the
//   matrices in shared-memory tiles in order. Launched only when asked for.

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;    // threads (points) per forward / point-gradient block
constexpr int MT = 64;      // matrices per shared-memory tile
constexpr int WPB = 8;      // warps (matrices) per dF block
constexpr int NCH = 256;    // points staged per dF chunk

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

__global__ void __launch_bounds__(TPB)
epi_fwd_kernel(const float* __restrict__ pts1, const float* __restrict__ pts2,
               const float* __restrict__ F, float* __restrict__ out, int M, int N,
               float clamp_at, float eps) {
  __shared__ float sf[MT * 9];
  const long long p = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int mc = min(MT, M - m0);
  const float* fp = F + (p * M + m0) * 9;
  for (int i = threadIdx.x; i < mc * 9; i += TPB) sf[i] = fp[i];
  __syncthreads();
  const int n = blockIdx.x * TPB + threadIdx.x;
  if (n >= N) return;
  const float* a = pts1 + (p * N + n) * 3;
  const float* b = pts2 + (p * N + n) * 3;
  const float x1 = a[0], y1 = a[1], z1 = a[2], x2 = b[0], y2 = b[1], z2 = b[2];
  float* o = out + (p * M + m0) * N + n;
  for (int m = 0; m < mc; ++m) {
    const float d = residual(sf + m * 9, x1, y1, z1, x2, y2, z2, eps).d;
    o[static_cast<long long>(m) * N] = d > clamp_at ? clamp_at : d;  // NaN stays NaN
  }
}

__global__ void __launch_bounds__(WPB * 32)
epi_dF_kernel(const float* __restrict__ pts1, const float* __restrict__ pts2,
              const float* __restrict__ F, const float* __restrict__ g,
              float* __restrict__ dF, int M, int N, float clamp_at, float eps) {
  __shared__ float sp[2 * NCH * 3];
  const long long p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WPB + (threadIdx.x >> 5);
  const bool live = m < M;
  float f[9];
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = live ? F[(p * M + m) * 9 + k] : 0.f;
    acc[k] = 0.f;
  }
  const float* gr = g + (p * M + (live ? m : 0)) * N;
  for (int c0 = 0; c0 < N; c0 += NCH) {
    const int cn = min(NCH, N - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 3; i += WPB * 32) {
      sp[i] = pts1[(p * N + c0) * 3 + i];
      sp[NCH * 3 + i] = pts2[(p * N + c0) * 3 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < cn; j += 32) {
      const float* a = sp + j * 3;
      const float* b = sp + NCH * 3 + j * 3;
      const float x1 = a[0], y1 = a[1], z1 = a[2], x2 = b[0], y2 = b[1], z2 = b[2];
      const Terms t = residual(f, x1, y1, z1, x2, y2, z2, eps);
      const Grads c = cotangents(t, gr[c0 + j], x2, y2, z2, clamp_at);
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
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) dF[(p * M + m) * 9 + k] = acc[k];
  }
}

__global__ void __launch_bounds__(TPB)
epi_dpts_kernel(const float* __restrict__ pts1, const float* __restrict__ pts2,
                const float* __restrict__ F, const float* __restrict__ g,
                float* __restrict__ dpts1, float* __restrict__ dpts2, int M, int N,
                float clamp_at, float eps) {
  __shared__ float sf[MT * 9];
  const long long p = blockIdx.y;
  const int n = blockIdx.x * TPB + threadIdx.x;
  const bool live = n < N;
  float x1 = 0.f, y1 = 0.f, z1 = 0.f, x2 = 0.f, y2 = 0.f, z2 = 0.f;
  if (live) {
    const float* a = pts1 + (p * N + n) * 3;
    const float* b = pts2 + (p * N + n) * 3;
    x1 = a[0]; y1 = a[1]; z1 = a[2]; x2 = b[0]; y2 = b[1]; z2 = b[2];
  }
  float d1[3] = {0.f, 0.f, 0.f};
  float d2[3] = {0.f, 0.f, 0.f};
  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mc = min(MT, M - m0);
    __syncthreads();
    for (int i = threadIdx.x; i < mc * 9; i += TPB) sf[i] = F[(p * M + m0) * 9 + i];
    __syncthreads();
    if (!live) continue;
    for (int m = 0; m < mc; ++m) {
      const float* f = sf + m * 9;
      const Terms t = residual(f, x1, y1, z1, x2, y2, z2, eps);
      const Grads c = cotangents(t, g[(p * M + m0 + m) * N + n], x2, y2, z2, clamp_at);
      // dx1 = F' gl1; dx2 = gs * l1 + F gl2.
      d1[0] += f[0] * c.gl1x + f[3] * c.gl1y + f[6] * c.gl1z;
      d1[1] += f[1] * c.gl1x + f[4] * c.gl1y + f[7] * c.gl1z;
      d1[2] += f[2] * c.gl1x + f[5] * c.gl1y + f[8] * c.gl1z;
      d2[0] += c.gs * t.l1x + f[0] * c.gl2x + f[1] * c.gl2y;
      d2[1] += c.gs * t.l1y + f[3] * c.gl2x + f[4] * c.gl2y;
      d2[2] += c.gs * t.l1z + f[6] * c.gl2x + f[7] * c.gl2y;
    }
  }
  if (!live) return;
  for (int k = 0; k < 3; ++k) {
    if (dpts1) dpts1[(p * N + n) * 3 + k] = d1[k];
    if (dpts2) dpts2[(p * N + n) * 3 + k] = d2[k];
  }
}

}  // namespace

// pts1, pts2: [P, N, 3]; F: [P, M, 9]; out: [P, M, N]. All float32,
// contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int epi_residual_f32(const float* pts1, const float* pts2, const float* F, float* out,
                                int P, int M, int N, float clamp_at, float eps, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0) return 0;
  const dim3 grid((N + TPB - 1) / TPB, P, (M + MT - 1) / MT);
  epi_fwd_kernel<<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(pts1, pts2, F, out, M, N,
                                                                      clamp_at, eps);
  return static_cast<int>(cudaGetLastError());
}

// The backward for the residual's cotangent g [P, M, N]: dF [P, M, 9] when
// dF is not null, dpts1 and dpts2 [P, N, 3] where they are not null (one
// launch for both). Returns the first nonzero cudaGetLastError().
extern "C" int epi_residual_bwd_f32(const float* pts1, const float* pts2, const float* F,
                                    const float* g, float* dF, float* dpts1, float* dpts2,
                                    int P, int M, int N, float clamp_at, float eps,
                                    void* stream) {
  if (P <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dF) {
    const dim3 grid((M + WPB - 1) / WPB, P);
    epi_dF_kernel<<<grid, WPB * 32, 0, s>>>(pts1, pts2, F, g, dF, M, N, clamp_at, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (dpts1 || dpts2) {
    const dim3 grid((N + TPB - 1) / TPB, P);
    epi_dpts_kernel<<<grid, TPB, 0, s>>>(pts1, pts2, F, g, dpts1, dpts2, M, N, clamp_at, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
