// Batched eigendecomposition of symmetric 9x9 matrices by cyclic Jacobi.
//
// Replaces the TPU kernel `_eigh9_kernel` in
// deepfepe_tpu/ops/pallas/eigh9_pallas.py (wrapper `eigh9_pallas`). It
// computes the same thing: `sweeps` fixed cyclic sweeps of the 36 (p, q)
// rotations over each matrix, leaving the eigenvalues on the diagonal and
// the accumulated rotations as the eigenvectors, unsorted. The wrapper in
// ops/eigh9.py symmetrizes the input, then sorts ascending and fixes the
// eigenvector signs in torch, as `eigh9_pallas` does in JAX. Its plain
// version is ops/jacobi.py `jacobi_eigh`.
//
// What bounds it. Per matrix: 7 sweeps x 36 rotations x ~180 flops (about
// 18 for the rotation angle, 3 x 9 x 6 for the row, column and eigenvector
// updates), about 45 kFLOP; 324 B read and 360 B written, 684 B. At
// B = 4096 that is 0.19 GFLOP against 2.8 MB: 2.8 us at the card's 67
// TFLOP/s FP32 rate against 0.84 us at 3.35 TB/s, so on paper it is bound
// by operations. At B = 8 the card is nearly empty and the time is the
// latency of one thread's chain of 252 dependent rotations.
//
// Design. One thread owns one matrix, so there is no per-matrix
// communication and no control flow that depends on another matrix. G and V
// (162 floats per matrix) live in shared memory, entry-major with a stride
// of TPB + 1 words: s[e * (TPB + 1) + tid]. Consecutive threads touch
// consecutive banks in the rotation loops (as the TPU kernel's
// entry-by-lane layout keeps the batch on lanes), and the odd stride also
// keeps the coalesced loads and stores, which walk e with the thread, free
// of bank conflicts. 2 x 81 x 65 x 4 B = 42,120 B, under the 48 KB static
// limit. The sweep and (p, q) loops stay rolled (#pragma unroll 1) and only
// the 9-long k loops are unrolled: a fully unrolled schedule of 252
// rotations over register arrays takes long to compile and spills.
// The numerics are the TPU kernel's: small = |apq| <= 1e-12 sqrt(|app aqq|
// + 1e-12); t = sign(tau) / (|tau| + sqrt(1 + tau^2)), t = 1 at tau == 0;
// c = 1 / sqrt(1 + t^2), with IEEE sqrtf and division as the plain version
// computes it. The approximate rsqrtf (2 ulp) left V about 3e-6 from
// orthogonal, and the safe_eigh backward amplified that: a float32 train
// step's gradients landed 1.6% (Frobenius) from float64, against 0.40%
// with the exact form and 0.33% for the plain version on the CPU
// (NVIDIA H100 80GB HBM3, 700 W; ROADMAP.md Queue 3).

#include <cuda_runtime.h>

namespace {

constexpr int N = 9;
constexpr int N2 = N * N;
constexpr int TPB = 64;          // matrices (threads) per block
constexpr int LD = TPB + 1;      // shared-memory stride of one entry
constexpr float EPS = 1e-12f;

__global__ void __launch_bounds__(TPB)
eigh9_kernel(const float* __restrict__ A, float* __restrict__ w,
             float* __restrict__ V, int B, int sweeps) {
  __shared__ float sg[N2 * LD];
  __shared__ float sv[N2 * LD];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * TPB;
  const int count = min(TPB, static_cast<int>(B - first));

  // Coalesced load of the block's matrices (contiguous [count, 81] floats);
  // the ragged tail of the last block is zero-filled and never written out.
  const float* a = A + first * N2;
  for (int i = tid; i < TPB * N2; i += TPB) {
    const int m = i / N2;
    const int e = i - m * N2;
    sg[e * LD + m] = (m < count) ? a[i] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < N2; ++e) {
    sv[e * LD + tid] = (e / N == e % N) ? 1.0f : 0.0f;
  }
  __syncthreads();

  float* g = sg + tid;
  float* v = sv + tid;
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < N; ++q) {
        const float app = g[(p * N + p) * LD];
        const float aqq = g[(q * N + q) * LD];
        const float apq = g[(p * N + q) * LD];
        const bool small = fabsf(apq) <= EPS * sqrtf(fabsf(app * aqq) + EPS);
        const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
        float t = copysignf(1.0f, tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        if (tau == 0.0f) t = 1.0f;
        float c = 1.0f / sqrtf(1.0f + t * t);
        float s = t * c;
        if (small) {
          c = 1.0f;
          s = 0.0f;
        }
        // Rows p and q of G.
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float gp = g[(p * N + k) * LD];
          const float gq = g[(q * N + k) * LD];
          g[(p * N + k) * LD] = c * gp - s * gq;
          g[(q * N + k) * LD] = s * gp + c * gq;
        }
        // Columns p and q of G (keeps it symmetric).
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float gp = g[(k * N + p) * LD];
          const float gq = g[(k * N + q) * LD];
          g[(k * N + p) * LD] = c * gp - s * gq;
          g[(k * N + q) * LD] = s * gp + c * gq;
        }
        // V <- V @ J: columns p and q.
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float vp = v[(k * N + p) * LD];
          const float vq = v[(k * N + q) * LD];
          v[(k * N + p) * LD] = c * vp - s * vq;
          v[(k * N + q) * LD] = s * vp + c * vq;
        }
      }
    }
  }
  __syncthreads();

  float* vo = V + first * N2;
  for (int i = tid; i < TPB * N2; i += TPB) {
    const int m = i / N2;
    const int e = i - m * N2;
    if (m < count) vo[i] = sv[e * LD + m];
  }
  float* wo = w + first * N;
  for (int i = tid; i < TPB * N; i += TPB) {
    const int m = i / N;
    const int d = i - m * N;
    if (m < count) wo[i] = sg[(d * N + d) * LD + m];
  }
}

}  // namespace

// A: [B, 81] symmetric, row-major; w: [B, 9]; V: [B, 81] (V[b, k*9 + j] is
// component k of eigenvector j). All float32, contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int eigh9_f32(const float* A, float* w, float* V, int B, int sweeps,
                         void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + TPB - 1) / TPB;
  eigh9_kernel<<<blocks, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      A, w, V, B, sweeps);
  return static_cast<int>(cudaGetLastError());
}
